"""Serving host stage (counterpart of ``jama16_retina_tpu/serve/host.py``).

``preprocess_paths`` normalizes photograph files on a thread pool
(``cv2`` decode and resize release the GIL). Results are assembled in
input order (``ThreadPoolExecutor.map`` preserves it), so the output
depends only on the path list, never on the worker count.

``prepare_images`` is the device-side preprocess of a uint8 batch: the
fused kernel (``fused=True``) or the unfused PyTorch composition.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.preprocess import fundus


@dataclasses.dataclass
class PreprocessResult:
    """Kept rows in input order + the skip ledger predict reports."""

    images: np.ndarray  # uint8 [n_kept, S, S, 3], input order
    kept: list  # paths of the scored rows, aligned with images
    skipped: list  # (path, reason) pairs, input order
    qualities: list  # gradability score per kept row


def resolve_workers(requested: int) -> int:
    """0 = one thread per host core up to 8, leaving one core free."""
    if requested > 0:
        return requested
    return max(1, min(8, (os.cpu_count() or 1) - 1))


def _load_one(path: str, image_size: int, ben_graham: bool):
    """One path -> (error reason | None, canvas | None, quality | None).
    Unreadable files and frames without a fundus become reasons; any
    other exception propagates."""
    import cv2

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return f"unreadable: {e}", None, None
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        return "unreadable", None, None
    try:
        canvas, q = fundus.resize_and_center_fundus(
            bgr[..., ::-1], diameter=image_size, ben_graham=ben_graham,
            with_quality=True,
        )
    except fundus.FundusNotFound as e:
        return f"no fundus found: {e}", None, None
    return None, canvas, float(q["quality"])


def preprocess_paths(paths: "list[str]", image_size: int,
                     ben_graham: bool = False,
                     workers: int = 0) -> PreprocessResult:
    """Normalize ``paths`` across a thread pool; worker-count-invariant."""
    workers = resolve_workers(workers)

    def one(p):
        return _load_one(p, image_size, ben_graham)

    if workers <= 1 or len(paths) < 2:
        rows = [one(p) for p in paths]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(workers, len(paths)),
                                thread_name_prefix="serve-host") as pool:
            rows = list(pool.map(one, paths))

    kept, skipped, qualities, canvases = [], [], [], []
    for p, (why, canvas, quality) in zip(paths, rows):
        if why is not None:
            skipped.append((p, why))
            continue
        kept.append(p)
        canvases.append(canvas)
        qualities.append(quality)
    images = (np.stack(canvases) if canvases
              else np.zeros((0, image_size, image_size, 3), np.uint8))
    return PreprocessResult(images=images, kept=kept, skipped=skipped,
                            qualities=qualities)


def prepare_images(images_u8, *, fused: bool = False,
                   device: "str | torch.device | None" = None,
                   ) -> "tuple[torch.Tensor, dict]":
    """uint8 [B, H, W, 3] (numpy or tensor) -> (normalized float32
    [B, H, W, 3] on ``device``, INPUT_STATS dict of float64 [B]).

    ``fused=True`` runs ``fused_serve_preprocess`` (the CUDA kernel on
    the card); ``fused=False`` runs the unfused PyTorch composition,
    ``serve_preprocess_reference``. Both give the same rows and sums."""
    dev = device_lib.resolve(device)
    x = torch.as_tensor(np.ascontiguousarray(images_u8)).to(dev)
    fn = (serve_preprocess.fused_serve_preprocess if fused
          else serve_preprocess.serve_preprocess_reference)
    norm, sums = fn(x)
    stats = serve_preprocess.stats_from_sums(sums, x.shape[1] * x.shape[2])
    return norm, serve_preprocess.input_stats_dict(stats)


def stats_only(images_u8, *, fused: bool = False,
               device: "str | torch.device | None" = None) -> dict:
    """The INPUT_STATS dict alone: the quality monitor's ``stats_fn``."""
    return prepare_images(images_u8, fused=fused, device=device)[1]
