"""Serving host stage (counterpart of ``jama16_retina_tpu/serve/host.py``).

``preprocess_paths`` decodes and normalizes photograph files on a thread
pool, with no OpenCV: ``data/imdecode.py`` decodes JPEG (EXIF orientation
applied) and PNG, the JPEG entropy decode and the PNG unfilter in C
called through ``ctypes`` (which releases the GIL), and
``preprocess/fundus.py`` normalizes. Results are assembled in input order
(``ThreadPoolExecutor.map`` preserves it), so the output depends only on
the path list, never on the worker count. Rejected paths are counted
into ``serve.input_rejected`` and ``serve.input_rejected.{reason}`` as the
reference counts them. Each file read passes the ``host.decode`` fault
seam (``obs/faultinject.py``) and, with ``max_retries`` > 0, the bounded
retry (``utils/retry.py``); a path read again and then scored lands in
the ``retried`` ledger and ``serve.input_retried``, never in ``skipped``.

``prepare_images`` is the device-side preprocess of a uint8 batch: the
fused kernel (``fused=True``, counted into ``serve.preprocess.fused_rows``)
or the unfused PyTorch composition. ``observe_with_stats`` feeds the
quality monitor a request whose B4 statistics came with its forward, and
counts the rows that the reference's monitor would have passed through
``prepare_images``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.data import imdecode
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.preprocess import fundus
from jama16_retina_tpu_torch.utils import retry as retry_lib


def reject_reason_slug(why: str) -> str:
    """Skip-reason text -> the bounded counter vocabulary: free-text
    reasons map onto a small fixed slug space (unmatched: ``other``)."""
    if why.startswith("unreadable"):
        return "decode_error"
    if "too small" in why:
        return "too_small"
    if "no fundus found" in why:
        return "not_fundus"
    return "other"


def _count_rejects(skipped, registry: "obs_registry.Registry | None"
                   ) -> None:
    """``serve.input_rejected`` and ``serve.input_rejected.{reason}``
    counters, with the reference's help strings."""
    if not skipped:
        return
    reg = registry if registry is not None else obs_registry.default_registry()
    total = reg.counter(
        "serve.input_rejected",
        help="input images rejected before the forward pass, all reasons",
    )
    helps = {
        "decode_error": "rejected: file unreadable / not a decodable image",
        "too_small": "rejected: detected fundus radius below the minimum",
        "not_fundus": "rejected: no fundus disc found in the frame",
        "other": "rejected: uncategorized preprocessing failure",
    }
    for _, why in skipped:
        slug = reject_reason_slug(why)
        total.inc()
        reg.counter(f"serve.input_rejected.{slug}",
                    help=helps.get(slug, "")).inc()


@dataclasses.dataclass
class PreprocessResult:
    """Kept rows in input order + the skip ledger predict reports."""

    images: np.ndarray  # uint8 [n_kept, S, S, 3], input order
    kept: list  # paths of the scored rows, aligned with images
    skipped: list  # (path, reason) pairs, input order
    qualities: list  # gradability score per kept row
    # Paths read again after a transient error (--max_retries) and then
    # scored: a ledger apart from ``skipped``, so --strict stays exact.
    retried: list = dataclasses.field(default_factory=list)


def resolve_workers(requested: int) -> int:
    """0 = one thread per host core up to 8, leaving one core free."""
    if requested > 0:
        return requested
    return max(1, min(8, (os.cpu_count() or 1) - 1))


def _load_one(path: str, image_size: int, ben_graham: bool,
              max_retries: int = 0):
    """One path -> (error reason | None, canvas | None, quality | None,
    retried). Unreadable files and frames without a fundus become reasons
    ("unreadable" verbatim for bytes that are no image; a format the port
    recognizes but does not decode yet names itself); any other exception
    propagates. The read passes the ``host.decode`` seam and, with
    ``max_retries`` > 0, up to that many retries of an ``OSError``."""
    tries = [0]

    def read() -> bytes:
        tries[0] += 1
        with open(path, "rb") as f:
            data = f.read()
        return faultinject.corrupt("host.decode", data)

    try:
        if max_retries > 0:
            data = retry_lib.retry_call(read, attempts=max_retries + 1,
                                        base_delay=0.02, site="host.decode")
        else:
            data = read()
    except OSError as e:
        return f"unreadable: {e}", None, None, tries[0] > 1
    retried = tries[0] > 1
    rgb, why = imdecode.read_image(data)
    if rgb is None:
        return ("unreadable" if why is None else f"unreadable: {why}",
                None, None, retried)
    try:
        canvas, q = fundus.resize_and_center_fundus(
            rgb, diameter=image_size, ben_graham=ben_graham,
            with_quality=True,
        )
    except fundus.FundusNotFound as e:
        return f"no fundus found: {e}", None, None, retried
    return None, canvas, float(q["quality"]), retried


def preprocess_paths(paths: "list[str]", image_size: int,
                     ben_graham: bool = False, workers: int = 0,
                     registry: "obs_registry.Registry | None" = None,
                     max_retries: int = 0) -> PreprocessResult:
    """Normalize ``paths`` across a thread pool; worker-count-invariant.
    ``registry`` receives the reject and retry counters (None: the
    process default). ``max_retries``: per-image retries of a transient
    read error (``predict --max_retries``); a path retried and then
    scored lands in ``retried`` and ``serve.input_retried``."""
    workers = resolve_workers(workers)

    def one(p):
        return _load_one(p, image_size, ben_graham, max_retries)

    if workers <= 1 or len(paths) < 2:
        rows = [one(p) for p in paths]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(workers, len(paths)),
                                thread_name_prefix="serve-host") as pool:
            rows = list(pool.map(one, paths))

    kept, skipped, qualities, canvases, retried = [], [], [], [], []
    for p, (why, canvas, quality, was_retried) in zip(paths, rows):
        if why is not None:
            skipped.append((p, why))
            continue
        if was_retried:
            retried.append(p)
        kept.append(p)
        canvases.append(canvas)
        qualities.append(quality)
    images = (np.stack(canvases) if canvases
              else np.zeros((0, image_size, image_size, 3), np.uint8))
    _count_rejects(skipped, registry)
    if retried:
        reg = (registry if registry is not None
               else obs_registry.default_registry())
        reg.counter(
            "serve.input_retried",
            help="images that hit a transient read error, were retried "
                 "and then SCORED (not part of the reject ledger)",
        ).inc(len(retried))
    return PreprocessResult(images=images, kept=kept, skipped=skipped,
                            qualities=qualities, retried=retried)


def _fused_rows(registry: "obs_registry.Registry | None"):
    reg = registry if registry is not None else obs_registry.default_registry()
    return reg.counter(
        "serve.preprocess.fused_rows",
        help="rows normalized by the fused Pallas serve preprocess "
             "(normalize + channel stats + layout in one pass; "
             "serve.fused_preprocess)",
    )


def prepare_images(images_u8, *, fused: bool = False,
                   device: "str | torch.device | None" = None,
                   registry: "obs_registry.Registry | None" = None,
                   ) -> "tuple[torch.Tensor, dict]":
    """uint8 [B, H, W, 3] (numpy or tensor) -> (normalized float32
    [B, H, W, 3] on ``device``, INPUT_STATS dict of float64 [B]).

    ``fused=True`` runs ``fused_serve_preprocess`` (the CUDA kernel on
    the card); ``fused=False`` runs the unfused PyTorch composition,
    ``serve_preprocess_reference``. Both give the same rows and sums.
    The fused path counts its rows into ``serve.preprocess.fused_rows``
    of ``registry`` (None: the process default)."""
    dev = device_lib.resolve(device)
    x = torch.as_tensor(np.ascontiguousarray(images_u8)).to(dev)
    fn = (serve_preprocess.fused_serve_preprocess if fused
          else serve_preprocess.serve_preprocess_reference)
    norm, sums = fn(x)
    if fused:
        _fused_rows(registry).inc(int(x.shape[0]))
    stats = serve_preprocess.stats_from_sums(sums, x.shape[1] * x.shape[2])
    return norm, serve_preprocess.input_stats_dict(stats)


def stats_only(images_u8, *, fused: bool = False,
               device: "str | torch.device | None" = None,
               registry: "obs_registry.Registry | None" = None) -> dict:
    """The INPUT_STATS dict alone: the quality monitor's ``stats_fn``."""
    return prepare_images(images_u8, fused=fused, device=device,
                          registry=registry)[1]


def observe_with_stats(quality, images: np.ndarray, scores: np.ndarray,
                       stats: "dict | None",
                       registry: "obs_registry.Registry | None") -> None:
    """``quality.observe`` of a request's rows and scores, with the
    INPUT_STATS dict ``stats`` that kernel B4 gave with the forward (None
    off the fused path). The reference's monitor computes those
    statistics through ``stats_only``, whose fused pass counts the rows
    into ``serve.preprocess.fused_rows``; they are counted here, in
    ``registry``, exactly when the monitor reads them."""
    if stats is not None and quality.reads_input_stats():
        _fused_rows(registry).inc(int(len(images)))
    quality.observe(images, scores, stats=stats)
