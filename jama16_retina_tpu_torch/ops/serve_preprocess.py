"""Fused serve preprocess (counterpart of
``jama16_retina_tpu/ops/pallas_serve.py``).

One pass over a uint8 NHWC batch gives the normalized float32 rows
``u8 * float32(1/127.5) - 1`` and each image's raw sums
``[sum_r, sum_g, sum_b, sum of squares]`` as exact int64. The float64
host epilogue ``stats_from_sums`` turns the sums into the quality
monitor's input statistics.

``fused_serve_preprocess`` launches the CUDA kernel
(``csrc/serve_preprocess.cu``) on a CUDA tensor and its plain version
``serve_preprocess_reference`` on a CPU tensor. On the card it launches
or raises; it never falls back to the plain version.

Rows: the kernel and the plain version compute the same two rounded
float32 operations, so they agree bit for bit; the JAX kernel computes
the same expression. Sums: exact integers here, where the JAX kernel
sums in float32 (inexact past 2^24), so its statistics agree with
these only to float32 rounding.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

# float32(1/127.5), the constant JAX folds ``1.0 / 127.5`` to.
SCALE = float(np.float32(1.0 / 127.5))

# Rec.601 luma weights, as in obs/quality.input_stat_values.
_LUMA = (0.299, 0.587, 0.114)

# Times the CUDA kernel was launched in this process, counted under a
# lock: the router's worker threads launch it concurrently.
launches = 0
_launches_lock = threading.Lock()


def _check(images_u8: torch.Tensor) -> None:
    if not isinstance(images_u8, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(images_u8)}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {images_u8.dtype}")
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"expected images [B, H, W, 3], got {tuple(images_u8.shape)}")
    if images_u8.shape[0] < 1 or images_u8.shape[1] * images_u8.shape[2] < 1:
        raise ValueError(f"empty batch {tuple(images_u8.shape)}")


def serve_preprocess_reference(
    images_u8: torch.Tensor,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain PyTorch version: (norm float32 [B, H, W, 3], sums int64
    [B, 4]). Multiply and subtract are two separate operations, each
    rounded once, as in the kernel."""
    _check(images_u8)
    norm = torch.mul(images_u8.float(), SCALE).sub_(1.0)
    wide = images_u8.reshape(images_u8.shape[0], -1, 3).long()
    sums = torch.cat([wide.sum(dim=1), (wide * wide).sum(dim=(1, 2))[:, None]],
                     dim=1)
    return norm, sums


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound on first use."""
    from jama16_retina_tpu_torch.ops import build

    lib = build.load("serve_preprocess")
    fn = lib.serve_preprocess_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_serve_preprocess(
    images_u8: torch.Tensor, device: "str | torch.device | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """(norm float32 [B, H, W, 3] NHWC, sums int64 [B, 4]) on the
    tensor's device. A CUDA tensor goes through the kernel; a CPU
    tensor through the plain version. ``device``, when given, must be
    where the tensor lies: asking for the card with a CPU tensor
    raises instead of quietly computing on the CPU."""
    global launches
    _check(images_u8)
    if device is not None and torch.device(device).type != images_u8.device.type:
        raise ValueError(
            f"images lie on {images_u8.device} but device={device!r} was "
            "requested; move the tensor first")
    if images_u8.device.type == "cpu":
        return serve_preprocess_reference(images_u8)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    if not images_u8.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    b, h, w, _ = images_u8.shape
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    sums = torch.zeros((b, 4), dtype=torch.int64, device=images_u8.device)
    launch = _launcher()
    stream = torch.cuda.current_stream(images_u8.device).cuda_stream
    err = launch(images_u8.data_ptr(), out.data_ptr(), sums.data_ptr(), b,
                 h * w, SCALE, stream)
    if err:
        raise RuntimeError(
            f"serve_preprocess kernel launch failed: cudaError {err} for "
            f"images {tuple(images_u8.shape)}")
    with _launches_lock:
        launches += 1
    return out, sums


def stats_from_sums(sums, n_pixels: int) -> np.ndarray:
    """Raw sums [B, 4] (uint8 units) -> float64 [B, 4] (mean_r, mean_g,
    mean_b, std) over x = u8/255 (copy of ``pallas_serve.py:70``).

    Float64 on the host on purpose: ``E[x^2] - E[x]^2`` cancels
    catastrophically in float32 for low-variance images."""
    if isinstance(sums, torch.Tensor):
        sums = sums.cpu().numpy()
    s = np.asarray(sums, np.float64)
    n = float(n_pixels)
    mean_c = s[:, :3] / (255.0 * n)
    ex = (s[:, 0] + s[:, 1] + s[:, 2]) / (255.0 * 3.0 * n)
    ex2 = s[:, 3] / (255.0 * 255.0 * 3.0 * n)
    std = np.sqrt(np.maximum(ex2 - ex * ex, 0.0))
    return np.concatenate([mean_c, std[:, None]], axis=1)


def input_stats_dict(stats: np.ndarray) -> dict:
    """Stats columns [n, 4] -> {stat: float64 [n]} in the quality
    monitor's vocabulary, brightness derived from the channel means
    (copy of ``pallas_serve.py:200``)."""
    s = np.asarray(stats, np.float64)
    bright = s[:, 0] * _LUMA[0] + s[:, 1] * _LUMA[1] + s[:, 2] * _LUMA[2]
    return {
        "mean_r": s[:, 0],
        "mean_g": s[:, 1],
        "mean_b": s[:, 2],
        "std": s[:, 3],
        "brightness": bright,
    }
