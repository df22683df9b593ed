"""Colour jitter kernels B1 and B2 (counterparts of
``jama16_retina_tpu/ops/pallas_augment.py``).

The colour half of the augment (normalize, brightness, contrast about
the per-image mean, YIQ saturation/hue) is one affine map per image:

    out_c = clip(sum_k A[c, k] * (u8_k * float32(1/127.5) - 1) + o[c], -1, 1)

with ``A = contrast * M`` and ``o = M @ (mean * (1 - contrast) +
brightness)``, ``M = I + YIQ2RGB @ (R - I) @ RGB2YIQ`` (``chroma_matrix``).

- ``fused_color_jitter`` (B1) takes ``A`` and ``o`` from the host helpers
  (``channel_means_u8`` + ``color_affine_from_params``).
- ``fused_normalize_color_jitter`` (B2) takes ``M``, contrast and
  brightness and forms the per-image means and ``o`` itself.

Both read uint8 NHWC and write float32 NHWC. On a CUDA tensor each wrapper
launches its kernel (``csrc/color_jitter.cu``) and counts the launch; on a
CPU tensor it runs its plain version. It never falls back from the card.
B2 takes one of two routes by image size (``_b2_plan``): one launch with
one thread block cluster per image, or, for an image larger than a
cluster's shared memory, a sum kernel then an apply kernel. Either counts
as one launch.

Each plain version computes the kernel's arithmetic in the kernel's order,
one rounding per operation, so the two agree bit for bit on the card. The
JAX kernels compute the same expressions; XLA may contract a multiply and
an add into one FMA on the CPU, so the port agrees with them to float32
rounding (pinned in ``tests/test_torch_augment.py``).

The 3x3 products of the host helpers are written out as elementwise
multiply-and-sum in float32: the reference pins its einsums to
``Precision.HIGHEST``, and a matmul on the card could take TF32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

# float32(1/127.5), the constant the JAX kernels fold ``1.0 / 127.5`` to.
SCALE = float(np.float32(1.0 / 127.5))

# RGB <-> YIQ (NTSC), copied from data/augment.py:36-44: the inverse is
# computed in float64 and both are then cast to float32.
_RGB2YIQ_F64 = np.array([
    [0.299, 0.587, 0.114],
    [0.596, -0.274, -0.322],
    [0.211, -0.523, 0.312],
])
RGB2YIQ = torch.from_numpy(_RGB2YIQ_F64.astype(np.float32))
YIQ2RGB = torch.from_numpy(np.linalg.inv(_RGB2YIQ_F64).astype(np.float32))

# Times each CUDA kernel was launched in this process.
launches = {"fused_color_jitter": 0, "fused_normalize_color_jitter": 0}

# B2's single-pass route: blocks per cluster (one cluster per image). 8 is
# the portable cluster size; PERF.md gives the times of 8 and 16.
B2_CLUSTER = 8
# Shared memory a block may use on the H100 (the opt-in maximum), and the
# header the kernel keeps before a slice's bytes (csrc/color_jitter.cu).
_MAX_SHARED_BYTES = 232_448
_HEADER_BYTES = 256


class B2Plan(NamedTuple):
    """How B2 runs for one image size: ``route`` "single_pass" (one
    cluster of ``cluster`` blocks per image, each taking ``slice_bytes`` of
    it with ``shared_bytes`` of shared memory) or "two_pass" (the other
    fields 0)."""
    route: str
    cluster: int
    slice_bytes: int
    shared_bytes: int


_TWO_PASS = B2Plan("two_pass", 0, 0, 0)


def _b2_plan(h: int, w: int, cluster: int = B2_CLUSTER) -> B2Plan:
    """B2's route for [*, h, w, 3] images: single pass when an image's
    3*h*w bytes fit ``cluster`` blocks' shared memory, else two pass.

    Block ``r`` of an image takes its bytes ``[r*S, (r+1)*S)`` clipped to
    the image, ``S = slice_bytes`` a multiple of 12 (4 pixels), and needs
    the header plus the slice rounded out for alignment (up to 15 bytes
    before it, up to 11 after it to a 12-byte step), rounded up to 16:
    the kernel's ``cluster_shared_bytes``, which checks the two agree."""
    slice_bytes = 12 * -(-3 * h * w // (12 * cluster))
    shared = _HEADER_BYTES + (slice_bytes + 26 + 15) // 16 * 16
    if shared > _MAX_SHARED_BYTES:
        return _TWO_PASS
    return B2Plan("single_pass", cluster, slice_bytes, shared)


def _bmm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as float32 multiply-and-sum (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def chroma_matrix(saturation: torch.Tensor,
                  hue_theta: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] YIQ chroma rotation/scaling in RGB space (copy of
    ``pallas_augment.py:90``), as ``I + YIQ2RGB @ (R - I) @ RGB2YIQ``: with
    the colour flags off, ``R - I`` is exactly zero and the result is
    exactly I."""
    dev = saturation.device
    cos = torch.cos(hue_theta) * saturation
    sin = torch.sin(hue_theta) * saturation
    zeros = torch.zeros_like(saturation)
    ones = torch.ones_like(saturation)
    rot = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, cos, -sin], -1),
        torch.stack([zeros, sin, cos], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    inner = _bmm3(rot - eye, RGB2YIQ.to(dev).expand_as(rot))
    return eye + _bmm3(YIQ2RGB.to(dev).expand_as(rot), inner)


def color_affine_from_params(
    means: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
    saturation: torch.Tensor, hue_theta: torch.Tensor,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """(A [B, 3, 3], o [B, 3]) from the drawn params and the per-image
    channel means (copy of ``pallas_augment.py:126``)."""
    m_chroma = chroma_matrix(saturation, hue_theta)
    affine = contrast[:, None, None] * m_chroma
    o_pre = means * (1.0 - contrast[:, None]) + brightness[:, None]
    offset = (m_chroma * o_pre[:, None, :]).sum(dim=-1)
    return affine, offset


def channel_means_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """Per-image channel means of ``u8 / 127.5 - 1``, [B, 3] (copy of
    ``pallas_augment.py:250``)."""
    return images_u8.float().mean(dim=(1, 2)) / 127.5 - 1.0


def _check(images_u8: torch.Tensor, *params: torch.Tensor) -> None:
    if not isinstance(images_u8, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(images_u8)}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {images_u8.dtype}")
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"expected images [B, H, W, 3], got {tuple(images_u8.shape)}")
    b = images_u8.shape[0]
    if b < 1 or images_u8.shape[1] * images_u8.shape[2] < 1:
        raise ValueError(f"empty batch {tuple(images_u8.shape)}")
    for p in params:
        if p.dtype != torch.float32 or p.shape[0] != b:
            raise ValueError(
                f"expected float32 params with leading dim {b}, got "
                f"{p.dtype} {tuple(p.shape)}")
        if p.device != images_u8.device:
            raise ValueError(
                f"params lie on {p.device}, images on {images_u8.device}")


def _normalized(images_u8: torch.Tensor) -> torch.Tensor:
    return torch.mul(images_u8.float(), SCALE).sub_(1.0)


def _apply_rows(x: torch.Tensor, rows: torch.Tensor, scale,
                offset: torch.Tensor) -> torch.Tensor:
    """``clip(scale * ((m0*r + m1*g) + m2*b) + off, -1, 1)`` per output
    channel, or without ``scale`` when it is None; each operation rounds
    once, in this order (the kernels' order)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    out = []
    for c in range(3):
        m = rows[:, c, None, None, :]
        v = m[..., 0] * r + m[..., 1] * g + m[..., 2] * b
        if scale is not None:
            v = scale[:, None, None] * v
        out.append(torch.clamp(v + offset[:, c, None, None], -1.0, 1.0))
    return torch.stack(out, dim=-1)


def color_jitter_reference(images_u8: torch.Tensor, affine: torch.Tensor,
                           offset: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: float32 [B, H, W, 3]."""
    _check(images_u8, affine, offset)
    return _apply_rows(_normalized(images_u8), affine, None, offset)


def _means_from_sums(sums: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """``float32(sum) * float32(1 / (P * 127.5)) - 1``, as the JAX
    kernel's apply phase forms the mean from its accumulator."""
    inv = float(np.float32(1.0 / (n_pixels * 127.5)))
    return sums.float() * inv - 1.0


def channel_sums_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """Exact per-image channel sums of the raw bytes, int64 [B, 3]."""
    return images_u8.reshape(images_u8.shape[0], -1, 3).long().sum(dim=1)


def normalize_color_jitter_reference(
    images_u8: torch.Tensor, m_chroma: torch.Tensor, contrast: torch.Tensor,
    brightness: torch.Tensor,
) -> torch.Tensor:
    """Plain version of B2: the means from exact integer channel sums,
    then ``o_pre = mean * (1 - c) + b``, ``off = (m0*o_r + m1*o_g) +
    m2*o_b`` and ``clip(c * (M x) + off, -1, 1)``, float32 [B, H, W, 3]."""
    _check(images_u8, m_chroma, contrast, brightness)
    h, w = images_u8.shape[1:3]
    mean = _means_from_sums(channel_sums_u8(images_u8), h * w)
    o_pre = mean * (1.0 - contrast)[:, None] + brightness[:, None]
    offset = (m_chroma[..., 0] * o_pre[:, None, 0]
              + m_chroma[..., 1] * o_pre[:, None, 1]
              + m_chroma[..., 2] * o_pre[:, None, 2])
    return _apply_rows(_normalized(images_u8), m_chroma, contrast, offset)


@functools.cache
def _lib():
    """The kernels' C entry points, built and bound on first use."""
    from jama16_retina_tpu_torch.ops import build

    lib = build.load("color_jitter")
    ptr, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float)
    lib.color_jitter_launch.argtypes = [ptr, ptr, ptr, ptr, i, ll, f, ptr]
    lib.normalize_color_jitter_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i, ll, f, f, i, i, i, ptr]
    lib.normalize_color_jitter_max_clusters.argtypes = [
        i, i, ctypes.POINTER(i)]
    for fn in (lib.color_jitter_launch, lib.normalize_color_jitter_launch,
               lib.normalize_color_jitter_max_clusters):
        fn.restype = i
    return lib


def _on_card(images_u8: torch.Tensor, *params: torch.Tensor) -> bool:
    """True for CUDA tensors (checked for the kernel's layout), False for
    CPU tensors; raises for any other device."""
    dev = images_u8.device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    if not all(t.is_contiguous() for t in (images_u8, *params)):
        raise ValueError("images and params must be contiguous")
    return True


def _raise_on(err: int, name: str, images_u8: torch.Tensor) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"for images {tuple(images_u8.shape)}")


def fused_color_jitter(images_u8: torch.Tensor, affine: torch.Tensor,
                       offset: torch.Tensor) -> torch.Tensor:
    """B1: ``clip(A (u8/127.5 - 1) + o, -1, 1)`` per pixel, uint8 [B, H, W,
    3] -> float32 [B, H, W, 3], with ``affine`` [B, 3, 3] and ``offset``
    [B, 3] float32 on the images' device."""
    _check(images_u8, affine, offset)
    if not _on_card(images_u8, affine, offset):
        return color_jitter_reference(images_u8, affine, offset)
    b, h, w, _ = images_u8.shape
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    stream = torch.cuda.current_stream(images_u8.device).cuda_stream
    err = _lib().color_jitter_launch(
        images_u8.data_ptr(), affine.data_ptr(), offset.data_ptr(),
        out.data_ptr(), b, h * w, SCALE, stream)
    _raise_on(err, "color_jitter", images_u8)
    launches["fused_color_jitter"] += 1
    return out


def fused_normalize_color_jitter(
    images_u8: torch.Tensor, m_chroma: torch.Tensor, contrast: torch.Tensor,
    brightness: torch.Tensor,
) -> torch.Tensor:
    """B2: normalize + colour jitter with the per-image means formed on
    the device from exact channel sums. ``m_chroma`` [B, 3, 3],
    ``contrast`` and ``brightness`` [B], float32 on the images' device."""
    _check(images_u8, m_chroma, contrast, brightness)
    if not _on_card(images_u8, m_chroma, contrast, brightness):
        return normalize_color_jitter_reference(
            images_u8, m_chroma, contrast, brightness)
    return _launch_b2(images_u8, m_chroma, contrast, brightness,
                      _b2_plan(*images_u8.shape[1:3]))


def _launch_b2(images_u8: torch.Tensor, m_chroma: torch.Tensor,
               contrast: torch.Tensor, brightness: torch.Tensor,
               plan: B2Plan) -> torch.Tensor:
    """B2 on checked CUDA tensors along ``plan``'s route."""
    b, h, w, _ = images_u8.shape
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    # Only the two-pass route sums through device memory (atomics).
    sums = (torch.zeros((b, 3), dtype=torch.int64, device=images_u8.device)
            if plan.route == "two_pass" else None)
    inv = float(np.float32(1.0 / (h * w * 127.5)))
    stream = torch.cuda.current_stream(images_u8.device).cuda_stream
    err = _lib().normalize_color_jitter_launch(
        images_u8.data_ptr(), m_chroma.data_ptr(), contrast.data_ptr(),
        brightness.data_ptr(), None if sums is None else sums.data_ptr(),
        out.data_ptr(), b, h * w, inv, SCALE, plan.cluster, plan.slice_bytes,
        plan.shared_bytes, stream)
    _raise_on(err, f"normalize_color_jitter ({plan.route})", images_u8)
    launches["fused_normalize_color_jitter"] += 1
    return out


def b2_max_active_clusters(plan: B2Plan) -> int:
    """How many of ``plan``'s clusters the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    err = _lib().normalize_color_jitter_max_clusters(
        plan.cluster, plan.shared_bytes, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err} for {plan}")
    return count.value
