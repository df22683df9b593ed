"""The OpenCV operations of the fundus stage, in numpy, held to what
``cv2`` returns for the same inputs.

- ``resize_area``: ``cv2.resize(img, None, fx=fx, fy=fx,
  interpolation=cv2.INTER_AREA)`` for a uint8 downscale, bit for bit: the
  integer-scale branch (``resizeAreaFast``) when ``1 / fx`` is an
  integer, else the area table (``computeResizeAreaTab``) with OpenCV's
  float32 accumulation order and its rounding.
- ``resize_cubic``: ``cv2.resize(..., interpolation=cv2.INTER_CUBIC)``
  for uint8, bit for bit what OpenCV computes with
  ``cv2.setUseOptimized(False)``: 11-bit integer coefficients, an integer
  horizontal pass, and a vertical pass in float32 over 128-bit SIMD lanes
  (the integer path, shifted by 22, for a row's tail). OpenCV's default
  dispatch runs another path that differs from it by at most 1 level in
  a few percent of values (ROADMAP Queue C, parity gaps by design).
- ``resize_linear``: ``cv2.resize(img, (w, h),
  interpolation=cv2.INTER_LINEAR)`` for uint8, bit for bit (OpenCV 5.0's
  default dispatch and ``setUseOptimized(False)`` alike): 11-bit
  coefficients, an integer horizontal pass and the SIMD vertical pass
  over the whole row; an exact 2x downscale is ``INTER_AREA``'s, as
  OpenCV routes it.
- ``rgb2gray``: ``COLOR_RGB2GRAY`` (15-bit fixed point), bit for bit.
- ``laplacian_f32``: ``cv2.Laplacian(gray, cv2.CV_32F)`` (ksize 1,
  reflect-101 border), bit for bit.
- ``gaussian_blur_f32``: ``cv2.GaussianBlur(img, (0, 0), sigma)`` of a
  float32 image (kernel size ``round(8 sigma + 1) | 1``, reflect-101
  border), within 1e-4: OpenCV sums in float32 in its own order.

Both resizes take ``fx`` as ``cv2.resize(fx=fx, fy=fx)`` does: the output
size is ``round(size * fx)`` (half to even) and the sampling scale is
``1 / fx``, not the ratio of the sizes; an output of the input's size is
a copy.
"""

from __future__ import annotations

import numpy as np

from jama16_retina_tpu_torch.ops import image_codec

_DBL_EPSILON = np.finfo(np.float64).eps


def _out_size(n: int, fx: float) -> int:
    return int(np.rint(n * fx))


def _area_tab(n_in: int, n_out: int, scale: float
              ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """``computeResizeAreaTab``: per output position its source indices
    and float32 weights in OpenCV's order, padded to the longest entry
    list ([n_out, K] index, weight, and whether the slot is used)."""
    per = []
    for d in range(n_out):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for s in range(sx1, sx2):
            row.append((s, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell)
                                        / cell)))
        per.append(row)
    k = max(len(r) for r in per)
    idx = np.zeros((n_out, k), np.int32)
    wt = np.zeros((n_out, k), np.float32)
    used = np.zeros((n_out, k), np.uint8)
    for d, row in enumerate(per):
        for j, (s, a) in enumerate(row):
            idx[d, j], wt[d, j], used[d, j] = s, a, True
    return idx, wt, used


def _round_u8(x: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of float32: round half to even, clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_fast(src: np.ndarray, s: int, out_h: int, out_w: int
               ) -> np.ndarray:
    """``resizeAreaFast`` for an integer inverse scale ``s``: full s x s
    cells as ``(sum + 2) >> 2`` when s is 2, else ``round(sum *
    float32(1 / s^2))``; cells cut by the border as ``round(float32(sum)
    / count)``."""
    h, w, c = src.shape
    x = src.astype(np.int64)
    full_h, full_w = h // s, w // s
    out = np.zeros((out_h, out_w, c), np.uint8)
    if full_h and full_w:
        sums = x[:full_h * s, :full_w * s].reshape(
            full_h, s, full_w, s, c).sum(axis=(1, 3))
        if s == 2:
            block = ((sums + 2) >> 2).astype(np.uint8)
        else:
            scale = np.float32(1.0) / np.float32(s * s)
            block = _round_u8(sums.astype(np.float32) * scale)
        out[:min(full_h, out_h), :min(full_w, out_w)] = \
            block[:out_h, :out_w]
    # Only the last row and column of cells can be cut by the border.
    border = [(dy, dx) for dy in range(full_h, out_h) for dx in range(out_w)]
    border += [(dy, dx) for dy in range(min(full_h, out_h))
               for dx in range(full_w, out_w)]
    for dy, dx in border:
        cell = x[dy * s:dy * s + s, dx * s:dx * s + s]
        count = cell.shape[0] * cell.shape[1]
        if count == 0:
            continue
        total = cell.sum(axis=(0, 1)).astype(np.float32)
        out[dy, dx] = _round_u8(total / np.float32(count))
    return out


def resize_area(image: np.ndarray, fx: float) -> np.ndarray:
    """uint8 [H, W, C] downscaled by ``fx`` <= 1, as ``cv2.resize(image,
    None, fx=fx, fy=fx, interpolation=cv2.INTER_AREA)``."""
    src = np.asarray(image)
    h, w, _ = src.shape
    out_h, out_w = _out_size(h, fx), _out_size(w, fx)
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"resize of {src.shape[:2]} by {fx} is empty")
    if (out_h, out_w) == (h, w):
        out = src.copy()
    else:
        scale = 1.0 / fx
        if scale < 1:
            raise ValueError(f"resize_area downscales only (fx={fx} > 1)")
        iscale = int(np.rint(scale))
        if abs(scale - iscale) < _DBL_EPSILON:
            out = _area_fast(src, iscale, out_h, out_w)
        else:
            out = _area_table(src, scale, out_h, out_w)
    return out


def _area_table(src: np.ndarray, scale: float, out_h: int, out_w: int
                ) -> np.ndarray:
    """``ResizeArea_Invoker``: each source row is accumulated across into
    a float32 row buffer (``buf += src * alpha`` in table order), and the
    rows of an output row are accumulated down (``sum = beta * buf``,
    then ``sum += beta * buf``)."""
    h, w, c = src.shape
    xi, xw, xu = _area_tab(w, out_w, scale)
    yi, yw, yu = _area_tab(h, out_h, scale)
    out = np.empty((out_h, out_w, c), np.uint8)
    p = image_codec.ptr
    rc = image_codec.lib().resize_area_table(
        p(np.ascontiguousarray(src)), h, w, c, p(xi), p(xw), p(xu),
        xi.shape[1], p(yi), p(yw), p(yu), yi.shape[1], out_h, out_w, p(out))
    if rc:
        raise RuntimeError(f"resize_area_table failed ({rc})")
    return out


def _cubic_coeffs(f: np.ndarray) -> np.ndarray:
    """``interpolateCubic`` (A = -0.75) in float32, term for term ->
    [n, 4]."""
    f = f.astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = f + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1)


def _cubic_axis(n_in: int, n_out: int, scale: float
                ) -> "tuple[np.ndarray, np.ndarray]":
    """Clamped source indices [n_out, 4] and int16 coefficients
    ``round(c * 2048)`` [n_out, 4]."""
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    coef = np.rint(_cubic_coeffs(frac) * np.float32(2048)).astype(np.int32)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx.astype(np.int32), coef


# uint16 lanes of OpenCV's baseline SIMD registers (128 bits).
_SIMD_U16_LANES = 8


def _cubic_vector_span(width: int) -> int:
    """How many values of a row (``width`` = pixels x channels) OpenCV's
    vertical cubic pass computes in SIMD lanes; the rest take the integer
    path."""
    lanes = _SIMD_U16_LANES
    return 0 if width < lanes else ((width - lanes) // lanes + 1) * lanes


def resize_cubic(image: np.ndarray, fx: float) -> np.ndarray:
    """uint8 [H, W, C] resized by ``fx``, as ``cv2.resize(image, None,
    fx=fx, fy=fx, interpolation=cv2.INTER_CUBIC)`` computes it with
    ``cv2.setUseOptimized(False)``."""
    src = np.asarray(image)
    h, w, _ = src.shape
    out_h, out_w = _out_size(h, fx), _out_size(w, fx)
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"resize of {src.shape[:2]} by {fx} is empty")
    if (out_h, out_w) == (h, w):
        out = src.copy()
    else:
        c = src.shape[2]
        scale = 1.0 / fx
        xi, xc = _cubic_axis(w, out_w, scale)
        yi, yc = _cubic_axis(h, out_h, scale)
        out = np.empty((out_h, out_w, c), np.uint8)
        p = image_codec.ptr
        # VResizeCubicVec_32s8u: all but a row's tail is summed in float32
        # (coefficients scaled by 2^-22), S0 b0 + (S1 b1 + (S2 b2 + S3 b3)),
        # each step rounded, then rounded half to even; the tail is the
        # integer path, (sum + 2^21) >> 22.
        rc = image_codec.lib().resize_cubic_u8(
            p(np.ascontiguousarray(src)), h, w, c, p(xi), p(xc), p(yi),
            p(yc), out_h, out_w, _cubic_vector_span(out_w * c), p(out))
        if rc:
            raise RuntimeError(f"resize_cubic_u8 failed ({rc})")
    return out


def _linear_axis(n_in: int, n_out: int
                 ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(first source index, its int16 weight, the next index's weight)
    per output position: ``fx = float32((d + 0.5) * scale - 0.5)``, its
    floor and fraction, the weights ``round((1 - f) * 2048)`` and
    ``round(f * 2048)``, each rounded on its own. The index is not
    clamped: the caller clamps as OpenCV does on its axis."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return s, w0, w1


def resize_linear(image: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C], as ``cv2.resize(image,
    (out_w, out_h), interpolation=cv2.INTER_LINEAR)``.

    Across (``HResizeLinear``), a source index below 0 or at the last
    column and beyond is clamped with its fraction set to 0, and each
    output value is ``S[x] * w0 + S[x + 1] * w1`` in integers. Down
    (``VResizeLinearVec_32s8u``), the two source rows are clamped into
    the image (the weights are kept) and combined as the SIMD lanes do:
    ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, then ``+ 2 >>
    2``, saturated to uint8."""
    src = np.asarray(image)
    h, w, c = src.shape
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"resize to ({out_w}, {out_h}) is empty")
    if (out_h, out_w) == (h, w):
        return src.copy()
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    if (abs(scale_x - 2) < _DBL_EPSILON and abs(scale_y - 2) < _DBL_EPSILON):
        return _area_fast(src, 2, out_h, out_w)
    sx, a0, a1 = _linear_axis(w, out_w)
    edge = (sx < 0) | (sx >= w - 1)
    a0, a1 = np.where(edge, 2048, a0), np.where(edge, 0, a1)
    sx = np.clip(sx, 0, w - 1)
    x = src.astype(np.int64)
    across = (x[:, sx] * a0[None, :, None]
              + x[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    sy, b0, b1 = _linear_axis(h, out_h)
    s0 = across[np.clip(sy, 0, h - 1)] >> 4
    s1 = across[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def rgb2gray(image_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> uint8 [H, W], ``cv2.COLOR_RGB2GRAY``."""
    x = np.asarray(image_rgb).astype(np.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2]
             + (1 << 14)) >> 15).astype(np.uint8)


def laplacian_f32(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> float32 [H, W], the 5-point Laplacian with a
    reflect-101 border (``cv2.Laplacian(gray, cv2.CV_32F)``)."""
    p = np.pad(np.asarray(gray).astype(np.float32), 1, mode="reflect")
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - np.float32(4) * p[1:-1, 1:-1])


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``getGaussianKernel(round(8 sigma + 1) | 1, sigma)`` as float32."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def gaussian_blur_f32(image: np.ndarray, sigma: float) -> np.ndarray:
    """float32 [H, W, C] (or [H, W]) blurred by the separable Gaussian of
    ``sigma`` in both directions, reflect-101 border."""
    img = np.asarray(image, np.float32)
    k = gaussian_kernel(sigma).astype(np.float64)
    r = k.size // 2
    out = img
    for axis in (1, 0):
        width = [(0, 0)] * img.ndim
        width[axis] = (r, r)
        p = np.pad(out, width, mode="reflect").astype(np.float64)
        n = out.shape[axis]
        acc = np.zeros(out.shape, np.float64)
        for i in range(k.size):
            acc += k[i] * np.take(p, np.arange(i, i + n), axis=axis)
        out = acc.astype(np.float32)
    return out
