"""The records path's resize: ``tf.cast(tf.image.resize(image, (size,
size), method="bilinear"), tf.uint8)`` in float32 numpy, bit for bit
(half-pixel centres, no antialiasing, truncation to uint8), as the
reference's input pipeline resizes a record that is not at
``model.image_size``."""

from __future__ import annotations

import numpy as np


def _axis(n_in: int, n_out: int) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(lower index, upper index, float32 weight of the upper) per output
    position, as TensorFlow's ``compute_interpolation_weights`` computes
    them with ``HalfPixelScaler``."""
    scale = np.float32(n_in) / np.float32(n_out)
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    lo_f = np.floor(f)
    lo = np.maximum(lo_f.astype(np.int64), 0)
    hi = np.minimum(np.ceil(f).astype(np.int64), n_in - 1)
    return lo, hi, (f - lo_f).astype(np.float32)


def tf_bilinear_u8(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [size, size, C]."""
    x = np.asarray(image).astype(np.float32)
    y0, y1, yl = _axis(x.shape[0], size)
    x0, x1, xl = _axis(x.shape[1], size)
    xl = xl[None, :, None]
    top_rows, bot_rows = x[y0], x[y1]
    tl, tr = top_rows[:, x0], top_rows[:, x1]
    bl, br = bot_rows[:, x0], bot_rows[:, x1]
    top = tl + (tr - tl) * xl
    bot = bl + (br - bl) * xl
    out = top + (bot - top) * yl[:, None, None]
    return out.astype(np.uint8)
