"""Fundus normalization (copy of ``jama16_retina_tpu/preprocess/fundus.py``).

Each photograph is normalized so the fundus disc has a fixed radius,
centered on a black ``diameter x diameter`` canvas: threshold a
grayscale copy, fit the disc from the lit extent, rescale, paste
centered, mask the circle. ``ben_graham=True`` subtracts a local
Gaussian average. Host-side numpy with no OpenCV: the resizes, the grey
conversion, the Laplacian and the blur are ``preprocess/imgproc.py``'s
counterparts of the reference's ``cv2`` calls. The canvas is bit for bit
the reference's on a downscale (``INTER_AREA``); an upscale
(``INTER_CUBIC``) is OpenCV's generic path, within 1 level of its
default build's, and ``ben_graham`` within 1 level (the blur within
1e-4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jama16_retina_tpu_torch.preprocess import imgproc


class FundusNotFound(ValueError):
    """No circular lit region detected (blank/corrupt photograph)."""


@dataclasses.dataclass(frozen=True)
class Circle:
    cx: float
    cy: float
    radius: float


def find_fundus_circle(
    image_rgb: np.ndarray, threshold: int = 12, min_radius_frac: float = 0.05
) -> Circle:
    """Locate the fundus disc: bounding extent of above-threshold pixels.

    Row/column projections of the lit mask are robust to the dark corners
    and small specular highlights typical of fundus frames, and cost one
    pass over a grayscale copy — no Hough transform needed.
    """
    if image_rgb.ndim != 3 or image_rgb.shape[-1] != 3:
        raise ValueError(f"expected HWC RGB, got shape {image_rgb.shape}")
    gray = image_rgb.astype(np.float32).mean(axis=-1)
    mask = gray > threshold
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        raise FundusNotFound("no pixels above background threshold")
    y0, y1 = rows[0], rows[-1]
    x0, x1 = cols[0], cols[-1]
    # The disc is the inscribed circle of the lit extent; when the frame
    # crops top/bottom (common in EyePACS), width is the trustworthy axis.
    radius = max(x1 - x0 + 1, y1 - y0 + 1) / 2.0
    cx = (x0 + x1 + 1) / 2.0
    cy = (y0 + y1 + 1) / 2.0
    if radius < min_radius_frac * max(image_rgb.shape[:2]):
        raise FundusNotFound(f"detected radius {radius:.1f}px too small")
    return Circle(cx=cx, cy=cy, radius=radius)


def _gaussian_blur(image: np.ndarray, sigma: float) -> np.ndarray:
    return imgproc.gaussian_blur_f32(image, sigma)


def ben_graham_enhance(image: np.ndarray, alpha: float = 4.0) -> np.ndarray:
    """Subtract the local average color (Gaussian ~radius/30) — evens out
    illumination differences between cameras; from the winning Kaggle
    EyePACS recipe. Input/output uint8 RGB."""
    f = image.astype(np.float32)
    blur = _gaussian_blur(f, sigma=max(image.shape[0] / 30.0, 1.0))
    out = alpha * (f - blur) + 128.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _circle_mask(diameter: int, fill: float) -> np.ndarray:
    yy, xx = np.mgrid[0:diameter, 0:diameter]
    r = diameter * fill / 2.0
    return ((xx - diameter / 2 + 0.5) ** 2
            + (yy - diameter / 2 + 0.5) ** 2) <= r * r


def gradability_stats(
    norm_rgb: np.ndarray, fill: float = 0.98
) -> dict[str, float]:
    """Cheap image-quality / gradability heuristics for one NORMALIZED
    fundus canvas (pre-enhancement), restricted to the fundus circle.

    The replication's hypothesized AUC gap vs the original JAMA study is
    the original's non-public image-quality grading (docs/QUALITY.md,
    SURVEY.md §6 note) — this is the executable stand-in: a [0, 1]
    ``quality`` score combining

      * sharpness  — Laplacian variance inside the circle (the classic
        focus measure; blur collapses it),
      * illumination — penalize under/over-exposed means (a window, not
        a target: fundus cameras differ in brightness),
      * contrast   — grayscale std inside the circle (washed-out frames
        carry no gradeable vasculature).

    Each term saturates smoothly; the score is their product. It is a
    HEURISTIC proxy for gradability, meant for ranking/filtering
    (``--min_quality``), not a calibrated probability — thresholds
    should be chosen by inspecting the preprocessing report's
    distribution.
    """
    if norm_rgb.ndim != 3 or norm_rgb.shape[0] != norm_rgb.shape[1]:
        raise ValueError(f"expected square HWC canvas, got {norm_rgb.shape}")
    d = norm_rgb.shape[0]
    gray = imgproc.rgb2gray(norm_rgb)
    mask = _circle_mask(d, fill)
    vals = gray[mask].astype(np.float32)
    lap = imgproc.laplacian_f32(gray)
    lap_var = float(lap[mask].var())
    mean = float(vals.mean())
    std = float(vals.std())
    # Saturation constants chosen on synthetic + public fundus ranges:
    # sharp fundus photographs at 299px sit at lap_var ~100-1000, heavy
    # blur < 10; usable illumination means ~40-220 of 255; gradeable
    # contrast std ≳ 25.
    sharpness = 1.0 - float(np.exp(-lap_var / 50.0))
    if mean < 40.0:
        illum = mean / 40.0
    elif mean > 220.0:
        illum = max(0.0, (255.0 - mean) / 35.0)
    else:
        illum = 1.0
    contrast = 1.0 - float(np.exp(-std / 25.0))
    return {
        "quality": round(sharpness * illum * contrast, 4),
        "lap_var": round(lap_var, 2),
        "mean": round(mean, 2),
        "std": round(std, 2),
    }


def resize_and_center_fundus(
    image_rgb: np.ndarray,
    diameter: int = 299,
    fill: float = 0.98,
    circular_mask: bool = True,
    ben_graham: bool = False,
    threshold: int = 12,
    with_quality: bool = False,
):
    """Normalize one photograph to a centered fixed-radius fundus
    (the reference's ``resize_and_center_fundus``, SURVEY.md R6).

    Returns uint8 RGB ``[diameter, diameter, 3]`` — or, with
    ``with_quality``, a ``(canvas, gradability_stats)`` pair where the
    stats are computed on the PRE-enhancement canvas (ben-graham
    deliberately flattens illumination and boosts edges, which would
    blind the very heuristics meant to catch bad captures). Raises
    FundusNotFound for blank frames (callers count and skip these, as
    the reference's preprocessing scripts did).
    """
    circle = find_fundus_circle(image_rgb, threshold=threshold)
    scale = (diameter * fill) / (2.0 * circle.radius)
    resize = imgproc.resize_area if scale < 1 else imgproc.resize_cubic
    resized = resize(image_rgb, scale)
    cx, cy = circle.cx * scale, circle.cy * scale

    canvas = np.zeros((diameter, diameter, 3), dtype=np.uint8)
    # Source window centered on the fundus, clipped to the resized frame.
    half = diameter / 2.0
    sx0 = int(round(cx - half)); sy0 = int(round(cy - half))
    sx1, sy1 = sx0 + diameter, sy0 + diameter
    dx0 = max(0, -sx0); dy0 = max(0, -sy0)
    sx0 = max(0, sx0); sy0 = max(0, sy0)
    sx1 = min(resized.shape[1], sx1); sy1 = min(resized.shape[0], sy1)
    w = sx1 - sx0; h = sy1 - sy0
    if w <= 0 or h <= 0:
        raise FundusNotFound("fundus window fell outside the frame")
    canvas[dy0:dy0 + h, dx0:dx0 + w] = resized[sy0:sy1, sx0:sx1]

    quality = gradability_stats(canvas, fill) if with_quality else None
    if ben_graham:
        canvas = ben_graham_enhance(canvas)
    if circular_mask:
        canvas[~_circle_mask(diameter, fill)] = 0
    return (canvas, quality) if with_quality else canvas
