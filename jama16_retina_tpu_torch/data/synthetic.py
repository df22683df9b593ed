"""Synthetic fundus images (copy of ``render_fundus``, ``make_dataset``
and ``sample_grades`` from ``jama16_retina_tpu/data/synthetic.py``),
numpy only.

A bright circular retina disc on black, an optic-disc highlight,
vessel-like arcs and grade-correlated lesions, drawn from a numpy
``Generator`` so both packages render the same pixels from one seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# make_dataset's default grade marginals (EyePACS's skew toward grade 0).
GRADE_MARGINALS = (0.55, 0.15, 0.15, 0.08, 0.07)


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    image_size: int = 299
    min_radius_frac: float = 0.40  # fundus radius as fraction of image size
    max_radius_frac: float = 0.48
    lesions_per_grade: int = 6
    lesion_radius: int = 3


def _disc_mask(
    yy: np.ndarray, xx: np.ndarray, cx: float, cy: float, r: float
) -> np.ndarray:
    """Disc mask over precomputed coordinate grids (built once per image —
    rebuilding mgrid for each of the ~30 lesions dominated fixture time)."""
    return ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r


def render_fundus(
    rng: np.random.Generator, grade: int, cfg: SynthConfig
) -> np.ndarray:
    """Render one uint8 RGB fundus-like image for an ICDR grade in [0, 4]."""
    s = cfg.image_size
    img = np.zeros((s, s, 3), dtype=np.float32)

    yy, xx = np.mgrid[0:s, 0:s]
    r = rng.uniform(cfg.min_radius_frac, cfg.max_radius_frac) * s
    cx = s / 2 + rng.uniform(-0.03, 0.03) * s
    cy = s / 2 + rng.uniform(-0.03, 0.03) * s
    disc = _disc_mask(yy, xx, cx, cy, r)

    # Retina base color: orange-red with radial shading.
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / max(r, 1.0)
    shade = np.clip(1.0 - 0.35 * dist, 0.0, 1.0)
    base = np.array([0.82, 0.42, 0.18], dtype=np.float32)
    base = base * rng.uniform(0.85, 1.15, size=3)
    img[disc] = (shade[disc, None] * base[None, :]) * 255.0

    # Optic disc: bright yellowish circle off-center.
    od_r = r * rng.uniform(0.10, 0.14)
    od_cx = cx + rng.choice([-1, 1]) * r * 0.55
    od_cy = cy + rng.uniform(-0.15, 0.15) * r
    od = _disc_mask(yy, xx, od_cx, od_cy, od_r) & disc
    img[od] = np.array([235.0, 210.0, 140.0], dtype=np.float32)

    # Vessel-like dark arcs from the optic disc.
    n_vessels = rng.integers(3, 6)
    t = np.linspace(0, 1, 220)
    for _ in range(n_vessels):
        ang = rng.uniform(0, 2 * np.pi)
        curve = rng.uniform(-2.0, 2.0)
        px = od_cx + t * r * 1.6 * np.cos(ang + curve * t)
        py = od_cy + t * r * 1.6 * np.sin(ang + curve * t)
        pts = np.stack([py, px], axis=1).astype(np.int64)
        ok = (
            (pts[:, 0] >= 0) & (pts[:, 0] < s) & (pts[:, 1] >= 0) & (pts[:, 1] < s)
        )
        pts = pts[ok]
        inside = disc[pts[:, 0], pts[:, 1]]
        pts = pts[inside]
        for dy in (-1, 0, 1):
            yyv = np.clip(pts[:, 0] + dy, 0, s - 1)
            img[yyv, pts[:, 1]] *= 0.55

    # Grade-correlated lesions: dark red dots (count ~ grade), plus pale
    # exudate blobs for grades >= 3. This is the learnable signal.
    n_lesions = int(grade) * cfg.lesions_per_grade + int(rng.integers(0, 3))
    for _ in range(n_lesions):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.1, 0.9) * r
        lx, ly = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
        lr = cfg.lesion_radius * rng.uniform(0.7, 1.6)
        lm = _disc_mask(yy, xx, lx, ly, lr) & disc
        img[lm] = np.array([95.0, 18.0, 12.0], dtype=np.float32)
    if grade >= 3:
        for _ in range(int(grade)):
            ang = rng.uniform(0, 2 * np.pi)
            rad = rng.uniform(0.2, 0.8) * r
            lx, ly = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
            lm = _disc_mask(yy, xx, lx, ly, cfg.lesion_radius * 2.2) & disc
            img[lm] = np.array([230.0, 220.0, 160.0], dtype=np.float32)

    # Sensor noise.
    img += rng.normal(0.0, 4.0, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_dataset(n: int, cfg: "SynthConfig | None" = None,
                 grades: "np.ndarray | None" = None, seed: int = 0,
                 ) -> "tuple[np.ndarray, np.ndarray]":
    """(images [n, s, s, 3] uint8, grades [n] int32): the grades are drawn
    first on the seed's generator (unless given), then every image is
    rendered from the same stream, so both packages make the same set
    from one seed."""
    cfg = cfg or SynthConfig()
    rng = np.random.default_rng(seed)
    if grades is None:
        grades = sample_grades(n, rng)
    grades = np.asarray(grades, dtype=np.int32)
    images = np.stack([render_fundus(rng, int(g), cfg) for g in grades])
    return images, grades


def sample_grades(n: int, rng: np.random.Generator,
                  marginals=None) -> np.ndarray:
    """``n`` ICDR grades drawn with ``marginals`` (default
    ``GRADE_MARGINALS``): five probabilities summing to 1."""
    marg = np.asarray(GRADE_MARGINALS if marginals is None else marginals,
                      np.float64)
    if marg.shape != (5,) or np.any(marg < 0) or not np.isclose(
            marg.sum(), 1.0):
        raise ValueError(f"grade marginals must be 5 probabilities summing "
                         f"to 1, got {marginals!r}")
    return rng.choice(5, size=n, p=list(marg / marg.sum()))
