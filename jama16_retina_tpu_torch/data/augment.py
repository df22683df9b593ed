"""On-device augmentation of uint8 train batches (counterpart of
``jama16_retina_tpu/data/augment.py``).

All randomness of a batch comes from one ``torch.Generator`` in six
batch-level draws (``_draw_params``); ``augment_batch`` takes an already
drawn dict through ``params=``, which is how the tests hand both
frameworks the same draws (a generator cannot repeat threefry's bits).

Three routes, chosen as the JAX package chooses them:

- ``data.augment`` off: ``normalize`` only;
- ``data.use_pallas``: the colour map through kernel B1
  (``ops/color_jitter.fused_color_jitter``), then the geometric moves;
- ``fused`` (``train.use_pallas_fused``, wins over ``use_pallas``):
  kernel B2 with the means formed on the device, then the geometric moves;
- otherwise the sequential composition ``_augment_jnp``, the counterpart
  of the reference's jnp ``_augment_one`` (not a plain version of B1).

Geometric moves are pixel permutations and commute with the per-pixel
colour map (the contrast mean is permutation-invariant), so the kernel
routes apply colour first.
"""

from __future__ import annotations

import math

import torch

from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.ops import color_jitter


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (Inception input convention)."""
    return images_u8.float() / 127.5 - 1.0


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo


def _draw_params(gen: torch.Generator, n: int, cfg: DataConfig,
                 device) -> dict:
    """The batch's augment draws (keys and ranges of the reference's
    ``_draw_params``): hflip, vflip, transpose bool [n]; brightness,
    contrast float32 [n]; sat_hue float32 [n, 2] (saturation, hue as a
    fraction of a turn)."""
    lo, hi = cfg.contrast_range
    slo, shi = cfg.saturation_range
    coin = [torch.rand(n, generator=gen, device=device) < 0.5
            for _ in range(3)]
    return {
        "hflip": coin[0],
        "vflip": coin[1],
        "transpose": coin[2],
        "brightness": _uniform(gen, n, -cfg.brightness_delta,
                               cfg.brightness_delta, device),
        "contrast": _uniform(gen, n, lo, hi, device),
        "sat_hue": torch.stack([
            _uniform(gen, n, slo, shi, device),
            _uniform(gen, n, -cfg.hue_delta, cfg.hue_delta, device)], dim=1),
    }


def _per_image(flag: torch.Tensor) -> torch.Tensor:
    return flag[:, None, None, None]


def _geometric(imgs: torch.Tensor, p: dict, cfg: DataConfig) -> torch.Tensor:
    """Flips and, for square images only, the transpose, as batched
    selects over NHWC (``_geometric_one`` of the reference): with the two
    flips the transpose generates the whole dihedral group of the
    square; a rectangle has no 90-degree rotation, so it is skipped."""
    if cfg.flip:
        imgs = torch.where(_per_image(p["hflip"]), imgs.flip(2), imgs)
        imgs = torch.where(_per_image(p["vflip"]), imgs.flip(1), imgs)
    if cfg.rotate and imgs.shape[1] == imgs.shape[2]:
        imgs = torch.where(_per_image(p["transpose"]), imgs.transpose(1, 2),
                           imgs)
    return imgs


def _matmul_rows(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``img @ m.T`` over the channel axis as float32 multiply-and-sum:
    the reference pins these products to ``Precision.HIGHEST``."""
    return (img[..., None, :] * m.to(img.device)).sum(dim=-1)


def _augment_jnp(imgs: torch.Tensor, p: dict, cfg: DataConfig) -> torch.Tensor:
    """Sequential composition on normalized float32 NHWC images (the
    reference's jnp ``_augment_one``, batched)."""
    imgs = _geometric(imgs, p, cfg)
    if cfg.brightness_delta > 0:
        imgs = imgs + _per_image(p["brightness"])
    lo, hi = cfg.contrast_range
    if (lo, hi) != (1.0, 1.0):
        mean = imgs.mean(dim=(1, 2), keepdim=True)
        imgs = (imgs - mean) * _per_image(p["contrast"]) + mean
    slo, shi = cfg.saturation_range
    if (slo, shi) != (1.0, 1.0) or cfg.hue_delta > 0:
        yiq = _matmul_rows(imgs, color_jitter.RGB2YIQ)
        s = p["sat_hue"][:, 0]
        theta = p["sat_hue"][:, 1] * (2.0 * math.pi)
        cos = (torch.cos(theta) * s)[:, None, None]
        sin = (torch.sin(theta) * s)[:, None, None]
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], cos * i - sin * q, sin * i + cos * q],
                          dim=-1)
        imgs = _matmul_rows(yiq, color_jitter.YIQ2RGB)
    return torch.clamp(imgs, -1.0, 1.0)


def augment_batch(generator: "torch.Generator | None",
                  images_u8: torch.Tensor, cfg: DataConfig,
                  fused: bool = False, params: "dict | None" = None,
                  ) -> torch.Tensor:
    """uint8 NHWC batch -> augmented float32 [-1, 1] NHWC batch on the
    batch's device. ``params`` replaces the draws from ``generator``."""
    if not cfg.augment:
        return normalize(images_u8)
    if params is None:
        params = _draw_params(generator, images_u8.shape[0], cfg,
                              images_u8.device)
    saturation = params["sat_hue"][:, 0].contiguous()
    hue_theta = params["sat_hue"][:, 1] * (2.0 * math.pi)
    if fused:
        imgs = color_jitter.fused_normalize_color_jitter(
            images_u8, color_jitter.chroma_matrix(saturation, hue_theta),
            params["contrast"], params["brightness"])
    elif cfg.use_pallas:
        affine, offset = color_jitter.color_affine_from_params(
            color_jitter.channel_means_u8(images_u8), params["brightness"],
            params["contrast"], saturation, hue_theta)
        imgs = color_jitter.fused_color_jitter(images_u8, affine, offset)
    else:
        return _augment_jnp(normalize(images_u8), params, cfg)
    return _geometric(imgs, params, cfg)
