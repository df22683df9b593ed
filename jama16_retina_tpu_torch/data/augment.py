"""Input normalization (counterpart of ``jama16_retina_tpu/data/augment.py:47``)."""

from __future__ import annotations

import torch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (Inception input convention)."""
    return images_u8.float() / 127.5 - 1.0
