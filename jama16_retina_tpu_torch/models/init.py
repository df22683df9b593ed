"""Seeded random init with Flax's default distributions.

``nn.Conv`` and ``nn.Dense`` kernels: lecun-normal, i.e. a normal of
standard deviation ``sqrt(1 / fan_in) / 0.87962566103423978`` truncated
at two standard deviations (the divisor restores unit variance after the
truncation), with ``fan_in`` the receptive field times input channels.
Biases are zeros, BatchNorm scales ones; running mean 0 and variance
1. A depthwise kernel ``(C, 1, k, k)`` has ``fan_in = k * k``, as
Flax's lecun-normal gives for its ``(k, k, 1, C)`` kernel. The draws
come from a ``torch.Generator``, so they do not repeat Flax's bits: the
parity tests start both frameworks from converted weights instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's "truncated_normal" constant).
_TRUNC_STD = 0.87962566103423978


def init_flax_default(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter and statistic of ``model`` in place, in
    ``state_dict`` order, from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith((".var", ".scale")):
                t.fill_(1.0)
            elif name.endswith((".mean", ".bias")):
                t.zero_()
            elif t.ndim in (2, 4):
                fan_in = math.prod(t.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            else:
                raise ValueError(f"no Flax default init for {name}")
    return model
