"""``ConvBN``, the unit cell of the backbones (counterpart of
``jama16_retina_tpu/models/common.py:30``), in eval and train form.

Numerics mirror the Flax cell: the conv has no bias and runs in the
compute dtype; BatchNorm has no scale, eps 1e-3, and is computed in
float32 as ``(x - mean) * rsqrt(var + eps) + bias``; ReLU follows and
the result is cast to the compute dtype. Parameters stay float32 and are
cast at the conv, as Flax does. Eval form normalizes with the running
statistics; train form with the batch's own (see ``BatchNorm``).

Module and buffer names follow the Flax tree (``conv.weight`` for
``conv/kernel``; ``bn.bias`` / ``bn.mean`` / ``bn.var``), so
``models/convert.py`` maps the two mechanically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.9

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype when that is wider: where
    Flax promotes a reduction to float32 (bf16 and float32 inputs give
    float32, float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def head_mean(x: torch.Tensor) -> torch.Tensor:
    """Spatial mean for the float32 head: taken in float32 (or wider),
    rounded to the compute dtype, then float32. jnp's mean of a bf16
    array accumulates in float32 and returns bf16, and the Flax heads cast
    that to float32."""
    return at_least_f32(x).mean(dim=(2, 3)).to(x.dtype).float()


def dropout(x: torch.Tensor, rate: float,
            generator: "torch.Generator | None") -> torch.Tensor:
    """Flax ``nn.Dropout`` in train mode: keep each value with
    probability ``1 - rate`` (a uniform draw from ``generator`` on the
    tensor's device) and scale it by ``1 / (1 - rate)``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """Scale-free BatchNorm (Flax ``nn.BatchNorm(use_scale=False)``).

    Eval form normalizes with the running statistics. Train form takes
    the batch's statistics in float32 (float64 for float64 input) over
    N, H, W with Flax's fast
    variance ``E[x^2] - E[x]^2`` clipped at 0, and gradients flow through
    both. It also updates the running statistics in place as
    ``ra = 0.9 * ra + 0.1 * batch`` for the mean and the *biased*
    variance, which is Flax's rule; torch's own BatchNorm would update
    with the unbiased variance."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            inv = torch.rsqrt(self.var + BN_EPS)
            return ((at_least_f32(x) - self.mean.view(shape)) * inv.view(shape)
                    + self.bias.view(shape))
        xf = at_least_f32(x)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              0.0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean
                            + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        inv = torch.rsqrt(var + BN_EPS)
        return (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> ReLU -> cast to the compute dtype.

    ``padding`` is ``"SAME"`` or ``"VALID"`` as in Flax. SAME is resolved
    against the input size at call time: symmetric for the stride-1 odd
    kernels of Inception-v3 (including 1x7 and 7x1), asymmetric (extra
    row and column at the end) where XLA's rule makes it so, as for the
    stride-2 convs of ``tiny_cnn`` on even inputs.
    """

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 strides=(1, 1), padding: str = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, self.kernel,
                              stride=self.strides, bias=False)
        self.bn = BatchNorm(features)

    def _pad(self, x: torch.Tensor) -> "tuple[torch.Tensor, tuple]":
        if self.padding == "VALID":
            return x, (0, 0)
        (ht, hb), (wl, wr) = (
            same_padding(x.shape[2], self.kernel[0], self.strides[0]),
            same_padding(x.shape[3], self.kernel[1], self.strides[1]),
        )
        if ht == hb and wl == wr:
            return x, (ht, wl)
        return F.pad(x, (wl, wr, ht, hb)), (0, 0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x, pad = self._pad(x)
        y = F.conv2d(x, self.conv.weight.to(self.dtype), None,
                     self.strides, pad)
        return F.relu(self.bn(y, train)).to(self.dtype)
