"""``ConvBN``, the unit cell of the backbones (counterpart of
``jama16_retina_tpu/models/common.py:30``), in eval form.

Numerics mirror the Flax cell: the conv has no bias and runs in the
compute dtype; BatchNorm has no scale, eps 1e-3, and is computed in
float32 as ``(x - mean) * rsqrt(var + eps) + bias`` from the running
statistics; ReLU follows and the result is cast to the compute dtype.
Parameters stay float32 and are cast at the conv, as Flax does.

Module and buffer names follow the Flax tree (``conv.weight`` for
``conv/kernel``; ``bn.bias`` / ``bn.mean`` / ``bn.var``), so
``models/convert.py`` maps the two mechanically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def head_mean(x: torch.Tensor) -> torch.Tensor:
    """Spatial mean for the float32 head: taken in float32, rounded to
    the compute dtype, then float32 again. jnp's mean of a bf16 array
    accumulates in float32 and returns bf16, and the Flax heads cast
    that to float32."""
    return x.float().mean(dim=(2, 3)).to(x.dtype).float()


class EvalBatchNorm(nn.Module):
    """Scale-free BatchNorm from stored statistics (eval mode only)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.var + BN_EPS)
        return ((x.float() - self.mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


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
        self.bn = EvalBatchNorm(features)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = self._pad(x)
        y = F.conv2d(x, self.conv.weight.to(self.dtype), None,
                     self.strides, pad)
        return F.relu(self.bn(y)).to(self.dtype)
