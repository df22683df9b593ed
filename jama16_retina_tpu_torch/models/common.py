"""``ConvBN``, the unit cell of the backbones (counterpart of
``jama16_retina_tpu/models/common.py:30``), in eval and train form.

Numerics mirror the Flax cell: the conv has no bias and runs in the
compute dtype; BatchNorm has no scale, eps 1e-3, and is computed in
float32 as ``(x - mean) * rsqrt(var + eps) + bias``; ReLU follows and
the result is cast to the compute dtype. Parameters stay float32 and
are cast at the conv, as Flax does. Eval form normalizes with the
running statistics; train form with the batch's own (see
``BatchNorm``, which also takes the learned scale and momentum of the
ResNet and EfficientNet BatchNorms). ``max_pool_same`` is the SAME max
pool of the ResNet stem.

Module and buffer names follow the Flax tree (``conv.weight`` for
``conv/kernel``; ``bn.bias`` / ``bn.mean`` / ``bn.var``), so
``models/convert.py`` maps the two mechanically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jama16_retina_tpu_torch.parallel.mesh import mean_over_ranks

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


class Draws:
    """Uniform [0, 1) draws made before a train forward, handed out in the
    order its dropout and stochastic-depth masks ask for them. It stands
    in for the forward's generator where a generator cannot run: the
    stacked-member step (``train_lib.ensemble_train_step``) makes each
    member's draws from that member's generator outside
    ``torch.func.vmap``, the numbers a forward with that generator would
    draw (``models.dropout_shapes`` gives their shapes)."""

    def __init__(self, tensors):
        self._tensors = list(tensors)
        self._next = 0

    def uniform(self, shape) -> torch.Tensor:
        if self._next >= len(self._tensors):
            raise ValueError("the forward asked for more draws than were "
                             f"made ({len(self._tensors)})")
        t = self._tensors[self._next]
        self._next += 1
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {self._next - 1} has shape "
                             f"{tuple(t.shape)}, the forward wants "
                             f"{tuple(shape)}")
        return t


def uniform(shape, generator: "torch.Generator | Draws | None",
            device) -> torch.Tensor:
    """A float32 uniform [0, 1) draw of ``shape`` from ``generator`` on
    ``device``, or the next of a ``Draws``."""
    if isinstance(generator, Draws):
        return generator.uniform(shape)
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float,
            generator: "torch.Generator | Draws | None") -> torch.Tensor:
    """Flax ``nn.Dropout`` in train mode: keep each value with
    probability ``1 - rate`` (a uniform draw from ``generator`` on the
    tensor's device) and scale it by ``1 / (1 - rate)``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def same_pad(x: torch.Tensor, kernel, strides,
             value: float = 0.0) -> "tuple[torch.Tensor, tuple]":
    """XLA's SAME padding of NCHW ``x`` for a window of ``kernel`` at
    ``strides``, resolved against its size: ``(x, (ph, pw))`` for the
    symmetric padding a conv or pool applies itself, or ``x`` padded
    with ``value`` at its lower and upper edges and ``(0, 0)`` where XLA
    pads one more row or column at the end."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], kernel[0], strides[0]),
                          same_padding(x.shape[3], kernel[1], strides[1]))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


def conv(x: torch.Tensor, module: nn.Conv2d, dtype: torch.dtype,
         padding=None) -> torch.Tensor:
    """``module``'s conv in ``dtype`` (weights cast there, as Flax casts
    its float32 params) with XLA's SAME padding, or the explicit
    symmetric ``padding`` when given. A bias is added after the conv's
    result is rounded to ``dtype``, as ``nn.Conv`` adds it."""
    if padding is None:
        x, padding = same_pad(x, module.kernel_size, module.stride)
    y = F.conv2d(x, module.weight.to(dtype), None, module.stride, padding,
                 groups=module.groups)
    if module.bias is None:
        return y
    return y + module.bias.to(dtype).view(1, -1, 1, 1)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")``: padded with
    -inf, then a VALID pool (XLA pads (0, 1) on a 150-cell axis, which
    ``F.max_pool2d``'s symmetric ``padding`` cannot express)."""
    x, pad = same_pad(x, (window, window), (stride, stride), float("-inf"))
    return F.max_pool2d(x, window, stride, pad)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, with the weight and
    bias cast there as Flax's ``nn.Dense(dtype=...)`` casts its params:
    the float32 heads of the backbones, which under a bfloat16 view of
    the params (``train.dtype=bf16``) compute from bf16-rounded weights
    in float32, as the Flax heads do."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` with a bias, and with a learned scale when
    ``use_scale`` (Inception-v3's has none; ResNet's and EfficientNet's
    have one). The scale multiplies the inverse deviation first, in
    Flax's order: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    Eval form normalizes with the running statistics. Train form takes
    the batch's statistics in float32 (float64 for float64 input) over
    N, H, W with Flax's fast
    variance ``E[x^2] - E[x]^2`` clipped at 0, and gradients flow through
    both. It also updates the running statistics in place as
    ``ra = m * ra + (1 - m) * batch`` at ``momentum`` m (0.9 by default;
    EfficientNet's is 0.99) for the mean and the *biased* variance,
    which is Flax's rule; torch's own BatchNorm would update with the
    unbiased variance.

    Under a data mesh of more than one rank (``mesh``, set by
    ``models.build``; Flax's ``axis_name``) the train form's moments are
    the global batch's: each rank takes ``mean`` and ``mean(x^2)`` over
    its rows, one differentiable all-reduce averages both over the ranks
    (``parallel.mesh.mean_over_ranks``), and the clipped fast variance is
    formed from the averages, as Flax forms it under ``axis_name``. The
    running statistics update from those moments, so they stay equal on
    every rank. The eval form never communicates."""

    def __init__(self, channels: int, use_scale: bool = False,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.mesh = None
        self.register_parameter(
            "scale", nn.Parameter(torch.ones(channels)) if use_scale else None)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def _normalize(self, xf, mean, var) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS)
        if self.scale is not None:
            mul = mul * self.scale
        return ((xf - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = at_least_f32(x)
        if not train:
            return self._normalize(xf, self.mean, self.var)
        mean = xf.mean(dim=(0, 2, 3))
        mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        if self.mesh is not None:
            mean, mean_sq = mean_over_ranks(torch.stack([mean, mean_sq]),
                                            self.mesh).unbind(0)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return self._normalize(xf, mean, var)


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
        self.padding = padding
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, tuple(kernel),
                              stride=tuple(strides), bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv(x, self.conv, self.dtype,
                 (0, 0) if self.padding == "VALID" else None)
        return F.relu(self.bn(y, train)).to(self.dtype)
