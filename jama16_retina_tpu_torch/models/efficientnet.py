"""EfficientNet in eval and train form (counterpart of
``jama16_retina_tpu/models/efficientnet.py``): MBConv blocks (1x1
expansion, depthwise conv, squeeze-and-excitation, 1x1 projection) with
compound width and depth scaling; ``EfficientNet.b4`` is width 1.4,
depth 1.8 (stem 48, head 1792, 32 blocks).

Numerics follow the Flax module. Every BatchNorm has a learned scale,
eps 1e-3 and momentum 0.99, and outputs float32; swish follows it and
the result is cast to the compute dtype, except after ``project_bn``
(a cast, no activation) and ``head_bn`` (swish, kept float32). The
squeeze-and-excitation path runs in the compute dtype: the spatial mean
(accumulated in float32, rounded), two 1x1 convs with bias, swish and
sigmoid, and the product. Sigmoid is ``1 / (1 + exp(-x))`` rounded per
operation, as XLA expands ``jax.nn.sigmoid``, and swish is
``x * sigmoid(x)``, as ``nn.swish``. SAME padding of the depthwise convs is
resolved against the input size at call time (XLA pads (0, 1) for a
3x3/2 on 150 or 38 cells, (2, 2) for a 5x5/2 on 75 or 19).

Stochastic depth drops a block's residual branch for whole examples
with probability ``0.2 * block_idx / total_blocks`` and scales the kept
ones by ``1 / keep``; its keep draws come from the step's dropout
generator in block order, before the head's dropout draw.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from jama16_retina_tpu_torch.models.common import (BatchNorm, Dense,
                                                   at_least_f32, conv,
                                                   dropout, head_mean,
                                                   uniform)

# (expand_ratio, kernel, stride, out_filters_b0, repeats_b0)
B0_BLOCKS = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)
SE_RATIO = 0.25
BN_MOMENTUM = 0.99  # EfficientNet's own, not Inception-v3's 0.9


def round_filters(filters: int, width_mult: float) -> int:
    """Channel rounding: nearest multiple of 8, never below 90 %."""
    filters *= width_mult
    new = max(8, int(filters + 4) // 8 * 8)
    if new < 0.9 * filters:
        new += 8
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` as XLA computes it: ``1 / (1 + exp(-x))``, each
    operation rounded to ``x``'s dtype (in bf16 this differs from the
    correctly rounded ``torch.sigmoid`` in about a third of the values),
    with the stable derivative ``y * (1 - y)`` of ``lax.logistic``. The
    forward takes no context, so the Function runs under
    ``torch.func.vmap`` (member-parallel serving)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return 1.0 / (1.0 + torch.exp(-x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y * (1.0 - y)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """``nn.swish``: ``x * sigmoid(x)``, two roundings in bf16."""
    return x * sigmoid(x)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, use_scale=True, momentum=BN_MOMENTUM)


class MBConv(nn.Module):
    def __init__(self, in_filters: int, out_filters: int, expand_ratio: int,
                 kernel: int, strides: int, drop_rate: float,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.residual = strides == 1 and in_filters == out_filters
        expanded = in_filters * expand_ratio
        if expand_ratio != 1:
            self.expand_conv = nn.Conv2d(in_filters, expanded, 1, bias=False)
            self.expand_bn = _bn(expanded)
        else:
            self.expand_conv = None
        self.depthwise_conv = nn.Conv2d(expanded, expanded, kernel,
                                        stride=strides, groups=expanded,
                                        bias=False)
        self.depthwise_bn = _bn(expanded)
        se_filters = max(1, int(in_filters * SE_RATIO))
        self.se_reduce = nn.Conv2d(expanded, se_filters, 1)
        self.se_expand = nn.Conv2d(se_filters, expanded, 1)
        self.project_conv = nn.Conv2d(expanded, out_filters, 1, bias=False)
        self.project_bn = _bn(out_filters)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        dt = self.dtype
        inputs = x
        if self.expand_conv is not None:
            x = swish(self.expand_bn(conv(x, self.expand_conv, dt),
                                     train)).to(dt)
        x = swish(self.depthwise_bn(conv(x, self.depthwise_conv, dt),
                                    train)).to(dt)
        se = at_least_f32(x).mean(dim=(2, 3), keepdim=True).to(dt)
        se = swish(conv(se, self.se_reduce, dt))
        se = conv(se, self.se_expand, dt)
        x = x * sigmoid(se)
        x = self.project_bn(conv(x, self.project_conv, dt), train).to(dt)
        if not self.residual:
            return x
        if train and self.drop_rate > 0.0:
            keep = 1.0 - self.drop_rate
            mask = (uniform((x.shape[0], 1, 1, 1), generator, x.device)
                    < keep).to(x.dtype)
            x = x * mask / keep
        return x + inputs


class EfficientNet(nn.Module):
    """``forward(x) -> (logits, None)`` on NCHW float input in [-1, 1];
    ``generator`` drives train-mode stochastic depth and dropout."""

    def __init__(self, num_classes: int = 1, width_mult: float = 1.0,
                 depth_mult: float = 1.0, dropout_rate: float = 0.2,
                 drop_connect_rate: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 blocks: tuple = B0_BLOCKS):
        super().__init__()
        self.dtype = dtype
        stem = round_filters(32, width_mult)
        self.stem_conv = nn.Conv2d(3, stem, 3, stride=2, bias=False)
        self.stem_bn = _bn(stem)
        total = sum(round_repeats(r, depth_mult) for *_, r in blocks)
        self.block_names = []
        in_filters = stem
        for stage, (expand, kernel, stride, out_b0, repeats_b0) in enumerate(
                blocks):
            out_filters = round_filters(out_b0, width_mult)
            for rep in range(round_repeats(repeats_b0, depth_mult)):
                name = f"stage{stage + 1}_block{rep + 1}"
                self.add_module(name, MBConv(
                    in_filters, out_filters, expand, kernel,
                    stride if rep == 0 else 1,
                    drop_connect_rate * len(self.block_names) / total, dtype))
                self.block_names.append(name)
                in_filters = out_filters
        head = round_filters(1280, width_mult)
        self.head_conv = nn.Conv2d(in_filters, head, 1, bias=False)
        self.head_bn = _bn(head)
        self.dropout_rate = dropout_rate
        self.Logits = Dense(head, num_classes)

    @classmethod
    def b4(cls, **kw) -> "EfficientNet":
        return cls(width_mult=1.4, depth_mult=1.8, **kw)

    def forward(self, x: torch.Tensor, with_aux: bool = False,
                train: bool = False,
                generator: "torch.Generator | None" = None):
        dt = self.dtype
        x = swish(self.stem_bn(conv(x.to(dt), self.stem_conv, dt),
                               train)).to(dt)
        for name in self.block_names:
            x = self._modules[name](x, train, generator)
        x = swish(self.head_bn(conv(x, self.head_conv, dt), train))
        x = head_mean(x)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.Logits(x), None
