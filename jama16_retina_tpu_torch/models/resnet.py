"""ResNet-50 in eval and train form (counterpart of
``jama16_retina_tpu/models/resnet.py``): a 7x7/2 stem, a SAME 3x3/2 max
pool, and 3-4-6-3 bottleneck stages of expansion 4.

Every BatchNorm has a learned scale and momentum 0.9 and outputs
float32. The dtype flow is the Flax module's: ``relu(bn).to(dtype)``
after bn1 and bn2; bn3 stays float32 and is added to the residual in
float32 (the residual is the compute dtype for an identity shortcut and
float32 after ``bn_proj``); then ReLU and a cast to the compute dtype.
The head (spatial mean, dropout, Dense) is float32. Module names are the
Flax scope names (``stage2_block1.conv_proj`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jama16_retina_tpu_torch.models.common import (BatchNorm, Dense, conv,
                                                   dropout, head_mean,
                                                   max_pool_same)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (``strides``) -> 1x1 x4, with a projection shortcut
    (``conv_proj`` + ``bn_proj``) where the width or the stride
    changes."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        out = 4 * features
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features, use_scale=True)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides,
                               bias=False)
        self.bn2 = BatchNorm(features, use_scale=True)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, use_scale=True)
        if in_channels != out or strides != 1:
            self.conv_proj = nn.Conv2d(in_channels, out, 1, stride=strides,
                                       bias=False)
            self.bn_proj = BatchNorm(out, use_scale=True)
        else:
            self.conv_proj = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv(x, self.conv1, dt), train)).to(dt)
        y = F.relu(self.bn2(conv(y, self.conv2, dt), train)).to(dt)
        y = self.bn3(conv(y, self.conv3, dt), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.bn_proj(conv(x, self.conv_proj, dt), train)
        return F.relu(y + residual).to(dt)


class ResNet50(nn.Module):
    """``forward(x) -> (logits, None)`` on NCHW float input in [-1, 1];
    ``generator`` drives train-mode dropout. ``stage_sizes`` sets the
    blocks per stage (tests shrink it)."""

    def __init__(self, num_classes: int = 1, dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 stage_sizes: tuple = (3, 4, 6, 3)):
        super().__init__()
        self.dtype = dtype
        self.conv_init = nn.Conv2d(3, 64, 7, stride=2, bias=False)
        self.bn_init = BatchNorm(64, use_scale=True)
        cin = 64
        self.block_names = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(
                    cin, 64 * 2**i, 2 if i > 0 and j == 0 else 1, dtype))
                self.block_names.append(name)
                cin = 4 * 64 * 2**i
        self.dropout_rate = dropout_rate
        self.Logits = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, with_aux: bool = False,
                train: bool = False,
                generator: "torch.Generator | None" = None):
        x = conv(x.to(self.dtype), self.conv_init, self.dtype, (3, 3))
        x = F.relu(self.bn_init(x, train)).to(self.dtype)
        x = max_pool_same(x)
        for name in self.block_names:
            x = self._modules[name](x, train)
        x = head_mean(x)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.Logits(x), None
