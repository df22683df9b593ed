"""Inception-v3 in eval and train form (counterpart of
``jama16_retina_tpu/models/inception_v3.py``).

Tensors are NCHW in ``channels_last`` memory, so every branch concat is
on dim 1 in the Flax block's ``axis=-1`` order. Module names are the
Flax scope names (``Mixed_5b.Branch_0_Conv2d_0a_1x1`` ...), which is
what lets ``models/convert.py`` carry a Flax tree across by renaming.

With ``dtype=bfloat16`` the input is cast to bf16, convs and BN outputs
are bf16, and the head (spatial mean, dropout, Dense) is float32, as in
the Flax module (``common.head_mean`` repeats where Flax rounds the
mean).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jama16_retina_tpu_torch.models.common import (ConvBN, Dense,
                                                   at_least_f32, dropout,
                                                   head_mean)


def _valid_counts(h: int, w: int, dtype, device) -> torch.Tensor:
    """[1, 1, h, w] number of in-bounds cells of each 3x3 window."""
    def n(size):
        return torch.tensor([min(i + 1, size - 1) - max(i - 1, 0) + 1
                             for i in range(size)], dtype=dtype,
                            device=device)
    return (n(h)[:, None] * n(w)[None, :])[None, None]


class _AvgPoolSame(torch.autograd.Function):
    """3x3 stride-1 SAME average over the valid (non-padded) cells only,
    as TF/slim AvgPool computes it. The forward is
    ``F.avg_pool2d(count_include_pad=False)``; the backward is its adjoint
    written out (each output gradient divided by its window's cell count,
    summed back over the 3x3 window, in float32 or wider): PyTorch 2.11's CUDA
    backward of that call on channels_last input returns wrong gradients
    (``tests/test_torch_gpu.py`` pins the port's against the CPU's).

    The forward takes no context (``setup_context`` records the spatial
    size), so the Function runs under ``torch.func.vmap``, with the
    vmap rule PyTorch derives from the forward: the member-parallel
    serving form (``serve.member_parallel``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hw = tuple(inputs[0].shape[2:])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        gf = at_least_f32(g)
        gd = F.pad(gf / _valid_counts(h, w, gf.dtype, g.device),
                   (1, 1, 1, 1))
        out = gd[:, :, 0:h, 0:w]
        for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1),
                     (2, 2)):
            out = out + gd[:, :, i:i + h, j:j + w]
        out = out.to(g.dtype)
        if torch._C._functorch.is_batchedtensor(out):
            # Under vmap (the stacked-member step) the layout is the
            # batching rule's; a memory-format query is not allowed there.
            return out
        return out.contiguous(memory_format=torch.channels_last)


_avg_pool_same = _AvgPoolSame.apply


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block whose ConvBN cells are registered under their Flax scope
    names; ``chain`` runs one branch, given as module names and pools,
    in eval or train form."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self._dtype = dtype

    def cbn(self, name: str, cin: int, features: int, kernel,
            strides=(1, 1), padding: str = "SAME") -> str:
        self.add_module(name, ConvBN(cin, features, kernel, strides, padding,
                                     dtype=self._dtype))
        return name

    def chain(self, x: torch.Tensor, train: bool, *steps) -> torch.Tensor:
        for step in steps:
            x = (self._modules[step](x, train) if isinstance(step, str)
                 else step(x))
        return x


class InceptionA(_Block):
    """35x35 block (Mixed_5b/5c/5d): 1x1 / 5x5 / double-3x3 / pool."""

    def __init__(self, in_channels: int, pool_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_channels
        self.branches = (
            (self.cbn("Branch_0_Conv2d_0a_1x1", c, 64, (1, 1)),),
            (self.cbn("Branch_1_Conv2d_0a_1x1", c, 48, (1, 1)),
             self.cbn("Branch_1_Conv2d_0b_5x5", 48, 64, (5, 5))),
            (self.cbn("Branch_2_Conv2d_0a_1x1", c, 64, (1, 1)),
             self.cbn("Branch_2_Conv2d_0b_3x3", 64, 96, (3, 3)),
             self.cbn("Branch_2_Conv2d_0c_3x3", 96, 96, (3, 3))),
            (_avg_pool_same,
             self.cbn("Branch_3_Conv2d_0b_1x1", c, pool_features, (1, 1))),
        )

    def forward(self, x, train: bool = False):
        return torch.cat([self.chain(x, train, *b) for b in self.branches],
                         dim=1)


class InceptionB(_Block):
    """35->17 grid reduction (Mixed_6a)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_channels
        self.branches = (
            (self.cbn("Branch_0_Conv2d_1a_3x3", c, 384, (3, 3), (2, 2),
                      "VALID"),),
            (self.cbn("Branch_1_Conv2d_0a_1x1", c, 64, (1, 1)),
             self.cbn("Branch_1_Conv2d_0b_3x3", 64, 96, (3, 3)),
             self.cbn("Branch_1_Conv2d_1a_3x3", 96, 96, (3, 3), (2, 2),
                      "VALID")),
            (_max_pool_valid,),
        )

    def forward(self, x, train: bool = False):
        return torch.cat([self.chain(x, train, *b) for b in self.branches],
                         dim=1)


class InceptionC(_Block):
    """17x17 block with factorized 7x7 (Mixed_6b..6e)."""

    def __init__(self, in_channels: int, channels_7x7: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c, c7 = in_channels, channels_7x7
        self.branches = (
            (self.cbn("Branch_0_Conv2d_0a_1x1", c, 192, (1, 1)),),
            (self.cbn("Branch_1_Conv2d_0a_1x1", c, c7, (1, 1)),
             self.cbn("Branch_1_Conv2d_0b_1x7", c7, c7, (1, 7)),
             self.cbn("Branch_1_Conv2d_0c_7x1", c7, 192, (7, 1))),
            (self.cbn("Branch_2_Conv2d_0a_1x1", c, c7, (1, 1)),
             self.cbn("Branch_2_Conv2d_0b_7x1", c7, c7, (7, 1)),
             self.cbn("Branch_2_Conv2d_0c_1x7", c7, c7, (1, 7)),
             self.cbn("Branch_2_Conv2d_0d_7x1", c7, c7, (7, 1)),
             self.cbn("Branch_2_Conv2d_0e_1x7", c7, 192, (1, 7))),
            (_avg_pool_same,
             self.cbn("Branch_3_Conv2d_0b_1x1", c, 192, (1, 1))),
        )

    def forward(self, x, train: bool = False):
        return torch.cat([self.chain(x, train, *b) for b in self.branches],
                         dim=1)


class InceptionD(_Block):
    """17->8 grid reduction (Mixed_7a)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_channels
        self.branches = (
            (self.cbn("Branch_0_Conv2d_0a_1x1", c, 192, (1, 1)),
             self.cbn("Branch_0_Conv2d_1a_3x3", 192, 320, (3, 3), (2, 2),
                      "VALID")),
            (self.cbn("Branch_1_Conv2d_0a_1x1", c, 192, (1, 1)),
             self.cbn("Branch_1_Conv2d_0b_1x7", 192, 192, (1, 7)),
             self.cbn("Branch_1_Conv2d_0c_7x1", 192, 192, (7, 1)),
             self.cbn("Branch_1_Conv2d_1a_3x3", 192, 192, (3, 3), (2, 2),
                      "VALID")),
            (_max_pool_valid,),
        )

    def forward(self, x, train: bool = False):
        return torch.cat([self.chain(x, train, *b) for b in self.branches],
                         dim=1)


class InceptionE(_Block):
    """8x8 block with expanded filter-bank splits (Mixed_7b/7c)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_channels
        self.b1 = (self.cbn("Branch_0_Conv2d_0a_1x1", c, 320, (1, 1)),)
        self.b3 = (self.cbn("Branch_1_Conv2d_0a_1x1", c, 384, (1, 1)),)
        self.b3_split = (
            self.cbn("Branch_1_Conv2d_0b_1x3", 384, 384, (1, 3)),
            self.cbn("Branch_1_Conv2d_0c_3x1", 384, 384, (3, 1)),
        )
        self.bd = (self.cbn("Branch_2_Conv2d_0a_1x1", c, 448, (1, 1)),
                   self.cbn("Branch_2_Conv2d_0b_3x3", 448, 384, (3, 3)))
        self.bd_split = (
            self.cbn("Branch_2_Conv2d_0c_1x3", 384, 384, (1, 3)),
            self.cbn("Branch_2_Conv2d_0d_3x1", 384, 384, (3, 1)),
        )
        self.bp = (_avg_pool_same,
                   self.cbn("Branch_3_Conv2d_0b_1x1", c, 192, (1, 1)))

    def forward(self, x, train: bool = False):
        b3 = self.chain(x, train, *self.b3)
        bd = self.chain(x, train, *self.bd)
        return torch.cat([
            self.chain(x, train, *self.b1),
            torch.cat([self.chain(b3, train, s) for s in self.b3_split],
                      dim=1),
            torch.cat([self.chain(bd, train, s) for s in self.bd_split],
                      dim=1),
            self.chain(x, train, *self.bp),
        ], dim=1)


class AuxHead(nn.Module):
    """Auxiliary classifier off Mixed_6e; ``map_size`` is the spatial
    size of its input (17 at 299 px), which fixes the second conv's
    kernel as in the Flax module (kernel = pooled map size)."""

    def __init__(self, in_channels: int, map_size: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        pooled = (map_size - 5) // 3 + 1
        if pooled < 1:
            raise ValueError(
                f"aux head needs a Mixed_6e map of at least 5x5, got "
                f"{map_size}x{map_size}; raise model.image_size or set "
                "model.aux_head=false"
            )
        self.Conv2d_1b_1x1 = ConvBN(in_channels, 128, (1, 1), dtype=dtype)
        self.Conv2d_2a_5x5 = ConvBN(128, 768, (pooled, pooled),
                                    padding="VALID", dtype=dtype)
        self.Logits = Dense(768, num_classes)

    def forward(self, x, train: bool = False):
        x = F.avg_pool2d(x, 5, 3)
        x = self.Conv2d_2a_5x5(self.Conv2d_1b_1x1(x, train), train)
        return self.Logits(head_mean(x))


def mixed_6e_size(image_size: int) -> int:
    """Spatial size of the 17x17 stage for a given input size."""
    s = (image_size - 3) // 2 + 1   # Conv2d_1a_3x3, stride 2 VALID
    s = s - 2                       # Conv2d_2a_3x3 VALID (2b is SAME)
    s = (s - 3) // 2 + 1            # max pool
    s = s - 2                       # Conv2d_4a_3x3 VALID (3b is 1x1)
    s = (s - 3) // 2 + 1            # max pool -> 35x35 blocks
    return (s - 3) // 2 + 1         # Mixed_6a


class InceptionV3(nn.Module):
    """The flagship backbone: ``forward(x) -> (logits, aux_logits)``.

    ``x`` is NCHW float in [-1, 1]. The aux head's logits are computed
    only when ``with_aux=True`` or ``train=True`` (serving never reads
    them); otherwise ``aux_logits`` is None, as XLA drops the unused
    branch on the JAX side. ``generator`` drives train-mode dropout."""

    def __init__(self, num_classes: int = 1, aux_head: bool = True,
                 dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 299):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), (2, 2), "VALID", **kw)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3), padding="VALID", **kw)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), **kw)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1), padding="VALID", **kw)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3), padding="VALID", **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.AuxLogits = (
            AuxHead(768, mixed_6e_size(image_size), num_classes, **kw)
            if aux_head else None
        )
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, **kw)
        self.Mixed_7c = InceptionE(2048, **kw)
        self.dropout_rate = dropout_rate
        self.Logits = Dense(2048, num_classes)

    def forward(self, x: torch.Tensor, with_aux: bool = False,
                train: bool = False,
                generator: "torch.Generator | None" = None):
        x = x.to(self.dtype)
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = getattr(self, name)(x, train)
        x = _max_pool_valid(x)
        for name in ("Conv2d_3b_1x1", "Conv2d_4a_3x3"):
            x = getattr(self, name)(x, train)
        x = _max_pool_valid(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x, train)
        aux = (self.AuxLogits(x, train)
               if (with_aux or train) and self.AuxLogits is not None
               else None)
        for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x, train)
        x = head_mean(x)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.Logits(x), aux
