"""Tiny CNN for tests and smoke runs (counterpart of
``jama16_retina_tpu/models/tiny_cnn.py``; the ``smoke`` preset's arch)."""

from __future__ import annotations

import torch
from torch import nn

from jama16_retina_tpu_torch.models.common import (ConvBN, Dense, dropout,
                                                   head_mean)


class TinyCNN(nn.Module):
    def __init__(self, num_classes: int = 1, dropout_rate: float = 0.1,
                 features: tuple = (16, 32, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, f in enumerate(features):
            self.add_module(f"conv{i}", ConvBN(cin, f, (3, 3), (2, 2),
                                               dtype=dtype))
            cin = f
        self.n_convs = len(features)
        self.dropout_rate = dropout_rate
        self.Logits = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, with_aux: bool = False,
                train: bool = False,
                generator: "torch.Generator | None" = None):
        x = x.to(self.dtype)
        for i in range(self.n_convs):
            x = self._modules[f"conv{i}"](x, train)
        x = head_mean(x)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.Logits(x), None
