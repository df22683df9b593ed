"""Model zoo behind ``build(model_cfg)`` (counterpart of
``jama16_retina_tpu/models/__init__.py``).

Every model has the call contract ``model(x) -> (logits, aux_logits)``
on NCHW float input; ``aux_logits`` is None unless asked for, and always
for the archs without an aux head (``model.aux_head`` is read by
Inception-v3 only). ``model.head`` sets the width of the logits: 1 for
``binary``, 5 for ``multi``.
"""

from __future__ import annotations

import torch
from torch import nn

from jama16_retina_tpu_torch.configs import ModelConfig
from jama16_retina_tpu_torch.models.common import DTYPES, BatchNorm
from jama16_retina_tpu_torch.models.efficientnet import EfficientNet
from jama16_retina_tpu_torch.models.inception_v3 import InceptionV3
from jama16_retina_tpu_torch.models.resnet import ResNet50
from jama16_retina_tpu_torch.models.tiny_cnn import TinyCNN


def build(cfg: ModelConfig, mesh=None) -> nn.Module:
    """The model named by ``cfg.arch``, in eval mode, on the CPU. A data
    mesh of more than one rank (``parallel.mesh.Mesh``; the reference's
    ``axis_name``) goes to every ``BatchNorm``, whose train moments are
    then the global batch's."""
    common = dict(num_classes=cfg.num_classes,
                  dropout_rate=cfg.dropout_rate,
                  dtype=DTYPES[cfg.compute_dtype])
    if cfg.arch == "inception_v3":
        model = InceptionV3(aux_head=cfg.aux_head,
                            image_size=cfg.image_size, **common)
    elif cfg.arch == "resnet50":
        model = ResNet50(**common)
    elif cfg.arch == "efficientnet_b4":
        model = EfficientNet.b4(**common)
    elif cfg.arch == "tiny_cnn":
        model = TinyCNN(**common)
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    if mesh is not None and mesh.size > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mesh = mesh
    return model.eval()


def dropout_shapes(model: nn.Module, batch: int) -> "list[tuple]":
    """Shapes of the uniform draws one train forward of ``batch`` images
    makes, in its order: EfficientNet's stochastic depth (one per image
    in each residual block with a drop rate), then the head's dropout.
    A ``models.common.Draws`` of these replaces the forward's
    generator."""
    shapes = []
    if isinstance(model, EfficientNet):
        for name in model.block_names:
            block = model._modules[name]
            if block.residual and block.drop_rate > 0.0:
                shapes.append((batch, 1, 1, 1))
    if model.dropout_rate > 0.0:
        shapes.append((batch, model.Logits.in_features))
    return shapes


def head_probs(logits: torch.Tensor, head: str) -> torch.Tensor:
    """Probabilities of one head (``train_lib._probs`` of the JAX
    package): sigmoid of column 0 ([B]) for ``binary``, softmax over the
    classes ([B, C]) for ``multi``."""
    if head == "binary":
        return torch.sigmoid(logits[:, 0])
    return torch.softmax(logits, dim=-1)
