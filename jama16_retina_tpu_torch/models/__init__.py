"""Model zoo behind ``build(model_cfg)`` (counterpart of
``jama16_retina_tpu/models/__init__.py``).

Every model has the call contract ``model(x) -> (logits, aux_logits)``
on NCHW float input; ``aux_logits`` is None unless asked for.
"""

from __future__ import annotations

from torch import nn

from jama16_retina_tpu_torch.configs import ModelConfig
from jama16_retina_tpu_torch.models.common import DTYPES
from jama16_retina_tpu_torch.models.inception_v3 import InceptionV3
from jama16_retina_tpu_torch.models.tiny_cnn import TinyCNN


def build(cfg: ModelConfig) -> nn.Module:
    """The model named by ``cfg.arch``, in eval mode, on the CPU."""
    if cfg.head != "binary":
        raise NotImplementedError(
            f"model.head={cfg.head!r} is not ported yet; see ROADMAP.md "
            "Queue A item 10 (head=multi)"
        )
    dtype = DTYPES[cfg.compute_dtype]
    if cfg.arch == "inception_v3":
        model = InceptionV3(
            num_classes=cfg.num_classes, aux_head=cfg.aux_head,
            dropout_rate=cfg.dropout_rate, dtype=dtype,
            image_size=cfg.image_size,
        )
    elif cfg.arch == "tiny_cnn":
        model = TinyCNN(num_classes=cfg.num_classes,
                        dropout_rate=cfg.dropout_rate, dtype=dtype)
    else:
        raise NotImplementedError(
            f"model.arch={cfg.arch!r} is not ported yet; see ROADMAP.md "
            "Queue A item 10"
        )
    return model.eval()
