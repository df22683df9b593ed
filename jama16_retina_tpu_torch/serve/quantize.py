"""The serving dtype (counterpart of ``jama16_retina_tpu/serve/quantize.py``):
the weights each member keeps on the device.

  * ``fp32``: the parameters as loaded.
  * ``bf16``: every floating parameter (the BatchNorm scales and biases
    and the Dense heads' too) cast to bfloat16; the BatchNorm running
    statistics, which are buffers, stay float32. The models compute
    from them as under ``train.dtype=bf16``: the convs were cast to the
    compute dtype anyway, BatchNorm's float32 arithmetic promotes a
    bf16 scale and bias, and ``models/common.Dense`` casts its weight
    and bias to its float32 input.
  * ``int8``: every floating parameter of rank >= 2 (conv and Dense
    weights, depthwise convs included) becomes :class:`Q8`, int8 values
    and float32 scales, one scale per output channel; biases and
    BatchNorm parameters stay float32. ``dequantize`` (``q.float() *
    s``) runs inside each forward, so the device holds int8 plus scales
    and no full-width copy of the weights outlives a forward.

The int8 numerics are those the JAX package runs through AQT
(``aqt_quantizer.quantizer_make(8)``), not its hand-written fallback
(``amax / 127``): ``amax`` is the largest magnitude over every axis but
the output channel (a zero ``amax`` counts as 1), ``s = amax / 127.5``,
and ``q = round_half_even(clip(w * (1 / s), -127, 127))``, multiplying
by the reciprocal as AQT does. The port's weights keep the output
channel on dim 0 (``[O, I, kh, kw]``, Dense ``[O, I]``, depthwise
``[C, 1, kh, kw]``) where Flax keeps it last, so ``s`` has shape
``[O, 1, ...]``; ``q`` and ``s`` equal the reference's bitwise after
``models/convert``'s transpose.

A bf16 or int8 engine with a pinned golden canary must score it within
``serve.dtype_canary_max_dev`` of the pinned scores, or its construction
raises :class:`DtypeRejected` (``serve/engine.py``).
"""

from __future__ import annotations

import dataclasses

import torch

SERVE_DTYPES = ("fp32", "bf16", "int8")


class DtypeRejected(RuntimeError):
    """A bf16 or int8 engine failed its golden-canary construction gate:
    its scores deviate from the pinned ones by more than
    ``serve.dtype_canary_max_dev``, so it never takes a request."""


@dataclasses.dataclass(frozen=True)
class Q8:
    """One int8 weight: values ``q`` and float32 per-output-channel
    scales ``s`` (``[O, 1, ...]``, broadcastable to ``q``)."""

    q: torch.Tensor
    s: torch.Tensor


def check_dtype(dtype: str) -> str:
    if dtype not in SERVE_DTYPES:
        raise ValueError(f"unknown serve.dtype {dtype!r}; choose one of "
                         f"{'/'.join(SERVE_DTYPES)}")
    return dtype


def quantize_weight(w: torch.Tensor) -> Q8:
    """Symmetric int8 of one weight with its output channel on dim 0:
    one scale per output channel (AQT's numerics, above)."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    s = amax / 127.5
    inv = torch.reciprocal(s)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    q = torch.round(torch.clamp(w * inv, -127.0, 127.0)).to(torch.int8)
    return Q8(q=q, s=s)


def params_for_dtype(params: "dict[str, torch.Tensor]",
                     dtype: str) -> dict:
    """A member's parameters (not its BatchNorm statistics) as the engine
    keeps them at ``dtype`` (the reference's ``state_for_dtype``)."""
    check_dtype(dtype)
    if dtype == "fp32":
        return dict(params)
    if dtype == "bf16":
        return {k: (p.to(torch.bfloat16) if p.is_floating_point() else p)
                for k, p in params.items()}
    return {k: (quantize_weight(p) if p.is_floating_point() and p.ndim >= 2
                else p)
            for k, p in params.items()}


def dequantize(params: dict) -> "dict[str, torch.Tensor]":
    """The tensors a forward computes from (the reference's
    ``dequant_transform``): every :class:`Q8` as ``q.float() * s``."""
    return {k: (p.q.float() * p.s if isinstance(p, Q8) else p)
            for k, p in params.items()}


def stack(members: "list[dict]") -> dict:
    """k members' parameter dicts stacked on a leading member dim (Q8
    values and scales each), as ``torch.func.stack_module_state``
    stacks modules: the member-parallel form's weights."""
    out = {}
    for k, first in members[0].items():
        if isinstance(first, Q8):
            out[k] = Q8(q=torch.stack([m[k].q for m in members]),
                        s=torch.stack([m[k].s for m in members]))
        else:
            out[k] = torch.stack([m[k] for m in members])
    return out


def nbytes(params: dict) -> int:
    """Device bytes of a parameter dict (Q8: values plus scales)."""
    total = 0
    for p in params.values():
        for t in ((p.q, p.s) if isinstance(p, Q8) else (p,)):
            total += t.numel() * t.element_size()
    return total
