"""Weights carried between a Flax variable tree and a port model.

The Flax side is the flat dict ``flax.traverse_util.flatten_dict(
variables, sep="/")`` gives, as numpy arrays:

    params/<scope>/conv/kernel       HWIO   -> <scope>.conv.weight  OIHW
    params/<scope>/bn/bias                  -> <scope>.bn.bias
    params/<scope>/bn/scale                 -> <scope>.bn.scale
    batch_stats/<scope>/bn/mean|var         -> <scope>.bn.mean|var
    params/<scope>/kernel (Dense)    [in,out] -> <scope>.weight  [out,in]
    params/<scope>/bias (Dense, conv)       -> <scope>.bias

Depthwise kernels ``(k, k, 1, C)`` take the same transpose as any conv
kernel, to torch's ``(C, 1, k, k)``.

The port's modules carry the Flax scope names, so the mapping is a
rename plus a transpose. Every key on either side must be matched:
an unmatched or missing key, or a shape that disagrees, raises. The
optax AdamW state (moments and counts) is carried across by the same
rename and transpose (``optax_adamw_to_port`` / ``port_to_optax_adamw``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _torch_key(flax_key: str, ndim: int) -> "tuple[str, tuple | None]":
    """Flax key -> (torch key, axes to transpose by, or None)."""
    coll, *path, leaf = flax_key.split("/")
    if coll == "batch_stats" and leaf in ("mean", "var"):
        return ".".join(path + [leaf]), None
    if coll != "params":
        raise KeyError(f"unexpected Flax collection in {flax_key!r}")
    if leaf in ("bias", "scale"):
        return ".".join(path + [leaf]), None
    if leaf == "kernel" and ndim == 4:
        return ".".join(path + ["weight"]), (3, 2, 0, 1)
    if leaf == "kernel" and ndim == 2:
        return ".".join(path + ["weight"]), (1, 0)
    raise KeyError(f"cannot map Flax leaf {flax_key!r} (ndim {ndim})")


def flax_to_torch(flat: "dict[str, np.ndarray]",
                  model: nn.Module) -> "dict[str, torch.Tensor]":
    """A ``state_dict`` for ``model`` from a flat Flax tree."""
    want = model.state_dict()
    out: dict = {}
    for key, value in flat.items():
        value = np.asarray(value)
        tkey, axes = _torch_key(key, value.ndim)
        if tkey not in want:
            raise KeyError(f"Flax key {key!r} -> {tkey!r} has no match in "
                           f"{type(model).__name__}")
        if tkey in out:
            raise KeyError(f"two Flax keys map to {tkey!r}")
        arr = np.ascontiguousarray(
            value.transpose(axes) if axes else value, np.float32)
        if tuple(arr.shape) != tuple(want[tkey].shape):
            raise ValueError(
                f"{key!r}: shape {value.shape} does not fit {tkey!r} "
                f"{tuple(want[tkey].shape)}"
            )
        out[tkey] = torch.from_numpy(arr)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"Flax tree lacks {len(missing)} key(s) of "
                       f"{type(model).__name__}, e.g. {missing[:3]}")
    return out


def _flax_key(tkey: str, ndim: int) -> "tuple[str, tuple | None]":
    """Port key -> (Flax key, axes to transpose by, or None)."""
    *path, leaf = tkey.split(".")
    if leaf in ("mean", "var"):
        return "/".join(["batch_stats", *path, leaf]), None
    if leaf in ("bias", "scale"):
        return "/".join(["params", *path, leaf]), None
    if leaf == "weight" and ndim == 4:
        return "/".join(["params", *path, "kernel"]), (2, 3, 1, 0)
    if leaf == "weight" and ndim == 2:
        return "/".join(["params", *path, "kernel"]), (1, 0)
    raise KeyError(f"cannot map port key {tkey!r} to a Flax leaf")


def torch_to_flax(state: "nn.Module | dict") -> "dict[str, np.ndarray]":
    """The flat Flax tree of a port model (or of its ``state_dict``)."""
    sd = state.state_dict() if isinstance(state, nn.Module) else state
    flat: dict = {}
    for tkey, tensor in sd.items():
        arr = tensor.detach().cpu().float().numpy()
        fkey, axes = _flax_key(tkey, arr.ndim)
        flat[fkey] = np.ascontiguousarray(arr.transpose(axes) if axes else arr)
    return flat


# The optax adamw state of the JAX package, ``(ScaleByAdamState(count, mu,
# nu), MaskedState(EmptyState), ScaleByScheduleState(count))``, as a flat
# numpy dict: ``adam/count``, ``adam/mu/<params path>``, ``adam/nu/<params
# path>`` and ``schedule/count``, where ``<params path>`` is the Flax key
# without its ``params/`` collection (``Mixed_5b/.../conv/kernel``). The
# masked state holds no arrays.


def optax_adamw_to_port(flat: "dict[str, np.ndarray]", model: nn.Module,
                        ) -> dict:
    """The port's AdamW state from the flat optax state: ``{"mu": ...,
    "nu": ...}`` keyed like ``model.named_parameters()`` (conv moments
    HWIO -> OIHW, Dense moments transposed, as the params are), and the
    ``count`` and ``sched_count`` ints. Every parameter must be matched
    exactly once; anything else raises."""
    params = dict(model.named_parameters())
    out: dict = {"mu": {}, "nu": {}}
    for key, value in flat.items():
        if key in ("adam/count", "schedule/count"):
            continue
        group, _, path = key.partition("/")
        moment, _, path = path.partition("/")
        if group != "adam" or moment not in ("mu", "nu") or not path:
            raise KeyError(f"unexpected optax state key {key!r}")
        value = np.asarray(value)
        tkey, axes = _torch_key("params/" + path, value.ndim)
        if tkey not in params:
            raise KeyError(f"optax key {key!r} -> {tkey!r} has no parameter "
                           f"in {type(model).__name__}")
        if tkey in out[moment]:
            raise KeyError(f"two optax keys map to {moment} of {tkey!r}")
        arr = np.array(value.transpose(axes) if axes else value,
                       np.float32, order="C")
        if arr.shape != tuple(params[tkey].shape):
            raise ValueError(f"{key!r}: shape {value.shape} does not fit "
                             f"{tkey!r} {tuple(params[tkey].shape)}")
        out[moment][tkey] = torch.from_numpy(arr)
    for moment in ("mu", "nu"):
        missing = sorted(set(params) - set(out[moment]))
        if missing:
            raise KeyError(f"optax state lacks {moment} of {len(missing)} "
                           f"parameter(s), e.g. {missing[:3]}")
    out["count"] = int(flat["adam/count"])
    out["sched_count"] = int(flat["schedule/count"])
    return out


def port_to_optax_adamw(mu: dict, nu: dict, count: int,
                        sched_count: int) -> "dict[str, np.ndarray]":
    """The flat optax state (format above) of the port's AdamW state."""
    flat = {"adam/count": np.asarray(count, np.int32),
            "schedule/count": np.asarray(sched_count, np.int32)}
    for moment, tree in (("mu", mu), ("nu", nu)):
        for tkey, tensor in tree.items():
            arr = torch.as_tensor(tensor).detach().cpu().float().numpy()
            fkey, axes = _flax_key(tkey, arr.ndim)
            flat[f"adam/{moment}/" + fkey.split("/", 1)[1]] = (
                np.ascontiguousarray(arr.transpose(axes) if axes else arr))
    return flat
