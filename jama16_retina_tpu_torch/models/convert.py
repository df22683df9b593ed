"""Weights carried between a Flax variable tree and a port model.

The Flax side is the flat dict ``flax.traverse_util.flatten_dict(
variables, sep="/")`` gives, as numpy arrays:

    params/<scope>/conv/kernel       HWIO   -> <scope>.conv.weight  OIHW
    params/<scope>/bn/bias                  -> <scope>.bn.bias
    batch_stats/<scope>/bn/mean|var         -> <scope>.bn.mean|var
    params/<scope>/kernel (Dense)    [in,out] -> <scope>.weight  [out,in]
    params/<scope>/bias (Dense)             -> <scope>.bias

The port's modules carry the Flax scope names, so the mapping is a
rename plus a transpose. Every key on either side must be matched:
an unmatched or missing key, or a shape that disagrees, raises.
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
    if leaf == "bias":
        return ".".join(path + ["bias"]), None
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


def torch_to_flax(state: "nn.Module | dict") -> "dict[str, np.ndarray]":
    """The flat Flax tree of a port model (or of its ``state_dict``)."""
    sd = state.state_dict() if isinstance(state, nn.Module) else state
    flat: dict = {}
    for tkey, tensor in sd.items():
        arr = tensor.detach().cpu().float().numpy()
        *path, leaf = tkey.split(".")
        if leaf in ("mean", "var"):
            fkey, axes = "/".join(["batch_stats", *path, leaf]), None
        elif leaf == "bias":
            fkey, axes = "/".join(["params", *path, "bias"]), None
        elif leaf == "weight" and arr.ndim == 4:
            fkey, axes = "/".join(["params", *path, "kernel"]), (2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            fkey, axes = "/".join(["params", *path, "kernel"]), (1, 0)
        else:
            raise KeyError(f"cannot map port key {tkey!r} to a Flax leaf")
        flat[fkey] = np.ascontiguousarray(arr.transpose(axes) if axes else arr)
    return flat
