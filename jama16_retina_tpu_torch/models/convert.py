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
optax state of each optimizer family (moments and counts) is carried
across by the same rename and transpose (``optax_to_port`` /
``port_to_optax``).
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


# The optax state of the JAX package's optimizer families, as a flat numpy
# dict, where ``<path>`` is the Flax params key without its ``params/``
# collection (``Mixed_5b/.../conv/kernel``) and every family carries its
# schedule's count as ``schedule/count`` (``ScaleByScheduleState.count``):
#
#   adamw    (ScaleByAdamState(count, mu, nu), MaskedState(EmptyState),
#            ScaleByScheduleState): adam/count, adam/mu/<path>,
#            adam/nu/<path>
#   lamb     (ScaleByAdamState, MaskedState(EmptyState), EmptyState,
#            ScaleByScheduleState): lamb/count, lamb/mu/<path>,
#            lamb/nu/<path>
#   sgdm     (MaskedState(EmptyState), (TraceState(trace),
#            ScaleByScheduleState)): trace/<path>
#   rmsprop  (MaskedState(EmptyState), (ScaleByRmsState(nu),
#            ScaleByScheduleState, TraceState(trace))): rms/nu/<path>,
#            trace/<path>
#
# The masked and trust-ratio states, and the EmptyState that
# ``clip_by_global_norm`` chains in front, hold no arrays and add no key.
# The prefixes tell the families apart (adamw and lamb share optax's
# state type), so a checkpoint names the family that wrote it.
OPT_PREFIXES = {
    "adamw": {"mu": "adam/mu", "nu": "adam/nu"},
    "lamb": {"mu": "lamb/mu", "nu": "lamb/nu"},
    "sgdm": {"trace": "trace"},
    "rmsprop": {"nu": "rms/nu", "trace": "trace"},
}
OPT_COUNTS = {"adamw": "adam/count", "lamb": "lamb/count"}
SCHEDULE_COUNT = "schedule/count"
# Every top-level name an optimizer key may start with.
OPT_ROOTS = ("adam/", "lamb/", "rms/", "trace/", "schedule/")


def optax_family(flat: "dict[str, np.ndarray]") -> str:
    """The family whose optax state ``flat`` holds (format above)."""
    roots = {k.split("/", 1)[0] for k in flat}
    for family, root in (("adamw", "adam"), ("lamb", "lamb"),
                         ("rmsprop", "rms")):
        if root in roots:
            return family
    if "trace" in roots:
        return "sgdm"
    raise KeyError(f"no optimizer state among {sorted(roots)}")


def optax_to_port(flat: "dict[str, np.ndarray]", model: nn.Module,
                  family: str) -> dict:
    """The port's state of ``family`` from the flat optax state:
    ``{"moments": {name: {param key: tensor}}, "count": int or None,
    "sched_count": int}``, keyed like ``model.named_parameters()`` (conv
    moments HWIO -> OIHW, Dense moments transposed, as the params are).
    Every parameter must be matched exactly once per moment; any other
    key raises."""
    params = dict(model.named_parameters())
    prefixes = OPT_PREFIXES[family]
    by_prefix = {pre: name for name, pre in prefixes.items()}
    count_key = OPT_COUNTS.get(family)
    moments: dict = {name: {} for name in prefixes}
    for key, value in flat.items():
        if key in (count_key, SCHEDULE_COUNT):
            continue
        pre = next((p for p in by_prefix if key.startswith(p + "/")), None)
        path = key[len(pre) + 1:] if pre else ""
        if pre is None or not path:
            raise KeyError(f"unexpected optax state key {key!r} for "
                           f"{family}")
        name = by_prefix[pre]
        value = np.asarray(value)
        tkey, axes = _torch_key("params/" + path, value.ndim)
        if tkey not in params:
            raise KeyError(f"optax key {key!r} -> {tkey!r} has no parameter "
                           f"in {type(model).__name__}")
        if tkey in moments[name]:
            raise KeyError(f"two optax keys map to {name} of {tkey!r}")
        arr = np.array(value.transpose(axes) if axes else value,
                       np.float32, order="C")
        if arr.shape != tuple(params[tkey].shape):
            raise ValueError(f"{key!r}: shape {value.shape} does not fit "
                             f"{tkey!r} {tuple(params[tkey].shape)}")
        moments[name][tkey] = torch.from_numpy(arr)
    for name in prefixes:
        missing = sorted(set(params) - set(moments[name]))
        if missing:
            raise KeyError(f"optax state lacks {name} of {len(missing)} "
                           f"parameter(s), e.g. {missing[:3]}")
    return {"moments": moments,
            "count": None if count_key is None else int(flat[count_key]),
            "sched_count": int(flat[SCHEDULE_COUNT])}


def port_to_optax(family: str, moments: dict, count: "int | None",
                  sched_count: int) -> "dict[str, np.ndarray]":
    """The flat optax state (format above) of the port's state of
    ``family``: ``moments`` maps each of its names to a dict keyed like
    ``model.named_parameters()``."""
    flat = {SCHEDULE_COUNT: np.asarray(sched_count, np.int32)}
    if family in OPT_COUNTS:
        flat[OPT_COUNTS[family]] = np.asarray(count, np.int32)
    for name, pre in OPT_PREFIXES[family].items():
        for tkey, tensor in moments[name].items():
            arr = torch.as_tensor(tensor).detach().cpu().float().numpy()
            fkey, axes = _flax_key(tkey, arr.ndim)
            flat[f"{pre}/" + fkey.split("/", 1)[1]] = (
                np.ascontiguousarray(arr.transpose(axes) if axes else arr))
    return flat
