"""Helpers shared by the ``test_torch_*`` parity tests.

Weights are drawn with numpy from a seed in the shapes ``jax.eval_shape``
gives for the Flax module (no init compile), then handed to both
frameworks: as a Flax variable tree, and through
``jama16_retina_tpu_torch.models.convert`` as a port ``state_dict``.
BatchNorm running statistics are random too, so eval-mode BN is not the
identity. Arrays cross between the frameworks as numpy only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from jama16_retina_tpu import train_lib


def random_flat(module, x_shape, seed: int) -> "dict[str, np.ndarray]":
    """Flat Flax tree (``params/...``, ``batch_stats/...``) of random
    float32 weights for ``module`` applied to inputs of ``x_shape``."""
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, jnp.zeros(x_shape, jnp.float32),
        train=False))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, leaf in sorted(flatten_dict(shapes, sep="/").items()):
        shape, last = leaf.shape, name.rsplit("/", 1)[1]
        if name.startswith("batch_stats/"):
            v = (rng.normal(0.0, 0.1, shape) if last == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif last == "kernel":
            # He scaling keeps activations O(1) through the ReLU stack.
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        flat[name] = v.astype(np.float32)
    return flat


def variables(flat: "dict[str, np.ndarray]") -> dict:
    """The Flax variable tree of a flat dict."""
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def stacked_state(flats: "list[dict]"):
    """The JAX engine's stacked ``TrainState`` of k flat trees."""
    states = []
    for flat in flats:
        v = variables(flat)
        states.append(train_lib.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=None))
    return train_lib.stack_states(states)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (a view)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def flat_optax_adamw(opt_state) -> "dict[str, np.ndarray]":
    """The flat numpy form of an optax adamw state that
    ``models.convert.optax_adamw_to_port`` reads: ``adam/count``,
    ``adam/mu/<path>``, ``adam/nu/<path>``, ``schedule/count``."""
    adam, _, sched = opt_state
    flat = {"adam/count": np.asarray(adam.count),
            "schedule/count": np.asarray(sched.count)}
    for moment in ("mu", "nu"):
        for k, v in flatten_dict(getattr(adam, moment), sep="/").items():
            flat[f"adam/{moment}/{k}"] = np.asarray(v)
    return flat
