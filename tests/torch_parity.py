"""Helpers shared by the ``test_torch_*`` parity tests.

Weights are drawn with numpy from a seed in the shapes ``jax.eval_shape``
gives for the Flax module (no init compile), then handed to both
frameworks: as a Flax variable tree, and through
``jama16_retina_tpu_torch.models.convert`` as a port ``state_dict``.
BatchNorm running statistics are random too, so eval-mode BN is not the
identity, and BatchNorm scales are drawn near 1. Arrays cross between
the frameworks as numpy only.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from jama16_retina_tpu import train_lib


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's CPU ops on ``n`` threads inside the block. The suite runs
    in several worker processes at once, and ops on many small tensors
    (depthwise convs, squeeze-and-excitation) slow down tenfold when
    every worker spins a thread per core; on one thread they take no
    longer alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """``torch_threads(1)`` around a whole test module, its module
    fixtures included, where the module imports this fixture."""
    with torch_threads(1):
        yield


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
        elif last == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif last == "kernel":
            # He scaling keeps activations O(1) through the ReLU stack.
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        flat[name] = v.astype(np.float32)
    return flat


def calibrated(flat: "dict[str, np.ndarray]", model, x_nhwc: np.ndarray,
               ) -> "dict[str, np.ndarray]":
    """``flat`` with its BatchNorm running statistics replaced by the
    batch statistics of a float64 train forward of ``x_nhwc`` through the
    port's ``model`` (built with ``dtype=torch.float64`` and no stochastic
    depth), as a trained network's statistics describe its own
    activations. Random statistics do not normalize, so eval outputs of
    a residual stack (ResNet-50, EfficientNet) grow to hundreds and a
    float32 comparison there measures their magnitude, not the port."""
    from jama16_retina_tpu_torch.models import common, convert

    model.load_state_dict(convert.flax_to_torch(flat, model))
    model = model.double()
    for m in model.modules():
        if isinstance(m, common.BatchNorm):
            m.momentum = 0.0
    model.Logits.float()
    with torch.no_grad():
        model(to_nchw(x_nhwc).double(), train=True,
              generator=torch.Generator().manual_seed(0))
    out = dict(flat)
    out.update({k: v for k, v in convert.torch_to_flax(model).items()
                if k.startswith("batch_stats/")})
    return out


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


def flat_optax_state(opt_state, family: str) -> "dict[str, np.ndarray]":
    """The flat numpy form of any optax state of the JAX package's
    ``make_optimizer`` that ``models.convert.optax_to_port`` reads for
    ``family`` (the naming documented in ``models/convert.py``): the
    chain is walked and each state it holds named by its type, so the
    clip's and the masks' empty states drop out."""
    from jama16_retina_tpu_torch.models import convert

    prefixes = convert.OPT_PREFIXES[family]
    flat: dict = {}

    def tree(prefix, t):
        for k, v in flatten_dict(t, sep="/").items():
            flat[f"{prefix}/{k}"] = np.asarray(v)

    def walk(st):
        kind = type(st).__name__
        if kind == "ScaleByAdamState":
            flat[convert.OPT_COUNTS[family]] = np.asarray(st.count)
            tree(prefixes["mu"], st.mu)
            tree(prefixes["nu"], st.nu)
        elif kind == "ScaleByRmsState":
            tree(prefixes["nu"], st.nu)
        elif kind == "TraceState":
            tree(prefixes["trace"], st.trace)
        elif kind == "ScaleByScheduleState":
            flat[convert.SCHEDULE_COUNT] = np.asarray(st.count)
        elif kind == "MaskedState":
            walk(st.inner_state)
        elif isinstance(st, (tuple, list)) and kind != "EmptyState":
            for sub in st:
                walk(sub)

    walk(opt_state)
    return flat


class Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. Set as the
    ``jnp`` of a Flax model module (``monkeypatch.setattr(mod, "jnp",
    Float64Numpy())``) it makes the float32 BatchNorms, params and head
    of ResNet-50 and EfficientNet float64 under ``jax.enable_x64``: the
    float64 reference the port's float64 twin is held to."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def flax_train(module, flat, x, loss_of):
    """The Flax train forward and gradient of ``module`` on ``x`` from the
    flat tree, with ``loss_of(logits, aux)`` (jitted; dropout key 0):
    (loss, logits, flat new statistics, flat gradient), as numpy."""
    v = variables(flat)

    def f(params):
        (logits, aux), mutated = module.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        return loss_of(logits, aux), (logits, mutated)

    (loss, (logits, mutated)), g = jax.jit(
        jax.value_and_grad(f, has_aux=True))(v["params"])
    stats = {"batch_stats/" + k: np.asarray(a) for k, a in
             flatten_dict(mutated["batch_stats"], sep="/").items()}
    grads = {"params/" + k: np.asarray(a)
             for k, a in flatten_dict(g, sep="/").items()}
    return float(loss), np.asarray(logits), stats, grads


def apply_as_written(module, flat, x, dtype):
    """``module``'s eval logits on ``x`` (cast to ``dtype``), jitted with
    ``xla_allow_excess_precision`` off. On the CPU, XLA otherwise runs a
    bf16 conv as a float32 conv and drops the rounding of its result to
    bf16 before a float32 BatchNorm reads it, so the float32 BatchNorms
    of ResNet-50 and EfficientNet would see unrounded conv outputs that
    the Flax module (and the card) rounds."""
    fn = jax.jit(lambda v, x: module.apply(v, x, train=False)[0])
    args = (variables(flat), jnp.asarray(x, dtype))
    compiled = fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args))


def relative_l2_per_leaf(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| per leaf, in float64; the key sets must
    be equal. A leaf whose reference gradient is zero but for rounding
    (||want|| below 1e-9 of the whole gradient's norm) is divided by that
    floor instead: in EfficientNet, the bias of a ``project_bn`` whose
    output reaches only train-mode BatchNorms (which remove any constant
    shift) has a true gradient of 0, and both frameworks return noise
    of 1e-16 there, whose relative difference means nothing."""
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(np.sum(np.square(want[k].astype(np.float64)))
                        for k in want))
    return {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k])
                     / max(np.linalg.norm(want[k].astype(np.float64)),
                           1e-9 * total))
            for k in want}
