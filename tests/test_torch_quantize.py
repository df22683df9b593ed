"""The serving dtype (``serve/quantize.py``) and its construction gate
against the JAX package on the CPU.

The int8 values and scales are held bitwise against the JAX
``_quantize_leaf`` (AQT in this environment) on conv, depthwise-conv and
Dense leaves carried across by ``models/convert.flax_to_torch``; the
bf16 and int8 engines' probabilities against the JAX ``ServingEngine``
at the same ``serve.dtype`` (``smoke``'s ``tiny_cnn`` at 64 px and
Inception-v3 at 75 px, float32 compute, within 1e-5); and the
construction gate refuses, passes and skips where the JAX gate does,
on one canary file both packages read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch import nn

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.obs.registry import Registry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import quantize as jax_quantize
from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import quality
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.serve import quantize
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import random_flat, stacked_state

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=8"]


class _Leaves(nn.Module):
    """One leaf of each layout: a conv [O, I, kh, kw] (Flax [kh, kw, I, O]),
    a depthwise conv [C, 1, kh, kw] (Flax [kh, kw, 1, C]) and a Dense
    [O, I] (Flax [I, O])."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(16, 32, 3, bias=False)
        self.dw = nn.Conv2d(24, 24, 5, groups=24, bias=False)
        self.head = nn.Linear(64, 10, bias=False)


def _flax_leaves(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"params/conv/kernel": (3, 3, 16, 32),
              "params/dw/kernel": (5, 5, 1, 24),
              "params/head/kernel": (64, 10)}
    out = {}
    for k, shape in shapes.items():
        # Channel magnitudes spread over two decades; one channel of
        # zeros takes AQT's zero-amax rule.
        w = rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])
        w[..., 3] = 0.0
        out[k] = w.astype(np.float32)
    return out


@pytest.mark.parametrize("leaf", ["conv", "dw", "head"])
def test_int8_values_and_scales_equal_aqt_bitwise(leaf):
    """Two members stacked as the JAX engine stacks them, quantized by
    ``_quantize_leaf``; each member's converted weight quantized by the
    port: ``q`` and ``s`` equal bitwise after the same transpose."""
    flats = [_flax_leaves(seed) for seed in (1, 2)]
    key = f"params/{leaf}/kernel"
    ref = jax_quantize._quantize_leaf(jnp.stack([f[key] for f in flats]))
    q_ref, s_ref = np.asarray(ref.q), np.asarray(ref.s)
    assert q_ref.dtype == np.int8 and s_ref.dtype == np.float32
    for m, flat in enumerate(flats):
        w = convert.flax_to_torch(flat, _Leaves())[f"{leaf}.weight"]
        got = quantize.quantize_weight(w)
        assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
        back = convert.torch_to_flax({f"{leaf}.weight": got.q.float()})[key]
        np.testing.assert_array_equal(back.astype(np.int8), q_ref[m])
        scale = convert.torch_to_flax({f"{leaf}.weight": got.s})[key]
        np.testing.assert_array_equal(scale, s_ref[m])
        assert int(np.abs(q_ref[m]).max()) <= 127


def _configs(preset, *extra):
    sets = SMOKE + list(extra)
    return (jax_configs.override(jax_configs.get_config(preset), sets),
            configs.override(configs.get_config(preset), sets))


@pytest.fixture(scope="module")
def smoke_flats():
    jcfg, _ = _configs("smoke")
    model = jax_models.build(jcfg.model)
    return [random_flat(model, (2, 64, 64, 3), seed=50 + m) for m in range(2)]


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def _jax(jcfg, flats):
    return jax_engine.ServingEngine(
        jcfg, model=jax_models.build(jcfg.model), state=stacked_state(flats),
        registry=Registry())


def _port(cfg, flats, registry=None):
    model = models.build(cfg.model)
    return ServingEngine(
        cfg, state_dicts=[convert.flax_to_torch(f, model) for f in flats],
        device="cpu", registry=registry or obs_registry.Registry())


def test_the_same_leaves_are_quantized_and_cast(smoke_flats):
    """int8 quantizes exactly the leaves the JAX package does (rank >= 2
    a member); bf16 casts every parameter and keeps the BatchNorm
    statistics float32, as the JAX state's ``batch_stats`` stay."""
    jcfg, cfg = _configs("smoke", "serve.dtype=int8")
    state = jax_quantize.state_for_dtype(stacked_state(smoke_flats), "int8")
    flat_q = flatten_dict(state.params, sep="/")
    want = sorted(f"params/{k}" for k, v in flat_q.items()
                  if isinstance(v, jax_quantize.Q8Leaf))
    engine = _port(cfg, smoke_flats)
    params, buffers = engine._members[0]
    got = sorted(convert.torch_to_flax({k: torch.zeros(p.q.shape)})
                 .popitem()[0] for k, p in params.items()
                 if isinstance(p, quantize.Q8))
    assert got == want and len(want) >= 3
    assert all(b.dtype == torch.float32 for b in buffers.values())

    bf16 = _port(configs.override(cfg, ["serve.dtype=bf16"]), smoke_flats)
    params, buffers = bf16._members[0]
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    assert {b.dtype for b in buffers.values()} == {torch.float32}
    assert len(buffers) == sum(k.startswith("batch_stats/")
                               for k in smoke_flats[0])
    fp32 = _port(configs.override(cfg, ["serve.dtype=fp32"]), smoke_flats)
    assert bf16.resident_bytes() < fp32.resident_bytes()
    assert engine.resident_bytes() < bf16.resident_bytes()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_engine_matches_the_jax_engine_at_dtype(smoke_flats, dtype):
    jcfg, cfg = _configs("smoke", f"serve.dtype={dtype}")
    ref, port = _jax(jcfg, smoke_flats), _port(cfg, smoke_flats)
    fp32 = _port(configs.override(cfg, ["serve.dtype=fp32"]), smoke_flats)
    for n in (3, 11):
        imgs = _images(n, 64, seed=n)
        got, want = port.member_probs(imgs), ref.member_probs(imgs)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # The dtype moves the scores (the comparison above is not vacuous).
        assert np.abs(got - fp32.member_probs(imgs)).max() > 1e-7


def test_inception_v3_int8_engine_matches_the_jax_engine():
    overrides = ["model.aux_head=false", "model.image_size=75",
                 "serve.bucket_sizes=8", "serve.dtype=int8"]
    jcfg, cfg = _configs("eyepacs_binary", *overrides)
    flat = random_flat(jax_models.build(jcfg.model), (2, 75, 75, 3), seed=61)
    imgs = _images(3, 75, seed=7)
    np.testing.assert_allclose(_port(cfg, [flat]).member_probs(imgs),
                               _jax(jcfg, [flat]).member_probs(imgs),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def canary(smoke_flats, tmp_path_factory):
    """A canary of 6 images pinned with the fp32 ensemble's scores,
    written by the port and read by both packages."""
    _, cfg = _configs("smoke")
    imgs = _images(6, 64, seed=99)
    scores = _port(cfg, smoke_flats).probs(imgs)
    return quality.save_canary(
        str(tmp_path_factory.mktemp("canary") / "golden"), imgs, scores)


def _gate_outcome(build):
    try:
        build()
    except (jax_quantize.DtypeRejected, quantize.DtypeRejected):
        return "rejected"
    return "served"


@pytest.mark.parametrize("dtype,max_dev,outcome", [
    ("bf16", "0", "rejected"), ("int8", "0", "rejected"),
    ("bf16", "0.05", "served"), ("int8", "0.05", "served"),
    ("fp32", "0", "served")])
def test_construction_gate_decides_as_the_jax_gate(smoke_flats, canary, dtype,
                                                   max_dev, outcome):
    """At max_dev 0 a bf16 or int8 engine's canary deviation refuses it;
    the default 0.05 admits it; fp32 skips the gate."""
    jcfg, cfg = _configs(
        "smoke", f"serve.dtype={dtype}", f"serve.dtype_canary_max_dev={max_dev}",
        "obs.quality.enabled=true", f"obs.quality.canary_path={canary}")
    assert _gate_outcome(lambda: _port(cfg, smoke_flats)) == outcome
    assert _gate_outcome(lambda: _jax(jcfg, smoke_flats)) == outcome


def test_gate_without_a_pinned_canary_serves_ungated(smoke_flats, tmp_path,
                                                     caplog):
    unpinned = quality.save_canary(str(tmp_path / "c"), _images(2, 64, 1))
    for path in ("", unpinned):
        _, cfg = _configs("smoke", "serve.dtype=int8",
                          "serve.dtype_canary_max_dev=0",
                          "obs.quality.enabled=true",
                          f"obs.quality.canary_path={path}")
        with caplog.at_level("WARNING"):
            _port(cfg, smoke_flats)
        assert "UNGATED" in caplog.text
        caplog.clear()


def test_a_canary_of_the_wrong_shape_raises_at_construction(smoke_flats,
                                                            tmp_path):
    path = quality.save_canary(str(tmp_path / "c32"), _images(2, 32, 1))
    _, cfg = _configs("smoke", "obs.quality.enabled=true",
                      f"obs.quality.canary_path={path}")
    with pytest.raises(ValueError, match="canary images are"):
        _port(cfg, smoke_flats)


def test_unknown_serve_dtype_raises(smoke_flats):
    _, cfg = _configs("smoke", "serve.dtype=fp16")
    with pytest.raises(ValueError, match="serve.dtype"):
        _port(cfg, smoke_flats)
    with pytest.raises(ValueError, match="serve.dtype"):
        quantize.check_dtype("int4")
