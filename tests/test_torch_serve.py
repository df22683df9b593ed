"""The port's ``ServingEngine`` (device="cpu") against the JAX package's
``ServingEngine(state=...)`` on the same converted weights.

Both configs come from one list of ``--set`` overrides, so the port's
config names are pinned too. Models run in float32 (the smoke preset's
default is bf16, whose cross-framework gap is bounded in
test_torch_models.py), so probabilities agree to 1e-5. The
member-parallel form (``serve.member_parallel``, one vmap over the
stacked members) is held to the members-in-turn form and to the JAX
member-parallel engine, within 1e-5."""

import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.obs.registry import Registry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import host
from jama16_retina_tpu_torch.serve.engine import ServingEngine, resolve_buckets
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import random_flat, stacked_state, torch_threads

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=16"]


def _configs(preset, overrides):
    return (jax_configs.override(jax_configs.get_config(preset), overrides),
            configs.override(configs.get_config(preset), overrides))


def _jax_engine(jcfg, flats):
    model = jax_models.build(jcfg.model)
    return jax_engine.ServingEngine(jcfg, model=model,
                                    state=stacked_state(flats),
                                    registry=Registry())


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


@pytest.fixture(scope="module")
def smoke_members(tmp_path_factory):
    """k=2 tiny_cnn members as Flax trees and as port member dirs."""
    jcfg, _ = _configs("smoke", SMOKE)
    model = jax_models.build(jcfg.model)
    flats = [random_flat(model, (2, 64, 64, 3), seed=10 + m) for m in range(2)]
    root = tmp_path_factory.mktemp("port_members")
    for m, flat in enumerate(flats):
        ckpt_lib.save_member(str(root / f"member_{m:02d}"), flat)
    return flats, str(root)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_engine_matches_jax_engine(smoke_members, tta):
    flats, root = smoke_members
    jcfg, pcfg = _configs("smoke", SMOKE + [f"eval.tta={tta}"])
    dirs = ckpt_lib.discover_member_dirs(root)
    assert [d[-9:] for d in dirs] == ["member_00", "member_01"]
    ref = _jax_engine(jcfg, flats)
    port = ServingEngine(pcfg, dirs, device="cpu")
    assert port.buckets == ref.buckets == (8, 16)
    # 5 -> bucket 8, 11 -> bucket 16, 21 -> chunks of 16 + 5.
    for n in (5, 11, 21):
        imgs = _images(n, 64, seed=n)
        want_m = ref.member_probs(imgs)
        got_m = port.member_probs(imgs)
        assert got_m.shape == want_m.shape == (2, n)
        np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-5)
        got, want = port.probs(imgs), ref.probs(imgs)
        assert got.shape == (n,) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_padding_rows_are_inert(smoke_members):
    flats, _ = smoke_members
    _, pcfg = _configs("smoke", SMOKE)
    model = models.build(pcfg.model)
    sds = [convert.flax_to_torch(f, model) for f in flats]
    engine = ServingEngine(pcfg, state_dicts=sds, device="cpu")
    imgs = _images(7, 64, seed=3)
    alone = engine.member_probs(imgs[:3])      # 3 real rows + 5 zero rows
    among = engine.member_probs(imgs)          # 7 real rows + 1 zero row
    np.testing.assert_array_equal(alone, among[:, :3])
    assert engine.chunks_dispatched == 2


def test_fused_preprocess_on_and_off_agree(smoke_members):
    flats, _ = smoke_members
    _, pcfg = _configs("smoke", SMOKE)
    model = models.build(pcfg.model)
    sds = [convert.flax_to_torch(f, model) for f in flats]
    fused_cfg = configs.override(pcfg, ["serve.fused_preprocess=true"])
    plain = ServingEngine(pcfg, state_dicts=sds, device="cpu")
    fused = ServingEngine(fused_cfg, state_dicts=sds, device="cpu")
    imgs = _images(19, 64, seed=4)
    before = serve_preprocess.launches
    np.testing.assert_allclose(fused.probs(imgs), plain.probs(imgs),
                               rtol=0, atol=1e-6)
    assert serve_preprocess.launches == before  # CPU: the plain version
    assert plain.last_input_stats is None
    want = host.stats_only(imgs, device="cpu")
    assert set(fused.last_input_stats) == set(want)
    for k in want:  # stats of the 19 real rows, none of the padding
        np.testing.assert_array_equal(fused.last_input_stats[k], want[k])


def test_inception_v3_75px_engine_matches_jax_engine():
    overrides = ["model.image_size=75", "model.aux_head=false",
                 "model.compute_dtype=float32", "serve.bucket_sizes=8",
                 "serve.max_batch=8"]
    jcfg, pcfg = _configs("eyepacs_binary", overrides)
    flat = random_flat(jax_models.build(jcfg.model), (2, 75, 75, 3), seed=21)
    ref = _jax_engine(jcfg, [flat])
    port = ServingEngine(pcfg, state_dicts=[
        convert.flax_to_torch(flat, models.build(pcfg.model))], device="cpu")
    imgs = _images(3, 75, seed=5)
    np.testing.assert_allclose(port.member_probs(imgs), ref.member_probs(imgs),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("overrides", [
    [], ["serve.max_batch=8"], ["serve.max_batch=100"],
    ["serve.bucket_sizes=16,4,8,4", "serve.max_batch=16"],
])
def test_resolve_buckets_matches_jax(overrides):
    jcfg, pcfg = _configs("eyepacs_binary", overrides)
    assert resolve_buckets(pcfg.serve) == jax_engine.resolve_buckets(jcfg.serve)


def test_engine_rejects_malformed_requests(smoke_members):
    flats, _ = smoke_members
    _, pcfg = _configs("smoke", SMOKE)
    sds = [convert.flax_to_torch(flats[0], models.build(pcfg.model))]
    engine = ServingEngine(pcfg, state_dicts=sds, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        engine.member_probs(np.zeros((0, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="expected images"):
        engine.member_probs(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        engine.member_probs(np.zeros((2, 64, 64, 3), np.float32))


def _member_parallel_pair(cfg, sds, imgs):
    seq = ServingEngine(cfg, state_dicts=sds, device="cpu")
    par = ServingEngine(configs.override(cfg, ["serve.member_parallel=true"]),
                        state_dicts=sds, device="cpu")
    assert par.member_parallel and par.n_members == len(sds)
    assert par.resident_bytes() == seq.resident_bytes()
    return par.member_probs(imgs), seq.member_probs(imgs)


@pytest.mark.parametrize("extra", [[], ["eval.tta=true"],
                                   ["serve.dtype=bf16"],
                                   ["serve.dtype=int8"]],
                         ids=["fp32", "tta", "bf16", "int8"])
def test_member_parallel_matches_members_in_turn(smoke_members, extra):
    """One vmap over the stacked members against the members one after
    another: float-equivalent, within 1e-5, at every serving dtype."""
    flats, _ = smoke_members
    _, pcfg = _configs("smoke", SMOKE + extra)
    model = models.build(pcfg.model)
    sds = [convert.flax_to_torch(f, model) for f in flats]
    got, want = _member_parallel_pair(pcfg, sds, _images(11, 64, seed=8))
    assert got.shape == want.shape == (2, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("preset,overrides", [
    ("eyepacs_binary", ["model.image_size=75", "model.aux_head=false"]),
    ("efficientnet_b4", ["model.image_size=64"]),
], ids=["inception_v3", "efficientnet_b4"])
def test_member_parallel_runs_the_custom_functions_under_vmap(preset,
                                                              overrides):
    """Inception-v3's SAME average pool and EfficientNet's sigmoid are
    ``autograd.Function``s: under vmap they run by the rule PyTorch
    derives from their forward, and agree with the members in turn."""
    cfg = configs.override(configs.get_config(preset), overrides + [
        "model.compute_dtype=float32", "serve.max_batch=8"])
    sds = []
    for m in range(2):
        gen = torch.Generator().manual_seed(m)
        sd = models.build(cfg.model).state_dict()
        sds.append({k: (v + 0.05 * torch.randn(v.shape, generator=gen)
                        if not k.endswith((".mean", ".var")) else v)
                    for k, v in sd.items()})
    with torch_threads(1):
        got, want = _member_parallel_pair(cfg, sds,
                                          _images(3, cfg.model.image_size, 9))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_member_parallel_matches_the_jax_member_parallel_engine(
        smoke_members):
    flats, _ = smoke_members
    jcfg, pcfg = _configs("smoke", SMOKE + ["serve.member_parallel=true"])
    ref = _jax_engine(jcfg, flats)
    model = models.build(pcfg.model)
    port = ServingEngine(pcfg, state_dicts=[
        convert.flax_to_torch(f, model) for f in flats], device="cpu")
    for n in (5, 21):
        imgs = _images(n, 64, seed=30 + n)
        np.testing.assert_allclose(port.member_probs(imgs),
                                   ref.member_probs(imgs), rtol=0, atol=1e-5)
        np.testing.assert_allclose(port.probs(imgs), ref.probs(imgs),
                                   rtol=0, atol=1e-5)
