"""The quality monitor (``obs/quality.py``), its registry and its sealed
artifacts (``integrity/artifact.py``) against the JAX package on the CPU.

The statistics, divergences and ``build_profile`` equal the JAX
functions' bitwise on seeded inputs; a profile written by either package
from the same inputs is byte-identical and loads in the other, as does
the canary; a flipped byte raises ``ArtifactCorrupt``; monitors fed the
same traffic publish equal gauges, directly and through the engines
(fp32 ``smoke`` at 64 px, with and without the fused preprocess); the
fused path's input-statistic histograms equal the JAX fused path's; and
``fit`` writes its end-of-fit profile."""

import json
import os

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.integrity import artifact as jax_artifact
from jama16_retina_tpu.obs import quality as jax_quality
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import host as jax_host
from jama16_retina_tpu_torch import configs, models, trainer
from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.integrity import artifact
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import quality
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import random_flat, stacked_state

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=8"]


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def _scores(n, seed):
    return np.random.default_rng(seed).beta(0.6, 1.4, n)


def test_statistics_and_divergences_equal_the_jax_functions_bitwise():
    rng = np.random.default_rng(0)
    imgs = _images(9, 32, seed=1)
    imgs[0] = 0          # std exactly 0
    imgs[1] = 255
    got, want = quality.input_stat_values(imgs), jax_quality.input_stat_values(
        imgs)
    assert list(got) == list(want) == list(quality.INPUT_STATS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # Values on and beyond the edges of [0, 1] clamp into the edge bins.
    values = np.concatenate([rng.random(500), [0.0, 0.05, 1.0, -0.2, 1.3]])
    for bins in (5, 20):
        np.testing.assert_array_equal(quality.bin_counts(values, bins),
                                      jax_quality.bin_counts(values, bins))
    ref = quality.bin_counts(rng.beta(2, 5, 1000), 20)
    for cur in (quality.bin_counts(rng.beta(2, 5, 256), 20),
                quality.bin_counts(rng.beta(5, 2, 256), 20),
                np.zeros(20, np.int64)):
        for fn in ("psi", "psi_debiased", "kl_divergence"):
            assert getattr(quality, fn)(ref, cur) == getattr(
                jax_quality, fn)(ref, cur), fn


def _profile_args(seed):
    rng = np.random.default_rng(seed)
    scores = _scores(40, seed)
    labels = (rng.random(40) < 0.3).astype(np.float64)
    stats = quality.input_stat_values(_images(40, 16, seed))
    thresholds = [{"target_specificity": 0.87, "threshold": 0.61},
                  {"target_specificity": 0.98, "threshold": np.float32(0.9)}]
    return dict(scores=scores, labels=labels, stat_values=stats,
                thresholds=thresholds, bins=20,
                meta={"config": "smoke", "split": "val"})


def test_profiles_are_byte_identical_and_load_across_packages(tmp_path):
    args = _profile_args(3)
    profile = quality.build_profile(**args)
    assert profile == jax_quality.build_profile(**args)
    ours = quality.save_profile(str(tmp_path / "port.json"), profile)
    theirs = jax_quality.save_profile(str(tmp_path / "jax.json"),
                                      jax_quality.build_profile(**args))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert jax_quality.load_profile(ours) == quality.load_profile(theirs)
    assert quality.load_profile(ours)["score_hist"] == profile["score_hist"]


def _flip_inside_a_string(path):
    """One byte of the ``config`` value changed: still JSON, wrong digest."""
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace('"smoke"', '"smokf"', 1))


def test_a_flipped_byte_raises_artifact_corrupt(tmp_path):
    path = str(tmp_path / "p.json")
    jax_quality.save_profile(path, jax_quality.build_profile(
        **_profile_args(4)))
    _flip_inside_a_string(path)
    reg = Registry()
    with pytest.raises(artifact.ArtifactCorrupt, match="CORRUPT") as e:
        artifact.read_sealed_json(path, artifact="profile", registry=reg)
    assert "--profile_out" in str(e.value)
    assert reg.snapshot()["counters"]["integrity.corrupt.profile"] == 1
    with pytest.raises(artifact.ArtifactCorrupt):
        quality.load_profile(path)
    with pytest.raises(jax_artifact.ArtifactCorrupt):
        jax_quality.load_profile(path)
    with open(path) as f:
        doc = json.load(f)
    doc["version"] = 2
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="version 2"):
        quality.load_profile(path)


def test_canaries_load_across_packages_and_refuse_damage(tmp_path):
    imgs, scores = _images(3, 16, seed=5), _scores(3, 5)
    for save, load in ((quality.save_canary, jax_quality.load_canary_file),
                       (jax_quality.save_canary, quality.load_canary_file)):
        path = save(str(tmp_path / save.__module__), imgs, scores)
        assert path.endswith(".npz")
        got_imgs, got_scores = load(path)
        np.testing.assert_array_equal(got_imgs, imgs)
        np.testing.assert_array_equal(got_scores, scores)
    path = quality.save_canary(str(tmp_path / "unpinned.npz"), imgs)
    assert quality.load_canary_file(path)[1] is None
    with open(path, "r+b") as f:
        f.seek(-5, os.SEEK_END)
        byte = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(artifact.ArtifactCorrupt, match="canary"):
        quality.load_canary_file(path)
    os.remove(artifact.sidecar_path(path))
    assert artifact.verify_sidecar(path) == "unsealed"


def _qcfg(window):
    return (jax_configs.QualityConfig(enabled=True, window_scores=window),
            configs.QualityConfig(enabled=True, window_scores=window))


def _quality_metrics(snapshot):
    return {k: v for kind in ("counters", "gauges")
            for k, v in snapshot[kind].items() if k.startswith("quality.")}


@pytest.mark.parametrize("head", ["binary", "multi"])
def test_monitor_gauges_equal_the_jax_monitor_after_the_same_traffic(head):
    """Windows of 50 over requests of 7-50 rows, scores drifting on
    purpose: a window with input statistics, then one without (a
    score-only request of 50 rows), then an open one."""
    args = _profile_args(6)
    jq_cfg, q_cfg = _qcfg(50)
    theirs_reg, ours_reg = JaxRegistry(), Registry()
    theirs = jax_quality.QualityMonitor(
        jq_cfg, registry=theirs_reg,
        profile=jax_quality.build_profile(**args))
    ours = quality.QualityMonitor(q_cfg, registry=ours_reg,
                                  profile=quality.build_profile(**args))
    rng = np.random.default_rng(7)
    for i, n in enumerate((7, 23, 11, 19, 50, 9, 13)):
        imgs = _images(n, 16, seed=100 + i)
        s = rng.beta(1.4 + i, 0.6, n)
        if head == "multi":
            s = rng.dirichlet(np.ones(5), n)
        rows = None if i == 4 else imgs
        theirs.observe(rows, s)
        ours.observe(rows, s)
        assert _quality_metrics(ours_reg.snapshot()) == _quality_metrics(
            theirs_reg.snapshot()), i
    snap = ours_reg.snapshot()
    assert snap["counters"]["quality.windows"] == 2
    assert snap["counters"]["quality.scores"] == 132
    assert snap["gauges"]["quality.input_psi_max"] == 0.0
    assert snap["gauges"]["quality.profile_loaded"] == 1.0
    ours_reg.enabled = False
    ours.observe(None, s)
    assert ours_reg.snapshot() == snap


def test_canary_gauges_equal_the_jax_canary():
    imgs = _images(4, 16, seed=8)
    pinned = _scores(4, 8)
    theirs_reg, ours_reg = JaxRegistry(), Registry()
    theirs = jax_quality.GoldenCanary(imgs, pinned, registry=theirs_reg)
    ours = quality.GoldenCanary(imgs, pinned, registry=ours_reg)
    for fn in (lambda x: pinned, lambda x: pinned + 1e-9,
               lambda x: pinned[:3], lambda x: 1 / 0):
        assert ours.check(fn, now=0.0).keys() == theirs.check(
            fn, now=0.0).keys()
        assert _quality_metrics(ours_reg.snapshot()) == _quality_metrics(
            theirs_reg.snapshot())
    assert ours_reg.snapshot()["counters"]["quality.canary_failures"] == 3
    loose = quality.GoldenCanary(imgs, pinned, atol=1e-6, every_s=10,
                                 registry=Registry())
    assert loose.check(lambda x: pinned + 1e-9)["ok"]
    assert loose.claim_due(now=5.0) is False
    assert loose.claim_due(now=1e9) is True
    unpinned = quality.GoldenCanary(imgs, registry=Registry())
    assert unpinned.check(lambda x: pinned)["pinned"]


@pytest.fixture(scope="module")
def smoke_flats():
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), SMOKE)
    model = jax_models.build(jcfg.model)
    return [random_flat(model, (2, 64, 64, 3), seed=70 + m) for m in range(2)]


@pytest.fixture(scope="module")
def reference(smoke_flats, tmp_path_factory):
    """A profile of 48 rendered-noise images scored by the fp32 port
    engine, and a canary of 4 pinned with those scores."""
    cfg = configs.override(configs.get_config("smoke"), SMOKE)
    engine = _port_engine(cfg, smoke_flats, Registry())
    imgs = _images(48, 64, seed=11)
    scores = engine.probs(imgs)
    root = tmp_path_factory.mktemp("reference")
    profile = quality.save_profile(str(root / "profile.json"),
                                   quality.build_profile(
                                       scores, stat_values=quality.
                                       input_stat_values(imgs)))
    canary = quality.save_canary(str(root / "canary"), imgs[:4], scores[:4])
    return profile, canary


def _port_engine(cfg, flats, registry):
    model = models.build(cfg.model)
    return ServingEngine(
        cfg, state_dicts=[convert.flax_to_torch(f, model) for f in flats],
        device="cpu", registry=registry)


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_engine_monitors_publish_what_the_jax_engine_publishes(
        smoke_flats, reference, fused):
    """Both engines serve the same requests (brightened halfway, so the
    input statistics drift) with the monitor on; their drift gauges and
    counters agree after every request. The canary runs once, through
    ``member_probs``, outside the drift windows; scores of two
    frameworks (and of one on other thread counts) differ in float32
    rounding, so it compares within ``canary_atol`` 1e-6 here."""
    profile, canary = reference
    sets = SMOKE + ["obs.quality.enabled=true",
                    f"obs.quality.profile_path={profile}",
                    f"obs.quality.canary_path={canary}",
                    "obs.quality.canary_atol=1e-6",
                    "obs.quality.window_scores=16",
                    f"serve.fused_preprocess={fused}"]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), sets)
    cfg = configs.override(configs.get_config("smoke"), sets)
    theirs_reg, ours_reg = JaxRegistry(), Registry()
    theirs = jax_engine.ServingEngine(
        jcfg, model=jax_models.build(jcfg.model),
        state=stacked_state(smoke_flats), registry=theirs_reg)
    ours = _port_engine(cfg, smoke_flats, ours_reg)
    for i, n in enumerate((5, 12, 9, 14)):
        imgs = _images(n, 64, seed=200 + i)
        if i >= 2:
            imgs = np.maximum(imgs, 96).astype(np.uint8)
        np.testing.assert_allclose(ours.probs(imgs), theirs.probs(imgs),
                                   rtol=0, atol=1e-5)
        got = _quality_metrics(ours_reg.snapshot())
        want = _quality_metrics(theirs_reg.snapshot())
        for snap in (got, want):
            assert snap.pop("quality.canary_max_dev") <= 1e-6
            assert snap.pop("quality.canary_ok") == 1.0
        assert got == want, i
    assert got["quality.scores"] == 40 and got["quality.windows"] == 2
    assert got["quality.canary_runs"] == 1
    assert got["quality.canary_failures"] == 0
    assert got["quality.input_psi_max"] > 0


def test_canary_leaves_last_input_stats_to_the_request(smoke_flats,
                                                       reference):
    """The first request carries the canary (4 rows) and the bf16 gate
    scores it at construction; ``last_input_stats`` still holds the
    request's own rows, as the fused path computed them."""
    from jama16_retina_tpu_torch.serve import host

    profile, canary = reference
    cfg = configs.override(configs.get_config("smoke"), SMOKE + [
        "obs.quality.enabled=true", f"obs.quality.canary_path={canary}",
        "serve.fused_preprocess=true", "serve.dtype=bf16"])
    reg = Registry()
    engine = _port_engine(cfg, smoke_flats, reg)
    assert engine.last_input_stats is None
    imgs = _images(6, 64, seed=210)
    engine.probs(imgs)
    assert reg.snapshot()["counters"]["quality.canary_runs"] == 1
    want = host.stats_only(imgs, fused=True, device="cpu")
    assert set(engine.last_input_stats) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(engine.last_input_stats[k], v)


def test_fused_histograms_equal_the_jax_fused_path():
    """The port's B4 sums are exact integers; the JAX kernel sums in
    float32. Over these seeded batches, every statistic of every image
    falls in the same bin of 20 either way (0 of 5 x 64 counts
    differ); the statistics themselves within 1e-6."""
    from jama16_retina_tpu_torch.serve import host

    for seed, size in ((0, 64), (1, 75), (2, 139)):
        imgs = _images(8 if size < 139 else 4, size, seed=300 + seed)
        ours = host.stats_only(imgs, fused=True, device="cpu")
        theirs = jax_host.stats_only(imgs, fused=True, interpret=True,
                                     registry=JaxRegistry())
        for k in quality.INPUT_STATS:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(quality.bin_counts(ours[k], 20),
                                          quality.bin_counts(theirs[k], 20))


def test_monitor_from_config_and_the_disabled_monitor(reference):
    profile, canary = reference
    assert quality.monitor_from_config(configs.QualityConfig()) is None
    q = quality.monitor_from_config(
        configs.QualityConfig(enabled=True, profile_path=profile,
                              canary_path=canary), registry=Registry())
    assert q.threshold == 0.5 and q.canary.reference.shape == (4,)
    with pytest.raises(ValueError, match="bins"):
        quality.monitor_from_config(configs.QualityConfig(
            enabled=True, profile_path=profile, score_bins=10))
    with pytest.raises(FileNotFoundError):
        quality.monitor_from_config(configs.QualityConfig(
            enabled=True, canary_path=profile + ".missing"))
    off = quality.QualityMonitor(configs.QualityConfig(enabled=False))
    off.observe(None, np.ones(3))
    assert off.profile is None and off.run_canary(lambda x: x) is None


def test_fit_writes_its_end_of_fit_profile(tmp_path):
    """``obs.quality.profile_out``: after the last step ``fit`` scores val
    with its final state and writes the sealed profile (which the JAX
    package loads) and a ``quality_profile`` record."""
    data = str(tmp_path / "data")
    for split, n, seed in (("train", 8, 1), ("val", 6, 2)):
        tfrecord.write_synthetic_split(data, split, n, 32, num_shards=2,
                                       seed=seed, encoding="raw")
    out = str(tmp_path / "profiles" / "end.json")
    cfg = configs.override(configs.get_config("smoke"), [
        "model.image_size=32", "train.steps=2", "train.eval_every=2",
        "data.batch_size=4", "eval.batch_size=4",
        f"obs.quality.profile_out={out}"])
    trainer.fit(cfg, data, str(tmp_path / "wd"), device="cpu")
    profile = jax_quality.load_profile(out)
    assert profile["n_examples"] == 6
    assert profile["meta"] == {"config": "smoke", "split": "val",
                               "source": "trainer_end_of_fit"}
    assert sum(profile["input_stats"]["brightness"]) == 6
    rec = [r for r in read_jsonl(str(tmp_path / "wd" / "metrics.jsonl"))
           if r.get("kind") == "quality_profile"]
    assert len(rec) == 1 and rec[0]["path"] == out
