"""Serving generations of the port's ``ServingEngine`` (reload, rollback,
retention, shadow) against the JAX package's engine driven through the
same sequence on the same members (``tiny_cnn``, 64 px, float32): equal
generation ids, info dicts, counters and shadow reports, probabilities
within 1e-6. Then what only the port's threads show: a reload between
two chunks of one request leaves all its rows on one generation, and no
request fails under a ``MicroBatcher`` while reloads and rollbacks
run."""

import threading
import time

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import quality
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve import engine as engine_lib
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, stacked_state

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=8", "serve.bucket_sizes=4,8"]
COUNTERS = ("serve.reloads", "serve.reload_rejected", "serve.rollbacks",
            "serve.shadow.requests", "serve.shadow.rows",
            "serve.shadow.errors")


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Two member sets of k=2 (A: seeds 50, 51; B: 60, 61) as Flax trees
    and port member dirs, and 12 images."""
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), SMOKE)
    model = jax_models.build(jcfg.model)
    sets = {name: [random_flat(model, (2, 64, 64, 3), seed=s + m)
                   for m in range(2)] for name, s in (("A", 50), ("B", 60))}
    root = tmp_path_factory.mktemp("reload_members")
    dirs = {}
    for name, flats in sets.items():
        dirs[name] = []
        for m, flat in enumerate(flats):
            d = str(root / name / f"member_{m:02d}")
            ckpt_lib.save_member(d, flat)
            dirs[name].append(d)
    images = np.random.default_rng(7).integers(0, 256, (12, 64, 64, 3),
                                               np.uint8)
    return sets, dirs, images


def _pair(members, extra=()):
    """(JAX engine on set A, port engine on set A) under one override
    list, each on a registry of its own."""
    sets, dirs, _ = members
    overrides = SMOKE + list(extra)
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), overrides)
    pcfg = configs.override(configs.get_config("smoke"), overrides)
    j = jax_engine.ServingEngine(jcfg, model=jax_models.build(jcfg.model),
                                 state=stacked_state(sets["A"]),
                                 registry=JaxRegistry())
    p = ServingEngine(pcfg, dirs["A"], device="cpu", registry=Registry())
    return j, p


def _counters(engine) -> dict:
    reg = engine.registry
    out = {n: reg.counter(n).value for n in COUNTERS}
    out["serve.generation"] = reg.gauge("serve.generation").value
    return out


def _same(j, p, images):
    """Both engines serve the same generation id and scores within 1e-6,
    and their counters agree."""
    want, jgen = j.probs_with_generation(images)
    got, pgen = p.probs_with_generation(images)
    assert pgen == jgen == p.generation == j.generation
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert _counters(p) == _counters(j)
    return got


def test_reload_rollback_and_retention_equal_the_jax_engine(members):
    sets, dirs, images = members
    j, p = _pair(members)
    a = _same(j, p, images)
    info = p.reload(dirs["B"])
    assert info == j.reload(state=stacked_state(sets["B"])) == {
        "generation": 1, "n_members": 2, "canary_checked": False}
    b = _same(j, p, images)
    assert np.max(np.abs(a - b)) > 1e-3
    assert p.resident_bytes() == 2 * ServingEngine(
        p.cfg, dirs["A"], device="cpu", registry=Registry()).resident_bytes()
    info = p.rollback()
    assert info == j.rollback() == {"generation": 2, "restored_from": 0,
                                    "n_members": 2}
    np.testing.assert_array_equal(_same(j, p, images), a)
    for e in (p, j):
        with pytest.raises((engine_lib.RollbackUnavailable,
                            jax_engine.RollbackUnavailable),
                           match="no previous generation"):
            e.rollback()
    # release_retained drops the rollback target.
    assert p.reload(dirs["B"]) == j.reload(state=stacked_state(sets["B"]))
    p.release_retained()
    j.release_retained()
    assert p.resident_bytes() * 2 == ServingEngine(
        p.cfg, dirs["A"] + dirs["B"], device="cpu",
        registry=Registry()).resident_bytes()
    for e in (p, j):
        with pytest.raises((engine_lib.RollbackUnavailable,
                            jax_engine.RollbackUnavailable)):
            e.rollback()
    # A failing build: the old generation keeps serving.
    missing = [dirs["B"][0] + "_missing"]
    with pytest.raises(Exception):
        p.reload(missing)
    with pytest.raises(Exception):
        j.reload(missing)
    np.testing.assert_array_equal(_same(j, p, images), b)
    assert _counters(p)["serve.reload_rejected"] == 1
    assert _counters(p)["serve.reloads"] == 2
    assert _counters(p)["serve.rollbacks"] == 1


def test_retention_expires_after_rollback_keep_s(members):
    sets, dirs, images = members
    j, p = _pair(members, ["serve.rollback_keep_s=0.05"])
    p.reload(dirs["B"])
    j.reload(state=stacked_state(sets["B"]))
    time.sleep(0.2)
    for e in (p, j):
        with pytest.raises((engine_lib.RollbackUnavailable,
                            jax_engine.RollbackUnavailable), match="expired"):
            e.rollback()
    # rollback_keep_s=0 keeps nothing.
    j0, p0 = _pair(members, ["serve.rollback_keep_s=0"])
    p0.reload(dirs["B"])
    j0.reload(state=stacked_state(sets["B"]))
    assert p0._prev_gen is None and j0._prev_gen is None
    _same(j0, p0, images)


def test_a_candidate_failing_the_canary_is_rejected(members, tmp_path):
    """A canary pinned from set A's scores (atol 1e-4): reloading A passes
    it, reloading B raises ReloadRejected, counts it and leaves the live
    generation serving, in both packages."""
    sets, dirs, images = members
    j, _ = _pair(members)
    canary = quality.save_canary(str(tmp_path / "canary"), images[:4],
                                 j.probs(images[:4]))
    j, p = _pair(members, ["obs.quality.enabled=true",
                           f"obs.quality.canary_path={canary}",
                           "obs.quality.canary_atol=1e-4",
                           "obs.quality.canary_every_s=0"])
    ok_p = p.reload(dirs["A"])
    ok_j = j.reload(state=stacked_state(sets["A"]))
    assert ok_p["canary_checked"] and ok_j["canary_checked"]
    assert abs(ok_p["canary_max_dev"] - ok_j["canary_max_dev"]) <= 1e-6
    with pytest.raises(engine_lib.ReloadRejected, match="golden canary"):
        p.reload(dirs["B"])
    with pytest.raises(jax_engine.ReloadRejected):
        j.reload(state=stacked_state(sets["B"]))
    assert p.generation == j.generation == 1
    _same(j, p, images)
    assert _counters(p)["serve.reload_rejected"] == 1


def test_shadow_sampling_report_and_promote_equal_the_jax_engine(members):
    sets, dirs, images = members
    j, p = _pair(members)
    assert (p.begin_shadow(dirs["B"], fraction=0.25)
            == j.begin_shadow(state=stacked_state(sets["B"]), fraction=0.25)
            == {"fraction": 0.25, "every": 4})
    stats_before = p.last_input_stats
    for i in range(9):
        _same(j, p, images[i:i + 3])
    rp, rj = p.shadow_report(), j.shadow_report()
    assert (rp["requests"], rp["rows"], rp["errors"]) == (
        rj["requests"], rj["rows"], rj["errors"]) == (2, 6, 0)
    assert abs(rp["max_abs_dev"] - rj["max_abs_dev"]) <= 1e-6
    assert p.last_input_stats is stats_before
    with pytest.raises(RuntimeError, match="already active"):
        p.begin_shadow(dirs["B"])
    end_p, end_j = p.end_shadow(promote=True), j.end_shadow(promote=True)
    assert end_p["reload"] == end_j["reload"] == {
        "generation": 1, "n_members": 2, "canary_checked": False}
    _same(j, p, images)
    assert p.end_shadow() is None and p.shadow_report() is None


def test_exactly_one_of_two_racing_enders_gets_the_report(members):
    _, dirs, images = members
    _, p = _pair(members)
    candidate = p.prepare_candidate(dirs["B"])
    np.testing.assert_allclose(
        metrics.ensemble_average(list(p.member_probs(images,
                                                     _gen=candidate))),
        ServingEngine(p.cfg, dirs["B"], device="cpu",
                      registry=Registry()).probs(images), rtol=0, atol=0)
    p.begin_shadow(candidate=candidate, fraction=1.0)
    p.probs(images[:2])
    out = []
    start = threading.Barrier(2)

    def end():
        start.wait()
        out.append(p.end_shadow())

    threads = [threading.Thread(target=end) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reports = [r for r in out if r is not None]
    assert len(out) == 2 and len(reports) == 1
    assert reports[0]["requests"] == 1 and p.generation == 0


def test_a_reload_between_two_chunks_leaves_the_request_on_one_generation(
        members):
    sets, dirs, images = members
    _, p = _pair(members)
    want_a = p.probs(images)  # 12 rows: chunks of 8 and 4
    want_b = ServingEngine(p.cfg, dirs["B"], device="cpu",
                           registry=Registry()).probs(images)
    forward = p._forward
    calls = []

    def forward_then_reload(x, gen):
        out = forward(x, gen)
        if not calls:
            calls.append(gen.gen_id)
            p.reload(dirs["B"])  # lands between chunk 1 and chunk 2
        return out

    p._forward = forward_then_reload
    got, gen = p.probs_with_generation(images)
    assert gen == 0 and p.generation == 1
    np.testing.assert_array_equal(got, want_a)
    p._forward = forward
    np.testing.assert_array_equal(p.probs(images), want_b)


def test_no_request_fails_under_the_batcher_during_reload_and_rollback(
        members):
    sets, dirs, images = members
    _, p = _pair(members, ["serve.max_wait_ms=1"])
    by_gen = {0: p.probs(images)}
    batcher = p.make_batcher()
    stop = threading.Event()
    results, errors = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            lo = int(rng.integers(0, 10))
            try:
                f = batcher.submit(images[lo:lo + 2])
                results.append((lo, f.result(timeout=60)))
            except Exception as e:  # noqa: BLE001 - counted below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        p.reload(dirs["B"])
        by_gen[1] = p.probs(images)
        time.sleep(0.05)
        p.rollback()
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join()
        batcher.close()
    assert not errors and len(results) > 4
    for lo, rows in results:
        # Every response is one generation's rows (window co-riders share
        # the bucket of 8, as the direct scoring above does).
        assert any(np.allclose(rows, want[lo:lo + 2], rtol=0, atol=1e-6)
                   for want in by_gen.values()), lo
