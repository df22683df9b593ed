"""The port's autoscaler (``serve/scaler.py``), serving policy
(``serve/policy.py``) and escalation pool (``serve/router.py``), against
the JAX package's modules on the same inputs.

``scaler.decide`` gives the JAX decision and reason on the reference's
pinned sequences and on a seeded grid; ``derive_policy`` gives the same
payload and content version from the same frontier (SLO and v2
interactive-class cases included); an artifact sealed by either package
loads in the other; and a cascade over an ``EscalationPool`` counts
escalations and speculations as the JAX cascade over a JAX pool does."""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import cascade as jax_cascade
from jama16_retina_tpu.serve import policy as jax_policy
from jama16_retina_tpu.serve import router as jax_router
from jama16_retina_tpu.serve import scaler as jax_scaler
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.integrity.artifact import ArtifactCorrupt
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve import policy, scaler
from jama16_retina_tpu_torch.serve.cascade import CascadeEngine
from jama16_retina_tpu_torch.serve.router import EscalationPool

# ---------------------------------------------------------------------------
# The scaler
# ---------------------------------------------------------------------------


def _drive(lib, seq, active, limits, max_batch=8):
    state = lib.ScalerState()
    lim = lib.ScalerLimits(**limits)
    out = []
    for w, q, f, p in seq:
        d = lib.decide(lib.ScalerStats(w, queue_rows=q, in_flight_rows=f,
                                       p99_latency_s=p),
                       active, max_batch, state, lim)
        out.append((d.desired, d.reason, d.saturated,
                    d.state.hot_windows, d.state.quiet_windows))
        state, active = d.state, d.desired
    return out


HOT, QUIET, BAND = (1.0, 100.0, 8.0, 0.0), (1.0, 0.0, 0.0, 0.0), \
    (1.0, 1.0, 4.0, 0.0)
# The sequences of tests/test_router.py::test_scaler_decide_pinned_sequences.
SEQUENCES = {
    "hot_to_saturation": ([HOT] * 6, 1, {"min_replicas": 1,
                                         "max_replicas": 3}),
    "quiet_to_min": ([QUIET] * 5, 2, {"min_replicas": 1, "max_replicas": 3}),
    "band_resets": ([HOT, BAND, HOT, BAND], 1, {"max_replicas": 3}),
    "slo_breach": ([(1.0, 0.0, 3.0, 0.9)] * 2, 1,
                   {"max_replicas": 3, "slo_p99_s": 0.5}),
    "short_window": ([(0.01, 100.0, 8.0, 0.0)], 1, {"max_replicas": 3}),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_decide_equals_the_jax_scaler_on_the_pinned_sequences(name):
    seq, active, limits = SEQUENCES[name]
    got = _drive(scaler, seq, active, limits)
    assert got == _drive(jax_scaler, seq, active, limits)
    if name == "hot_to_saturation":
        assert [g[:3] for g in got] == [
            (1, "hot_streak", False), (2, "scale_up:queue", False),
            (2, "hot_streak", False), (3, "scale_up:queue", False),
            (3, "hot_streak", False), (3, "saturated_at_max", True)]


def test_decide_equals_the_jax_scaler_on_a_seeded_grid():
    rng = np.random.default_rng(7)
    n = 0
    for active, max_batch, hot, quiet, lo, hi, slo in itertools.product(
            (1, 2, 5), (1, 8, 64), (0, 1, 2), (0, 2, 3), (1, 2), (1, 3, 8),
            (0.0, 0.05)):
        stats = (float(rng.choice([0.01, 0.05, 1.0])),
                 float(rng.choice([0.0, 0.0, 3.0, 40.0, 400.0])),
                 float(rng.uniform(0, 2 * active * max_batch)),
                 float(rng.choice([0.0, 0.01, 0.03, 0.2])))
        args = [(lib.ScalerStats(stats[0], stats[1], stats[2], stats[3]),
                 active, max_batch,
                 lib.ScalerState(hot_windows=hot, quiet_windows=quiet),
                 lib.ScalerLimits(min_replicas=lo, max_replicas=hi,
                                  slo_p99_s=slo))
                for lib in (scaler, jax_scaler)]
        a, b = scaler.decide(*args[0]), jax_scaler.decide(*args[1])
        assert (a.desired, a.reason, a.saturated, a.state.hot_windows,
                a.state.quiet_windows) == (
            b.desired, b.reason, b.saturated, b.state.hot_windows,
            b.state.quiet_windows), (args[0], a, b)
        assert scaler.decide(*args[0]) == a
        n += 1
    assert n == 3 * 3 * 3 * 3 * 2 * 3 * 2
    for k in ("QUEUE_HIGH", "IN_FLIGHT_HIGH", "IN_FLIGHT_LOW",
              "HOT_WINDOWS", "QUIET_WINDOWS", "MIN_WINDOW_S"):
        assert getattr(scaler, k) == getattr(jax_scaler, k), k


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

# tests/test_router.py's frontier: bucket 16 is the knee, 32 the peak, and
# one point's rate is withheld.
FRONTIER = [
    {"bucket": 8, "concurrency": 1, "images_per_sec": 400.0,
     "p50_ms": 4.0, "p99_ms": 9.0},
    {"bucket": 8, "concurrency": 8, "images_per_sec": 600.0,
     "p50_ms": 6.0, "p99_ms": 14.0},
    {"bucket": 16, "concurrency": 8, "images_per_sec": 920.0,
     "p50_ms": 8.0, "p99_ms": 21.0},
    {"bucket": 32, "concurrency": 8, "images_per_sec": 1000.0,
     "p50_ms": 16.0, "p99_ms": 40.0},
    {"bucket": 32, "concurrency": 1, "images_per_sec": None,
     "p50_ms": 2.0, "p99_ms": 3.0},
]
# A frontier whose best interactive point sits at a large bucket (no
# int8) and one without p99s (no interactive class).
LARGE = [{"bucket": 16, "concurrency": 1, "images_per_sec": 300.0,
          "p50_ms": 30.0, "p99_ms": 31.0},
         {"bucket": 8, "concurrency": 4, "images_per_sec": 290.0,
          "p50_ms": 60.0, "p99_ms": 90.0}]
NO_P99 = [{"bucket": 8, "concurrency": 2, "images_per_sec": 50.0},
          {"bucket": 16, "concurrency": 2, "images_per_sec": 60.0,
           "p50_ms": 70.0}]
# The shape of a frontier chip_smoke.py phase 13e sweeps through the
# router (k = 2 float32 Inception-v3, buckets 8-64, concurrency 1 and 4).
CARD = [{"bucket": b, "concurrency": c, "images_per_sec": r, "p50_ms": p50,
         "p99_ms": p99}
        for b, c, r, p50, p99 in (
            (8, 1, 139.91, 52.072, 156.68), (8, 4, 162.782, 172.503, 303.196),
            (16, 1, 334.131, 43.921, 140.365),
            (16, 4, 339.712, 169.64, 245.831),
            (32, 1, 489.435, 59.658, 140.351),
            (32, 4, 515.127, 230.903, 311.776),
            (64, 1, 590.519, 102.486, 156.445),
            (64, 4, 603.817, 401.301, 466.091))]
FP = {"arch": "tiny_cnn", "image_size": 64, "head": "binary", "n_devices": 1}
CASES = {
    "knee": (FRONTIER, {}),
    "source": (FRONTIER, {"source": {"bench_json": "x.json"}}),
    "slo": (FRONTIER, {"slo_p99_ms": 15.0}),
    "slo_unsatisfiable": (FRONTIER, {"slo_p99_ms": 1.0}),
    "interactive_target": (FRONTIER, {"slo_p99_ms": 25.0,
                                      "target_images_per_sec": 700.0}),
    "interactive_target_unmet": (FRONTIER, {"target_images_per_sec": 1e6}),
    "large_interactive_bucket": (LARGE, {}),
    "no_p99": (NO_P99, {}),
    "card_frontier": (CARD, {}),
    "card_frontier_slo": (CARD, {"slo_p99_ms": 150.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_derive_policy_payload_and_version_equal_the_jax_policy(case):
    frontier, kw = CASES[case]
    got = policy.derive_policy(frontier, FP, **kw)
    want = jax_policy.derive_policy(frontier, FP, **kw)
    assert got.payload() == want.payload()
    assert got.version == want.version
    assert got.version.startswith(f"sp{policy.VERSION}-")
    if case == "knee":
        assert (got.max_batch, got.bucket_sizes, got.max_wait_ms,
                got.shed_in_flight, got.shed_queue_depth) == (
            16, (8, 16), 4.0, 32, 64)
        assert got.classes["interactive"]["dtype"] == "int8"
    if case == "slo":
        assert got.max_batch == 8
    if case == "no_p99":
        assert "interactive" not in got.classes


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_artifact_sealed_by_either_package_loads_in_the_other(
        writer, tmp_path):
    path = str(tmp_path / "policy.json")
    src = {"bench_json": "b.json"}
    if writer == "port":
        policy.save_policy(path, policy.derive_policy(FRONTIER, FP,
                                                      source=src))
    else:
        jax_policy.save_policy(path, jax_policy.derive_policy(
            FRONTIER, FP, source=src))
    got, want = policy.load_policy(path), jax_policy.load_policy(path)
    assert got.payload() == want.payload() and got.version == want.version
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # Byte-identical files from the two writers.
    other = str(tmp_path / "other.json")
    (jax_policy if writer == "port" else policy).save_policy(
        other, got if writer == "jax" else want)
    assert open(path).read() == open(other).read()


def _cfg(lib, *overrides):
    return lib.override(lib.get_config("smoke"),
                        ["model.image_size=64", *overrides])


def test_stale_foreign_torn_and_corrupt_artifacts_are_refused(tmp_path):
    path = str(tmp_path / "policy.json")
    policy.save_policy(path, policy.derive_policy(FRONTIER, FP))
    loaded = policy.load_policy(path)
    policy.check_fingerprint(loaded, _cfg(configs), n_devices=1, path=path)
    for cfg, n in ((_cfg(configs, "model.image_size=128"), 1),
                   (_cfg(configs), 8)):
        with pytest.raises(policy.PolicyStale, match="derive_policy"):
            policy.check_fingerprint(loaded, cfg, n_devices=n, path=path)
        with pytest.raises(jax_policy.PolicyStale):
            jax_policy.check_fingerprint(
                jax_policy.load_policy(path),
                _cfg(jax_configs, f"model.image_size={cfg.model.image_size}"),
                n_devices=n, path=path)
    bad = tmp_path / "bad.json"
    for text, match in (
            (json.dumps({"format": policy.FORMAT, "version": 1,
                         "max_batch": 8}), "torn|incomplete"),
            ("{not json", "cannot read"),
            (json.dumps({"format": "other", "version": 9}), "reads")):
        bad.write_text(text)
        with pytest.raises(policy.PolicyStale, match=match):
            policy.load_policy(str(bad))
        with pytest.raises(jax_policy.PolicyStale):
            jax_policy.load_policy(str(bad))
    doc = json.loads(open(path).read())
    doc["max_batch"] = 64
    bad.write_text(json.dumps(doc))
    with pytest.raises(ArtifactCorrupt, match="derive_policy"):
        policy.load_policy(str(bad))


@pytest.mark.parametrize("hand", [
    [], ["serve.max_batch=4", "serve.bucket_sizes=4"],
    ["serve.dtype=bf16", "serve.max_wait_ms=2.5", "serve.router_fusion=true"],
    ["serve.shed_in_flight=3", "serve.shed_queue_depth=5",
     "serve.fused_preprocess=true", "serve.cascade_speculative=true"]])
def test_apply_policy_fills_defaults_as_the_jax_policy_does(hand):
    """Hand-set knobs win, field by field, in both packages."""
    pol = policy.derive_policy(FRONTIER, FP)
    got_cfg, got = policy.apply_policy(_cfg(configs, *hand), pol)
    want_cfg, want = jax_policy.apply_policy(
        _cfg(jax_configs, *hand), jax_policy.derive_policy(FRONTIER, FP))
    assert got == want
    for f in dataclasses.fields(got_cfg.serve):
        assert getattr(got_cfg.serve, f.name) == getattr(want_cfg.serve,
                                                         f.name), f.name
    if not hand:
        assert got_cfg.serve.max_batch == 16 and "dtype" in got


def test_maybe_apply_policy_provenance_and_refusal(tmp_path):
    path = str(tmp_path / "p.json")
    pol = policy.derive_policy(FRONTIER, FP, source={"bench_json": "b.json"})
    policy.save_policy(path, pol)
    cfg, prov = policy.maybe_apply_policy(
        _cfg(configs, f"serve.policy_from={path}"))
    _, want = jax_policy.maybe_apply_policy(
        _cfg(jax_configs, f"serve.policy_from={path}"))
    assert prov == want
    assert prov["version"] == pol.version and cfg.serve.max_batch == 16
    plain = _cfg(configs)
    same, empty = policy.maybe_apply_policy(plain)
    assert same is plain and empty == {}
    with pytest.raises(policy.PolicyStale):
        policy.maybe_apply_policy(_cfg(configs, "model.image_size=32",
                                       f"serve.policy_from={path}"))


def test_derive_policy_refuses_an_empty_frontier():
    for lib in (policy, jax_policy):
        with pytest.raises(ValueError, match="no usable points"):
            lib.derive_policy([{"bucket": 8, "concurrency": 1,
                                "images_per_sec": None}], FP)
        with pytest.raises(ValueError, match="serve_frontier"):
            lib.frontier_from_bench_json({"metric": "x"})
    bench = {"parsed": {"serve_frontier": FRONTIER}}
    assert policy.frontier_from_bench_json(bench) == FRONTIER


# ---------------------------------------------------------------------------
# The escalation pool behind cascades
# ---------------------------------------------------------------------------


class _Stub:
    """Fixed scores keyed by row index (a row's first value); records
    each call's indices."""

    def __init__(self, scores, generation=0):
        self.scores = np.asarray(scores, np.float64)
        self.generation = generation
        self.calls = []

    def probs(self, rows):
        idx = np.asarray(rows).reshape(len(rows), -1)[:, 0].astype(int)
        self.calls.append(idx.tolist())
        return self.scores[idx]


def _rows(n):
    return np.broadcast_to(np.arange(n, dtype=np.uint8)[:, None, None, None],
                           (n, 1, 1, 3)).copy()


def _multi(referable):
    """5-class distributions whose P(grade >= 2) is ``referable``."""
    r = np.asarray(referable, np.float64)[:, None]
    return np.concatenate([(1 - r) * [0.6, 0.4], r * [0.5, 0.3, 0.2]], 1)


# test_torch_cascade.py's stub scenarios.
SCENARIOS = {
    "band": ([0.1, 0.48, 0.52, 0.9, 0.5], [0.9, 0.8, 0.7, 0.6, 0.5],
             ["serve.cascade_band=0.05", "serve.cascade_thresholds=0.5"]),
    "two_thresholds": ([0.2, 0.86, 0.5, 0.97], [0.0, 0.1, 0.2, 0.3],
                       ["serve.cascade_band=0.02",
                        "serve.cascade_thresholds=0.87,0.98"]),
    "band_0": ([0.1, 0.4, 0.5, 0.9], [0.7] * 4,
               ["serve.cascade_band=0", "serve.cascade_thresholds=0.5"]),
    "band_0_no_hit": ([0.1, 0.4, 0.6, 0.9], [0.7] * 4,
                      ["serve.cascade_band=0"]),
    "band_covers_0_1": ([0.1, 0.4, 0.6, 0.9], [0.5] * 4,
                        ["serve.cascade_band=1.0"]),
    "multi_head": (_multi([0.1, 0.47, 0.55, 0.9]), _multi([0.3] * 4),
                   ["serve.cascade_band=0.05"]),
}
POOL_COUNTERS = ("serve.router.escalations", "serve.router.speculations",
                 "serve.cascade.escalated_rows", "serve.cascade.speculated",
                 "serve.cascade.speculated.wasted")


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["serial", "speculative"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_pool_counters_equal_the_jax_cascade_over_a_jax_pool(scenario,
                                                             speculative):
    """Serially the pool counts the escalated rows; under speculation the
    whole batch goes to ``serve.router.speculations`` and the band's rows
    are credited to ``serve.router.escalations``, as in JAX."""
    student, ensemble, overrides = SCENARIOS[scenario]
    overrides = overrides + [f"serve.cascade_speculative={speculative}"]
    rows = _rows(len(student))
    snaps, outs, calls = [], [], []
    for lib, cascade_cls, pool_cls, reg_cls in (
            (configs, CascadeEngine, EscalationPool, Registry),
            (jax_configs, jax_cascade.CascadeEngine,
             jax_router.EscalationPool, JaxRegistry)):
        reg = reg_cls()
        members = [_Stub(ensemble, 3), _Stub(ensemble, 5)]
        pool = pool_cls(members, registry=reg)
        assert pool.generation == 5
        casc = cascade_cls(lib.override(lib.get_config("smoke"), overrides),
                           _Stub(student), pool, registry=reg)
        try:
            outs.append(casc.probs(rows))
        finally:
            casc.close()
        c = reg.snapshot()["counters"]
        snaps.append({k: c.get(k, 0) for k in POOL_COUNTERS})
        calls.append(sorted(sum((m.calls for m in members), [])))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert snaps[0] == snaps[1]
    assert calls[0] == calls[1]
    got = snaps[0]
    assert got["serve.router.escalations"] == got[
        "serve.cascade.escalated_rows"]
    assert got["serve.router.speculations"] == (
        len(student) if speculative else 0)


def test_pool_routes_to_the_least_loaded_member_and_refuses_none():
    import threading

    gate = threading.Event()

    class Gated(_Stub):
        def probs(self, rows):
            out = super().probs(rows)
            gate.wait(timeout=30)
            return out

    a, b = Gated([0.5] * 4), Gated([0.5] * 4)
    reg = Registry()
    pool = EscalationPool([a, b], registry=reg)
    threads = [threading.Thread(target=pool.probs, args=(_rows(2),))
               for _ in range(2)]
    threads[0].start()
    while not a.calls:
        threads[0].join(0.005)
    threads[1].start()
    while not b.calls:
        threads[1].join(0.005)
    gate.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert len(a.calls) == len(b.calls) == 1
    assert reg.counter("serve.router.escalations").value == 4
    assert "serve.router.speculations" not in reg.snapshot()["counters"]
    with pytest.raises(ValueError, match="at least one"):
        EscalationPool([], registry=reg)
