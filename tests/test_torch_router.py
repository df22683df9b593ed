"""The port's front-door router (``serve/router.py``) and cross-tenant
fusion (``serve/fusion.py``), against the JAX package's Router on the same
numpy inputs.

Over stub replicas (a deterministic row function, as the reference's own
router tests use) each scenario runs through both routers and gives the
same rows, segments, counters and errors: re-binning, splitting, the
dispatch policies, class-aware shedding, interactive-first binning,
deadline expiry, a replica's death with zero failed requests,
``NoReplicasLeft``, drain, tenants and the grouped mixed bin. The
replica's death goes through the ``serve.router.dispatch`` fault site,
each router under its own package's plan; ``all_dead`` and
``no_replicas_left`` keep a stub that raises from its Nth call.

Over real smoke engines (``tiny_cnn``, 64 px, float32, converted
weights, torch on one thread): the port Router is within 1e-5 of the JAX
Router over JAX engines and bitwise the port engine at one replica; the
predict CLI's ``--replicas 1`` JSONL is byte-identical to its direct
path; a fused bin is bitwise each tenant's direct rows at one bucket with
members in turn (within 1e-5 under ``serve.member_parallel``) and runs
one preprocess; ``FusionCache`` is bin-order invariant and never crosses
keys under 8 threads; a fused bin feeds each tenant's quality monitor
what its direct call does; and one engine is safe to share between
threads."""

import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.obs import faultinject as jax_faultinject
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import router as jax_router
from jama16_retina_tpu_torch import configs, models, predict
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import faultinject, quality
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import fusion
from jama16_retina_tpu_torch.serve import router as port_router
from jama16_retina_tpu_torch.serve.engine import ServingEngine, _Generation
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, stacked_state

IMPLS = {"port": (port_router, configs, Registry),
         "jax": (jax_router, jax_configs, JaxRegistry)}
# Each router's fault plane.
FAULTS = {port_router: faultinject, jax_router: jax_faultinject}


def _ref(rows: np.ndarray) -> np.ndarray:
    """The stubs' row function."""
    return rows.reshape(rows.shape[0], -1).astype(np.float64).sum(axis=1)


class StubReplica:
    """A deterministic replica: optional delay (sleep frees the
    interpreter, so replicas overlap) and optional gate holding its rows
    in flight."""

    def __init__(self, rid: int, delay_s: float = 0.0, gate=None):
        self.rid = rid
        self.generation = 100 + rid
        self.delay_s = delay_s
        self.gate = gate
        self.calls = 0

    def probs(self, rows):
        self.calls += 1
        if self.gate is not None:
            self.gate.wait(timeout=30)
        if self.delay_s:
            time.sleep(self.delay_s)
        return _ref(rows)


class FailingStub(StubReplica):
    """Raises from its ``fail_from``-th call on: a replica that dies."""

    def __init__(self, rid: int, fail_from: int, **kw):
        super().__init__(rid, **kw)
        self.fail_from = fail_from

    def probs(self, rows):
        if self.calls + 1 >= self.fail_from:
            self.calls += 1
            raise RuntimeError(f"replica {self.rid} died")
        return super().probs(rows)


class ScaledStub(StubReplica):
    """A second tenant's row function (3x), so crosstalk shows."""

    def probs(self, rows):
        return np.asarray(super().probs(rows)) * 3.0


def _cfg(lib, **serve_kw):
    base = dict(max_batch=8, bucket_sizes=(4, 8), max_wait_ms=5.0,
                router_tick_ms=1.0)
    base.update(serve_kw)
    cfg = lib.get_config("smoke")
    return cfg.replace(serve=dataclasses.replace(cfg.serve, **base))


def _counters(reg, names):
    c = reg.snapshot()["counters"]
    return {n: c.get(n, 0) for n in names}


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# Stub scenarios, each run through both routers
# ---------------------------------------------------------------------------


def s_rebin(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib),
                        engines=[StubReplica(0), StubReplica(1)],
                        registry=reg)
    submitted, lock = [], threading.Lock()

    def client(w):
        rng = np.random.default_rng(100 + w)
        for i in range(8):
            n = int(rng.integers(1, 13))
            rows = rng.integers(0, 256, (n, 4, 4, 3), np.uint8)
            f = router.submit(
                rows, priority="batch" if (w + i) % 2 else "interactive")
            with lock:
                submitted.append((rows, f))

    threads = [threading.Thread(target=client, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    ok = True
    for rows, f in submitted:
        ok &= np.array_equal(f.result(timeout=30), _ref(rows))
        segs = f.segments
        ok &= segs[0]["lo"] == 0 and segs[-1]["hi"] == rows.shape[0]
        ok &= all(a["hi"] == b["lo"] for a, b in zip(segs, segs[1:]))
        ok &= all(s["generation"] == 100 + s["replica"] for s in segs)
    out = {"ok": bool(ok), "requests": len(submitted),
           "split_some": reg.counter("serve.router.rebins").value >= 1,
           **_counters(reg, ("serve.router.request_failures",
                             "serve.router.requests.interactive",
                             "serve.router.requests.batch"))}
    router.close()
    return out


def s_split(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib, max_wait_ms=1.0),
                        engines=[StubReplica(0), StubReplica(1)],
                        registry=reg)
    rows = np.random.default_rng(3).integers(0, 256, (30, 4, 4, 3), np.uint8)
    f = router.submit(rows)
    out = {"rows": f.result(timeout=30).tolist(),
           "segments": [(s["lo"], s["hi"]) for s in f.segments],
           **_counters(reg, ("serve.router.rebins", "serve.router.dispatches",
                             "serve.router.rows"))}
    router.close()
    return out


def s_validation(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib), engines=[StubReplica(0)],
                        registry=reg)
    errs = [
        _err(lambda: router.submit(np.ones((1, 2, 2, 3), np.uint8),
                                   priority="bulk")),
        _err(lambda: router.submit(np.zeros((0, 2, 2, 3), np.uint8))),
        _err(lambda: router.submit(np.ones((1, 2, 2, 3), np.uint8),
                                   model="zebra"))]
    ok = router.submit(np.ones((2, 4, 4, 3), np.uint8))
    errs += [_err(lambda: router.submit(np.ones((2, 2, 2, 3), np.uint8))),
             _err(lambda: router.submit(np.ones((2, 4, 4, 3), np.float32)))]
    after = router.submit(np.full((3, 4, 4, 3), 5, np.uint8))
    results = [ok.result(timeout=30).tolist(),
               after.result(timeout=30).tolist()]
    router.close()
    errs.append(_err(lambda: router.submit(np.ones((1, 4, 4, 3), np.uint8))))
    errs.append(_err(lambda: router.drain_replica(0)))
    for kw in ({"router_policy": "round_robin"},
               {"router_batch_shed_frac": 0.0},
               {"router_batch_shed_frac": 1.5}):
        errs.append(_err(lambda: lib.Router(_cfg(cfg_lib, **kw),
                                            engines=[StubReplica(0)],
                                            registry=reg_cls())))
    errs.append(_err(lambda: lib.Router(_cfg(cfg_lib), registry=reg_cls())))
    return {"errors": errs, "results": results,
            **_counters(reg, ("serve.router.rejected_at_close",))}


def s_policies(lib, cfg_lib, reg_cls):
    out = {}
    for policy in lib.DISPATCH_POLICIES:
        reg = reg_cls()
        router = lib.Router(_cfg(cfg_lib, router_policy=policy),
                            engines=[StubReplica(0)], registry=reg)
        reps = []
        for rid, in_flight, buckets in ((0, 16, {8}), (1, 4, set()),
                                        (2, 4, set()), (3, 6, {8}),
                                        (4, 8, {8})):
            rep = lib._Replica(rid, StubReplica(rid), reg)
            rep.in_flight_rows = in_flight
            rep.buckets_served = set(buckets)
            reps.append(rep)
        picks = []
        for bucket in (8, 4):
            b = lib._Bin(np.zeros((bucket, 2, 2, 3), np.uint8), [], bucket)
            picks.append(router._choose_replica_locked(reps, b).rid)
            reps[1].in_flight_rows += 1
            picks.append(router._choose_replica_locked(reps, b).rid)
            reps[1].in_flight_rows -= 1
        out[policy] = picks
        router.close()
    return out


def s_shed(lib, cfg_lib, reg_cls):
    gate = threading.Event()
    reg = reg_cls()
    router = lib.Router(
        _cfg(cfg_lib, router_shed_rows=32, router_batch_shed_frac=0.5,
             max_wait_ms=1.0),
        engines=[StubReplica(0, gate=gate)], registry=reg)
    try:
        held = [router.submit(np.ones((8, 2, 2, 3), np.uint8))
                for _ in range(2)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with router._work:
                if router._in_flight_rows + router._queued_rows >= 16:
                    break
            time.sleep(0.005)
        shed = _err(lambda: router.submit(np.ones((8, 2, 2, 3), np.uint8),
                                          priority="batch"))
        admitted = router.submit(np.ones((8, 2, 2, 3), np.uint8),
                                 priority="interactive")
        over = _err(lambda: router.submit(np.ones((17, 2, 2, 3), np.uint8),
                                          priority="interactive"))
        gate.set()
        for f in held + [admitted]:
            f.result(timeout=30)
    finally:
        gate.set()
        router.close()
    return {"shed": shed, "over": over,
            **_counters(reg, ("serve.router.shed.batch",
                              "serve.router.shed.interactive"))}


def s_interactive_first(lib, cfg_lib, reg_cls):
    gate = threading.Event()
    reg = reg_cls()
    router = lib.Router(
        _cfg(cfg_lib, bucket_sizes=(8,), max_batch=8, max_wait_ms=200.0),
        engines=[StubReplica(0, gate=gate)], registry=reg)
    try:
        lead = router.submit(np.ones((8, 2, 2, 3), np.uint8))
        time.sleep(0.05)
        f_batch = router.submit(np.full((4, 2, 2, 3), 2, np.uint8),
                                priority="batch")
        f_inter = router.submit(np.full((4, 2, 2, 3), 3, np.uint8),
                                priority="interactive")
        time.sleep(0.05)
        gate.set()
        rows = [f.result(timeout=30).tolist()
                for f in (lead, f_batch, f_inter)]
    finally:
        gate.set()
        router.close()
    return {"rows": rows, **_counters(reg, (
        "serve.router.dispatches", "serve.router.requests.interactive",
        "serve.router.requests.batch"))}


def s_deadline(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    stub = StubReplica(0)
    router = lib.Router(_cfg(cfg_lib, bucket_sizes=(8,), max_batch=8,
                             max_wait_ms=500.0), engines=[stub], registry=reg)
    f = router.submit(np.ones((2, 2, 2, 3), np.uint8), deadline_ms=1.0)
    err = _err(lambda: f.result(timeout=30))
    router.close()
    return {"error": err[0], "calls": stub.calls,
            **_counters(reg, ("serve.router.shed.deadline",))}


def s_replica_death(lib, cfg_lib, reg_cls):
    """The 3rd bin dispatched dies at the ``serve.router.dispatch`` site:
    its replica is marked failed and its bins retry on siblings."""
    fault = FAULTS[lib]
    reg = reg_cls()
    router = lib.Router(
        _cfg(cfg_lib, bucket_sizes=(8,), max_batch=8, max_wait_ms=1.0),
        engines=[StubReplica(r, delay_s=0.002) for r in range(4)],
        registry=reg)
    plan = fault.plan_from_spec({"serve.router.dispatch": {
        "kind": "error", "error": "RuntimeError", "on_calls": [3],
        "message": "replica died"}})
    prev = fault.arm(plan)
    submitted, lock = [], threading.Lock()

    def storm(w):
        rng = np.random.default_rng(w)
        for i in range(10):
            rows = rng.integers(0, 256, (8, 2, 2, 3), np.uint8)
            f = router.submit(rows,
                              priority="interactive" if i % 2 else "batch")
            with lock:
                submitted.append((rows, f))

    try:
        threads = [threading.Thread(target=storm, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        ok = all(np.array_equal(f.result(timeout=30), _ref(rows))
                 and all(s["generation"] == 100 + s["replica"]
                         for s in f.segments)
                 for rows, f in submitted)
    finally:
        fault.arm(prev)
    states = {r["replica"]: r for r in router.replica_states()}
    counters = reg.snapshot()["counters"]
    out = {"ok": ok, "requests": len(submitted),
           "failed": sorted(r["generation"] for r in states.values()
                            if r["state"] == lib.FAILED),
           "retried_some": reg.counter("serve.router.retried_bins").value
           >= 1,
           "fires": plan.counts()["serve.router.dispatch"]["fires"],
           "replica_failures_by_replica": sum(
               counters.get(f"serve.replica{r}.failures", 0)
               for r in range(4)),
           **_counters(reg, ("serve.router.replica_failures",
                             "serve.router.request_failures"))}
    router.close()
    return out


def s_all_dead(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    router = lib.Router(
        _cfg(cfg_lib, bucket_sizes=(8,), max_batch=8, max_wait_ms=1.0),
        engines=[FailingStub(0, 1), FailingStub(1, 1)], registry=reg)
    f = router.submit(np.ones((8, 2, 2, 3), np.uint8))
    err = _err(lambda: f.result(timeout=30))
    later = _err(lambda: router.submit(
        np.ones((8, 2, 2, 3), np.uint8)).result(timeout=30))
    router.close()
    return {"error": err[0], "later": later,
            **_counters(reg, ("serve.router.request_failures",
                              "serve.router.replica_failures",
                              "serve.router.retried_bins"))}


def s_no_replicas_left(lib, cfg_lib, reg_cls):
    """Tenant b's only replica dies: its first request fails with the
    replica's error, its next with NoReplicasLeft; tenant a serves on."""
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib, max_wait_ms=1.0),
                        engines={"a": [StubReplica(0)],
                                 "b": [FailingStub(1, 1)]}, registry=reg)
    rows = np.ones((4, 2, 2, 3), np.uint8)
    first = _err(lambda: router.submit(rows, model="b").result(timeout=30))
    second = _err(lambda: router.submit(rows, model="b").result(timeout=30))
    a = router.submit(rows, model="a").result(timeout=30).tolist()
    router.close()
    return {"first": first, "second": second[0], "a": a,
            **_counters(reg, ("serve.router.request_failures",))}


def s_drain(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    router = lib.Router(
        _cfg(cfg_lib, bucket_sizes=(8,), max_batch=8, max_wait_ms=1.0),
        engines=[StubReplica(0), StubReplica(1)], registry=reg)
    pre = [router.submit(np.ones((8, 2, 2, 3), np.uint8)) for _ in range(6)]
    router.drain_replica(1)
    post = [router.submit(np.full((8, 2, 2, 3), 7, np.uint8))
            for _ in range(6)]
    for f in pre + post:
        f.result(timeout=30)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router.replica_states()[1]["state"] == lib.DRAINED:
            break
        time.sleep(0.01)
    st = router.replica_states()[1]
    more = router.submit(np.ones((8, 2, 2, 3), np.uint8))
    more.result(timeout=30)
    out = {"state": st["state"], "generation": st["generation"],
           "in_flight": st["in_flight_rows"],
           "post_on_0": all(s["replica"] == 0 for f in post + [more]
                            for s in f.segments),
           "rows_frozen": router.replica_states()[1]["rows"] == st["rows"],
           "last": _err(lambda: router.drain_replica(0))}
    router.close()
    return out


def s_tenants(lib, cfg_lib, reg_cls):
    rng = np.random.default_rng(5)
    rows_a = rng.integers(0, 256, (6, 2, 2, 3), np.uint8)
    rows_b = rng.integers(0, 256, (6, 2, 2, 3), np.uint8)
    router = lib.Router(_cfg(cfg_lib), engines={"a": [StubReplica(0)],
                                                "b": [ScaledStub(1)]},
                        registry=reg_cls())
    fa, fb = router.submit(rows_a, model="a"), router.submit(rows_b,
                                                             model="b")
    out = {"a": fa.result(timeout=30).tolist(),
           "b": fb.result(timeout=30).tolist(),
           "seg_a": sorted({(s["model"], s["generation"])
                            for s in fa.segments}),
           "seg_b": sorted({(s["model"], s["generation"])
                            for s in fb.segments}),
           "models": sorted(router.report()["models"])}
    router.close()
    return out


def s_grouped_mixed_bin(lib, cfg_lib, reg_cls):
    rng = np.random.default_rng(6)
    rows_a = rng.integers(0, 256, (4, 2, 2, 3), np.uint8)
    rows_b = rng.integers(0, 256, (4, 2, 2, 3), np.uint8)
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib, bucket_sizes=(8,), max_wait_ms=100.0,
                             router_fusion=True),
                        engines={"a": [StubReplica(0)], "b": [ScaledStub(1)]},
                        registry=reg)
    fa, fb = router.submit(rows_a, model="a"), router.submit(rows_b,
                                                             model="b")
    out = {"a": fa.result(timeout=30).tolist(),
           "b": fb.result(timeout=30).tolist(),
           "segs": [[(s["lo"], s["hi"], s["model"], s["replica"],
                      s["generation"]) for s in f.segments]
                    for f in (fa, fb)],
           **_counters(reg, ("serve.router.fused_bins",
                             "serve.router.fused_rows",
                             "serve.router.dispatches"))}
    router.close()
    return out


def s_report(lib, cfg_lib, reg_cls):
    reg = reg_cls()
    prov = {"path": "p.json", "version": "sp2-x", "applied": ["max_batch"],
            "source": {}}
    router = lib.Router(_cfg(cfg_lib), engines=[StubReplica(0),
                                                StubReplica(1)],
                        registry=reg, policy_provenance=prov)
    for _ in range(4):
        router.submit(np.ones((8, 2, 2, 3), np.uint8)).result(timeout=30)
    rep = router.report()
    router.close()
    rep["replicas"] = [{k: v for k, v in r.items()
                        if k not in ("rows", "buckets")}
                       for r in rep["replicas"]]
    rep["scaler"] = len(rep["scaler"])
    return rep


def s_retire(lib, cfg_lib, reg_cls):
    """A drained replica's namespace retires once REPLICA_ROWS_KEEP newer
    replicas exist; an active one's stays."""
    reg = reg_cls()
    router = lib.Router(_cfg(cfg_lib), engines=[StubReplica(0),
                                                StubReplica(1)],
                        registry=reg)
    router.drain_replica(0)
    with router._work:
        for rid in range(2, 2 + router.REPLICA_ROWS_KEEP - 1):
            router._add_replica_locked(StubReplica(rid))
    names = set(reg.snapshot()["counters"]) | set(reg.snapshot()["gauges"])
    router.close()
    return {"replica0": sorted(n for n in names
                               if n.startswith("serve.replica0.")),
            "replica1": sorted(n for n in names
                               if n.startswith("serve.replica1.")),
            "states": [r["state"] for r in router.replica_states()]}


SCENARIOS = {
    "rebin": s_rebin, "split": s_split, "validation": s_validation,
    "policies": s_policies, "shed": s_shed,
    "interactive_first": s_interactive_first, "deadline": s_deadline,
    "replica_death": s_replica_death, "all_dead": s_all_dead,
    "no_replicas_left": s_no_replicas_left, "drain": s_drain,
    "tenants": s_tenants, "grouped_mixed_bin": s_grouped_mixed_bin,
    "report": s_report, "retire": s_retire,
}
EXPECT = {
    "rebin": {"ok": True, "split_some": True, "requests": 32,
              "serve.router.request_failures": 0},
    "split": {"segments": [(0, 8), (8, 16), (16, 24), (24, 30)],
              "serve.router.rebins": 1, "serve.router.dispatches": 4},
    "policies": {"least_in_flight": [1, 2, 1, 2],
                 "bucket_affinity": [3, 3, 1, 2]},
    "shed": {"serve.router.shed.batch": 1,
             "serve.router.shed.interactive": 1},
    "interactive_first": {"serve.router.dispatches": 2},
    "deadline": {"error": "DeadlineExceeded", "calls": 0,
                 "serve.router.shed.deadline": 1},
    "replica_death": {"ok": True, "requests": 40, "failed": [None],
                      "retried_some": True, "fires": 1,
                      "replica_failures_by_replica": 1,
                      "serve.router.replica_failures": 1,
                      "serve.router.request_failures": 0},
    "all_dead": {"error": "RuntimeError"},
    "no_replicas_left": {"second": "NoReplicasLeft"},
    "drain": {"state": "drained", "generation": None, "in_flight": 0,
              "post_on_0": True, "rows_frozen": True},
    "grouped_mixed_bin": {"serve.router.fused_bins": 1,
                          "serve.router.fused_rows": 8},
    "retire": {"replica0": [], "replica1": [
        "serve.replica1.dispatches", "serve.replica1.failures",
        "serve.replica1.in_flight_rows", "serve.replica1.rows"]},
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_stub_router_equals_the_jax_router(name):
    got = SCENARIOS[name](*IMPLS["port"])
    want = SCENARIOS[name](*IMPLS["jax"])
    assert got == want
    for k, v in EXPECT.get(name, {}).items():
        assert got[k] == v, (k, got[k])


def test_scaler_scales_up_under_a_burst_then_drains_when_quiet():
    reg = Registry()
    built = []

    def factory(rid):
        built.append(rid)
        return StubReplica(rid, delay_s=0.02)

    router = port_router.Router(
        _cfg(configs, bucket_sizes=(8,), max_batch=8, max_wait_ms=1.0,
             router_replicas=1, scaler_min_replicas=1,
             scaler_max_replicas=2, scaler_window_s=0.1,
             router_shed_rows=64),
        replica_factory=factory, registry=reg)
    stop = threading.Event()

    def load():
        # The shed threshold bounds the backlog the burst leaves behind.
        while not stop.is_set():
            try:
                router.submit(np.ones((8, 2, 2, 3), np.uint8))
            except port_router.Overloaded:
                pass
            time.sleep(0.001)

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 15
    while (time.monotonic() < deadline
           and reg.gauge("serve.router.active_replicas").value < 2):
        time.sleep(0.02)
    grew = reg.gauge("serve.router.active_replicas").value >= 2
    stop.set()
    for t in threads:
        t.join(30)
    assert grew and built == [0, 1]
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not any(
            r["state"] in ("draining", "drained")
            for r in router.replica_states()):
        time.sleep(0.05)
    assert any(r["state"] in ("draining", "drained")
               for r in router.replica_states())
    assert reg.counter("serve.scaler.scale_ups").value >= 1
    assert reg.counter("serve.scaler.scale_downs").value >= 1
    ledger = router.scaler_ledger()
    assert any(d["reason"].startswith("scale_up") for d in ledger)
    assert any(d["reason"] == "scale_down:quiet" for d in ledger)
    router.close()


# ---------------------------------------------------------------------------
# Real smoke engines
# ---------------------------------------------------------------------------

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=8", "serve.bucket_sizes=4,8",
         "serve.router_tick_ms=1"]
SIZE = 64


def _configs(overrides):
    return (jax_configs.override(jax_configs.get_config("smoke"), overrides),
            configs.override(configs.get_config("smoke"), overrides))


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Four random tiny_cnn members (flat trees, converted state dicts and
    port member dirs for the first two), JAX engines over members 0-1,
    and 12 images."""
    jcfg, pcfg = _configs(SMOKE)
    jmodel = jax_models.build(jcfg.model)
    flats = [random_flat(jmodel, (2, SIZE, SIZE, 3), seed=60 + m)
             for m in range(4)]
    model = models.build(pcfg.model)
    sds = [convert.flax_to_torch(f, model) for f in flats]
    root = tmp_path_factory.mktemp("router_members")
    for m in range(2):
        ckpt_lib.save_member(str(root / f"member_{m:02d}"), flats[m])
    images = np.random.default_rng(0).integers(0, 256, (12, SIZE, SIZE, 3),
                                               np.uint8)
    j_engine = jax_engine.ServingEngine(jcfg, model=jmodel,
                                        state=stacked_state(flats[:2]),
                                        registry=JaxRegistry())
    return {"flats": flats, "sds": sds, "root": root, "images": images,
            "j_engine": j_engine, "j_model": jmodel}


def _port_engine(smoke, members, *overrides, registry=None):
    _, pcfg = _configs(SMOKE + list(overrides))
    return ServingEngine(pcfg, state_dicts=[smoke["sds"][m] for m in members],
                         device="cpu",
                         registry=registry if registry else Registry())


def _blocks(router, imgs, block, step=None):
    return [router.submit(imgs[i:i + block])
            for i in range(0, len(imgs), step or block)]


def test_router_over_port_engines_within_1e5_of_the_jax_router(smoke):
    """Blocks of 8 through one replica: the port is within 1e-5 of the JAX
    Router over the JAX engine on the same weights and images, and
    bitwise the port engine's direct scoring; every segment names the
    engine's generation."""
    imgs = smoke["images"]
    jcfg, pcfg = _configs(SMOKE)
    eng = _port_engine(smoke, (0, 1))
    direct = eng.probs(imgs)
    router = port_router.Router(pcfg, engines=[eng], registry=Registry())
    futs = _blocks(router, imgs, 8)
    got = np.concatenate([f.result(timeout=120) for f in futs])
    router.close()
    jrouter = jax_router.Router(jcfg, engines=[smoke["j_engine"]],
                                registry=JaxRegistry())
    want = np.concatenate([np.asarray(f.result(timeout=120))
                           for f in _blocks(jrouter, imgs, 8)])
    jrouter.close()
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(s["generation"] == eng.generation for f in futs
               for s in f.segments)


def test_two_port_replicas_give_each_block_the_engines_rows(smoke):
    """Overlapping blocks over two replicas of the same members: whichever
    replica a bin lands on, a block's rows are bitwise the engine's
    scoring of that block."""
    imgs = smoke["images"]
    _, pcfg = _configs(SMOKE)
    a, b = _port_engine(smoke, (0, 1)), _port_engine(smoke, (0, 1))
    router = port_router.Router(pcfg, engines=[a, b], registry=Registry())
    futs = _blocks(router, imgs, 8, step=4)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=120),
                                      a.probs(imgs[4 * i:4 * i + 8]))
    used = {s["replica"] for f in futs for s in f.segments}
    router.close()
    assert used <= {0, 1} and used


@pytest.fixture(scope="module")
def fundus_dir(tmp_path_factory):
    import cv2

    from jama16_retina_tpu_torch.data import synthetic

    imgdir = tmp_path_factory.mktemp("router_imgs")
    for i in range(5):
        img = synthetic.render_fundus(np.random.default_rng(i), i % 5,
                                      synthetic.SynthConfig(image_size=96))
        cv2.imwrite(str(imgdir / f"eye_{i}.jpeg"), img[..., ::-1])
    return str(imgdir)


def _predict(capsys, args):
    code = predict.main(args)
    out = capsys.readouterr()
    return code, out.out, out.err


def test_predict_replicas_one_jsonl_is_byte_identical(smoke, fundus_dir,
                                                      capsys):
    args = [f"--checkpoint_dir={smoke['root']}", f"--images={fundus_dir}",
            "--config=smoke", "--device=cpu", "--batch_size=2", "--strict",
            "--threshold=0.5", "--set", "model.image_size=64", "--set",
            "model.compute_dtype=float32"]
    code, direct, _ = _predict(capsys, args)
    assert code == 0 and len(direct.splitlines()) == 5
    code, routed, err = _predict(capsys, args + ["--replicas=1",
                                                 "--priority=batch"])
    assert code == 0
    assert routed == direct
    report = json.loads(err.strip().splitlines()[-1])["router"]
    assert report["requests"] == {"interactive": 0, "batch": 3}
    assert report["rows"] == 5 and report["buckets"] == [2]
    assert [r["state"] for r in report["replicas"]] == ["active"]
    with pytest.raises(SystemExit, match="replicas"):
        predict.main(args + ["--replicas=-1"])


def test_predict_replicas_default_to_the_card_and_raise_without_one(
        smoke, fundus_dir, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([f"--checkpoint_dir={smoke['root']}",
                      f"--images={fundus_dir}", "--config=smoke",
                      "--replicas=2", "--set", "model.image_size=64"])
    assert capsys.readouterr().out == ""


def test_predict_routes_student_cascades_over_one_pool(smoke, fundus_dir,
                                                       tmp_path, capsys):
    """--replicas 2 with a student: the rows are the direct cascade's
    (within 1e-6: the rows bin at other shapes) and the pool counts the
    escalated rows; a policy artifact of this model applies and is
    reported, one of another model is refused."""
    from jama16_retina_tpu_torch.serve import policy

    student = tmp_path / "student"
    ckpt_lib.save_member(str(student), smoke["flats"][2])
    pol = policy.derive_policy(
        [{"bucket": 2, "concurrency": 1, "images_per_sec": 10.0,
          "p50_ms": 30.0, "p99_ms": 40.0}],
        {"arch": "tiny_cnn", "image_size": 64, "head": "binary",
         "n_devices": 1})
    policy.save_policy(str(tmp_path / "p.json"), pol)
    sets = ["model.image_size=64", "model.compute_dtype=float32",
            f"serve.cascade_student_dir={student}", "serve.cascade_band=0.2",
            "serve.router_escalation_replicas=2",
            f"serve.policy_from={tmp_path / 'p.json'}"]
    args = [f"--checkpoint_dir={smoke['root']}", f"--images={fundus_dir}",
            "--config=smoke", "--device=cpu", "--batch_size=2"]
    args += [a for s in sets for a in ("--set", s)]
    code, direct, _ = _predict(capsys, args)
    assert code == 0
    code, routed, err = _predict(capsys, args + ["--replicas=2"])
    assert code == 0
    d = [json.loads(x) for x in direct.splitlines()]
    r = [json.loads(x) for x in routed.splitlines()]
    assert [x["image"] for x in r] == [x["image"] for x in d]
    np.testing.assert_allclose([x["prob"] for x in r],
                               [x["prob"] for x in d], atol=1e-6)
    report = json.loads(err.strip().splitlines()[-1])["router"]
    assert report["policy"]["version"] == pol.version
    assert "max_wait_ms" in report["policy"]["applied"]
    assert len(report["replicas"]) == 2
    with pytest.raises(policy.PolicyStale):
        _predict(capsys, args + ["--set", "model.image_size=32",
                                 "--replicas=1"])


def _part(model):
    return type("Part", (), {"model": model})()


PARTS_AB = [(_part("a"), 0, 4), (_part("b"), 0, 4)]
PARTS_BA = [(_part("b"), 0, 4), (_part("a"), 0, 4)]


@pytest.mark.parametrize("extra,bound", [
    ((), 0.0), (("serve.dtype=int8",), 0.0),
    (("serve.member_parallel=true",), 1e-5)],
    ids=["fp32_in_turn", "int8_in_turn", "fp32_vmap"])
def test_a_fused_bin_is_each_tenants_direct_rows(smoke, extra, bound,
                                                 monkeypatch):
    """Two tenants (members 0-1 and 2-3), one bucket of 8, fusion on: one
    fused bin, one preprocess, and each tenant's rows are bitwise its own
    engine's at bucket 8 with members in turn (``bound`` 0), within 1e-5
    under member_parallel. The fused rows are within 1e-5 of the JAX
    Router's fused bin over JAX engines."""
    sets = ("serve.bucket_sizes=8", "serve.max_wait_ms=200",
            "serve.router_fusion=true", "serve.fused_preprocess=true") + extra
    imgs = smoke["images"]
    eng_a = _port_engine(smoke, (0, 1), *sets)
    eng_b = _port_engine(smoke, (2, 3), *sets)
    assert fusion.fusion_token(eng_a) == fusion.fusion_token(eng_b)
    assert fusion.fusion_token(object()) is None
    ref_a, ref_b = eng_a.probs(imgs[:4]), eng_b.probs(imgs[4:8])
    assert not np.array_equal(ref_a, ref_b)
    calls = []
    real = serve_preprocess.fused_serve_preprocess
    monkeypatch.setattr(serve_preprocess, "fused_serve_preprocess",
                        lambda x: calls.append(x.shape) or real(x))
    _, pcfg = _configs(SMOKE + list(sets))
    # The JAX engine normalizes inside its program (within an ulp of B4).
    jcfg, _ = _configs(SMOKE + [s for s in sets if "fused_pre" not in s])
    reg = Registry()
    router = port_router.Router(pcfg, engines={"a": [eng_a], "b": [eng_b]},
                                registry=reg)
    fa = router.submit(imgs[:4], model="a")
    fb = router.submit(imgs[4:8], model="b")
    out_a, out_b = fa.result(timeout=120), fb.result(timeout=120)
    router.close()
    assert calls == [(8, SIZE, SIZE, 3)]
    assert reg.counter("serve.router.fused_bins").value == 1
    assert [s["model"] for s in fa.segments + fb.segments] == ["a", "b"]
    gap = max(np.abs(out_a - ref_a).max(), np.abs(out_b - ref_b).max())
    assert gap <= bound, gap
    if bound == 0.0:
        np.testing.assert_array_equal(out_a, ref_a)
        np.testing.assert_array_equal(out_b, ref_b)
    if "serve.dtype=int8" in extra:
        return
    jeng = [jax_engine.ServingEngine(jcfg, model=smoke["j_model"],
                                     state=stacked_state(smoke["flats"][s]),
                                     registry=JaxRegistry())
            for s in (slice(0, 2), slice(2, 4))]
    jrouter = jax_router.Router(jcfg, engines={"a": [jeng[0]],
                                               "b": [jeng[1]]},
                                registry=JaxRegistry())
    ja = jrouter.submit(imgs[:4], model="a")
    jb = jrouter.submit(imgs[4:8], model="b")
    np.testing.assert_allclose(out_a, ja.result(timeout=120), atol=1e-5)
    np.testing.assert_allclose(out_b, jb.result(timeout=120), atol=1e-5)
    jrouter.close()


def test_fused_bins_count_each_generations_rows_as_the_jax_fusion(smoke):
    """Tenant a sends 4 rows and tenant b 3 within one window (one fused
    bin), then a sends 5 alone: ``serve.gen0.rows`` of each tenant's
    engine reads 9 and 3 in both packages. Before the repair the port's
    fused bin counted no generation rows (a 5, b 0)."""
    sets = ("serve.bucket_sizes=8", "serve.max_wait_ms=200",
            "serve.router_fusion=true")
    imgs = smoke["images"]
    jcfg, pcfg = _configs(SMOKE + list(sets))
    got = {}
    for name in ("jax", "port"):
        regs = ([JaxRegistry(), JaxRegistry()] if name == "jax"
                else [Registry(), Registry()])
        if name == "jax":
            engines = [jax_engine.ServingEngine(
                jcfg, model=smoke["j_model"],
                state=stacked_state(smoke["flats"][s]), registry=reg)
                for s, reg in zip((slice(0, 2), slice(2, 4)), regs)]
            router = jax_router.Router(
                jcfg, engines={"a": [engines[0]], "b": [engines[1]]},
                registry=JaxRegistry())
        else:
            engines = [_port_engine(smoke, m, *sets, registry=reg)
                       for m, reg in zip(((0, 1), (2, 3)), regs)]
            router = port_router.Router(
                pcfg, engines={"a": [engines[0]], "b": [engines[1]]},
                registry=Registry())
        fa = router.submit(imgs[:4], model="a")
        fb = router.submit(imgs[4:7], model="b")
        fa.result(timeout=120), fb.result(timeout=120)
        router.submit(imgs[7:12], model="a").result(timeout=120)
        fused = router.registry.snapshot()["counters"][
            "serve.router.fused_bins"]
        router.close()
        got[name] = ([reg.snapshot()["counters"]["serve.gen0.rows"]
                      for reg in regs], fused)
    assert got["port"] == got["jax"] == ([9.0, 3.0], 1.0)


def test_fusion_cache_is_bin_order_invariant(smoke):
    sets = ("serve.bucket_sizes=8", "serve.router_fusion=true")
    imgs = smoke["images"]
    eng_a = _port_engine(smoke, (0, 1), *sets)
    eng_b = _port_engine(smoke, (2, 3), *sets)
    ebm = {"a": eng_a, "b": eng_b}
    cache = fusion.FusionCache()
    out_ab, gens = fusion.score_mixed(
        ebm, np.concatenate([imgs[:4], imgs[4:8]]), PARTS_AB, 8, cache=cache)
    first = cache._state
    out_ba, _ = fusion.score_mixed(
        ebm, np.concatenate([imgs[4:8], imgs[:4]]), PARTS_BA, 8, cache=cache)
    assert cache._state is first and gens == {"a": 0, "b": 0}
    assert first.n_members == 4
    np.testing.assert_array_equal(out_ab[:4], out_ba[4:])
    np.testing.assert_array_equal(out_ab[4:], out_ba[:4])
    eng_b.reload(state_dicts=[smoke["sds"][0], smoke["sds"][3]])
    _, gens = fusion.score_mixed(
        ebm, np.concatenate([imgs[:4], imgs[4:8]]), PARTS_AB, 8, cache=cache)
    assert cache._state is not first and gens == {"a": 0, "b": 1}


def test_fusion_cache_never_crosses_keys_under_8_threads():
    """Eight threads over four keys (model subsets and generations)
    hammer one cache with a short switch interval: each gets the fused
    state built for its own key, every call."""
    import torch

    def gen(gid, val):
        return _Generation(gid, None, None,
                           ({"w": torch.full((1, 2), float(val))}, {}), 1,
                           None)

    e1, e2, e3 = object(), object(), object()
    keys = [
        ([("a", e1, gen(1, 1.0)), ("b", e2, gen(2, 2.0))], [1.0, 2.0]),
        ([("a", e1, gen(3, 3.0)), ("c", e3, gen(4, 4.0))], [3.0, 4.0]),
        ([("b", e2, gen(5, 5.0)), ("c", e3, gen(6, 6.0))], [5.0, 6.0]),
        ([("a", e1, gen(7, 7.0)), ("b", e2, gen(8, 8.0)),
          ("c", e3, gen(9, 9.0))], [7.0, 8.0, 9.0]),
    ]
    cache = fusion.FusionCache()
    bad = []
    start = threading.Barrier(8)

    def worker(pinned, want):
        start.wait(timeout=30)
        for _ in range(200):
            state, spans = cache.fused_state(pinned)
            got = state.stacked[0]["w"][:, 0].tolist()
            if got != want or [s[0] for s in spans] != [p[0] for p in
                                                        pinned]:
                bad.append((got, want))
                return

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=keys[i % 4])
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:1]


def test_a_fused_bin_feeds_the_quality_monitors_what_direct_calls_do(smoke):
    """With B4's statistics (the plain version on the CPU): each tenant's
    drift histograms and ``last_input_stats`` after a fused bin equal
    those after its direct call on the same rows."""
    imgs = smoke["images"]
    profile = str(smoke["root"] / "profile.json")
    quality.save_profile(profile, quality.build_profile(
        np.linspace(0, 1, 24),
        stat_values=quality.input_stat_values(imgs)))
    sets = ("serve.bucket_sizes=8", "serve.router_fusion=true",
            "serve.fused_preprocess=true", "obs.quality.enabled=true",
            f"obs.quality.profile_path={profile}")
    direct = [_port_engine(smoke, m, *sets) for m in ((0, 1), (2, 3))]
    fused = [_port_engine(smoke, m, *sets) for m in ((0, 1), (2, 3))]
    rows = np.concatenate([imgs[:4], imgs[4:8]])
    want = [eng.probs(rows[lo:lo + 4]) for eng, lo in zip(direct, (0, 4))]
    out, _ = fusion.score_mixed({"a": fused[0], "b": fused[1]}, rows,
                                PARTS_AB, 8, cache=fusion.FusionCache())
    for d, f, lo, w in zip(direct, fused, (0, 4), want):
        np.testing.assert_array_equal(out[lo:lo + 4], w)
        qd, qf = d.quality, f.quality
        np.testing.assert_array_equal(qf._score_counts, qd._score_counts)
        for k in qd._stat_counts:
            np.testing.assert_array_equal(qf._stat_counts[k],
                                          qd._stat_counts[k])
        assert (qf._n, qf._pos, qf._stat_n) == (qd._n, qd._pos, qd._stat_n)
        for k, v in d.last_input_stats.items():
            np.testing.assert_array_equal(f.last_input_stats[k], v)


@pytest.mark.parametrize("extra", [(), ("serve.member_parallel=true",)],
                         ids=["in_turn", "vmap"])
def test_one_engine_is_safe_to_share_between_threads(smoke, extra):
    """Two threads call one engine's ``probs_with_generation`` on
    different rows, with a short switch interval: each thread's rows are
    bitwise its serial call's, ``chunks_dispatched`` counts every chunk,
    and ``last_input_stats`` belongs to one of the two requests."""
    imgs = smoke["images"]
    eng = _port_engine(smoke, (0, 1), "serve.fused_preprocess=true", *extra)
    reqs = [imgs[:5], imgs[5:12]]
    serial = [eng.probs(r) for r in reqs]
    stats = []
    for r in reqs:
        eng.probs(r)
        stats.append(eng.last_input_stats)
    eng.chunks_dispatched = 0
    rounds, bad = 6, []
    start = threading.Barrier(2)

    def worker(i):
        start.wait(timeout=30)
        for _ in range(rounds):
            out, gen = eng.probs_with_generation(reqs[i])
            if gen != 0 or not np.array_equal(out, serial[i]):
                bad.append(i)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads) and not bad
    # 5 rows are one chunk of 8, 7 rows one chunk: 2 chunks a round.
    assert eng.chunks_dispatched == 2 * rounds
    last = eng.last_input_stats
    assert any(all(np.array_equal(last[k], s[k]) for k in s) for s in stats)
