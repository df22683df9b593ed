"""The port's tracer, critical-path analysis, flight recorder and request
segments against the JAX package's on the CPU.

Tolerances: events are compared by name, phase, args and order per
thread, and durations exactly where the caller stamps both ends;
timestamps and self-timed durations are never compared. Diagnosis
verdicts are equal dicts on events whose durations the test sets.
Request segments tile the request's span within the 0.001 us rounding of
exported events, and sum to the latency histogram's observation within
1e-6 s a request (that rounding and float sums of one monotonic clock).
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from jama16_retina_tpu.obs import criticalpath as jax_criticalpath
from jama16_retina_tpu.obs import flightrec as jax_flightrec
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu.obs import trace as jax_trace
from jama16_retina_tpu.serve import batcher as jax_batcher
from jama16_retina_tpu.serve import router as jax_router
from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.obs import criticalpath, flightrec, registry
from jama16_retina_tpu_torch.obs import trace
from jama16_retina_tpu_torch.serve import batcher as port_batcher
from jama16_retina_tpu_torch.serve import router as port_router

LIBS = {
    "jax": {"trace": jax_trace, "registry": jax_registry,
            "flightrec": jax_flightrec, "criticalpath": jax_criticalpath,
            "batcher": jax_batcher, "router": jax_router,
            "configs": jax_configs},
    "port": {"trace": trace, "registry": registry, "flightrec": flightrec,
             "criticalpath": criticalpath, "batcher": port_batcher,
             "router": port_router, "configs": configs},
}


def _record(lib, buffer_events: int = 4096):
    """One scripted call sequence on two threads; (events, dropped)."""
    tr = lib["trace"].Tracer(enabled=True, buffer_events=buffer_events)
    ctx = lib["trace"].TraceContext(trace_id="7-1", origin_pid=7)

    def worker():
        with lib["trace"].use_context(ctx):
            assert lib["trace"].current_context() is ctx
            for i in range(3):
                tr.instant("w.tick", {"i": i,
                                      "trace_id": ctx.trace_id})
        assert lib["trace"].current_context() is None

    tr.instant("main.start")
    tr.begin("main.block", {"k": 1})
    tr.complete("main.seg", 10.0, 10.25, {"trace_id": "7-1"})
    tr.complete("main.neg", 11.0, 10.0)
    with tr.trace("main.ctx", args={"rows": 8}):
        pass
    tr.end("main.block")
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    off = lib["trace"].Tracer(enabled=False)
    off.instant("x")
    assert off.events() == [] and off.trace("x").__class__.__name__ \
        == "_NoopTrace"
    return tr.events(), tr.dropped(), tr.events(last_n=2)


def _by_thread(events):
    out = {}
    for e in events:
        out.setdefault(e["tid"], []).append(
            (e["name"], e["ph"], e.get("args"),
             e["dur"] if e["name"] in ("main.seg", "main.neg") else None))
    return sorted(out.values())


@pytest.mark.parametrize("buffer_events", [4096, 2])
def test_tracer_records_the_references_events(buffer_events):
    (ev, dropped, last), (jev, jdropped, jlast) = (
        _record(LIBS["port"], buffer_events),
        _record(LIBS["jax"], buffer_events))
    assert _by_thread(ev) == _by_thread(jev)
    assert dropped == jdropped == (0 if buffer_events > 2 else 5)
    assert [e["name"] for e in last] == [e["name"] for e in jlast]
    assert all(set(e) == set(j) for e, j in zip(ev, jev))
    seg = [e for e in ev if e["name"] == "main.seg"]
    if seg:
        assert seg[0]["dur"] == 250000.0


def test_trace_context_wire_round_trips_as_the_references():
    for lib in LIBS.values():
        ctx = lib["trace"].TraceContext(trace_id="3-9", origin_pid=3)
        child = ctx.child("serve.router.bin")
        assert child.wire() == {"trace_id": "3-9", "origin_pid": 3,
                                "parent": "serve.router.bin"}
        back = lib["trace"].TraceContext.from_wire(child.wire())
        assert (back.trace_id, back.parent) == ("3-9", "serve.router.bin")
        assert lib["trace"].TraceContext.from_wire({"x": 1}) is None
        fresh = lib["trace"].new_context()
        assert fresh.trace_id.startswith(f"{os.getpid()}-")


def test_chrome_trace_and_default_tracer_swap():
    ev = [{"name": "a", "ph": "i", "ts": 1.0, "pid": 1, "tid": 2}]
    assert trace.chrome_trace(ev) == jax_trace.chrome_trace(ev)
    mine = trace.Tracer(enabled=True)
    prev = trace.set_default_tracer(mine)
    try:
        assert trace.default_tracer() is mine
    finally:
        trace.set_default_tracer(prev)


def _timeline(lib):
    """The same segments recorded through each package's tracer with
    caller-stamped ends: a train step timeline, serve requests and a
    nested engine span."""
    tr = lib["trace"].Tracer(enabled=True)
    t = 100.0
    for step in range(5):
        for name, dur in (("trainer.input", 0.01 + step * 0.001),
                          ("trainer.dispatch", 0.05),
                          ("trainer.pause", 0.002 * step)):
            tr.complete(name, t, t + dur)
            t += dur
    for r, (q, d) in enumerate(((0.004, 0.02), (0.03, 0.01), (0.5, 0.02))):
        args = {"trace_id": f"5-{r}", "rows": 8}
        tr.complete("serve.request.queue_wait", t, t + q, args)
        tr.complete("serve.request.window_fill", t + q, t + q + 0.001, args)
        tr.complete("serve.request.device", t + q + 0.001,
                    t + q + 0.001 + d, args)
        tr.complete("serve.engine.dispatch_s", t + q + 0.001, t + q + 0.002)
        tr.complete("data.h2d_copy", t, t + 0.003)
        t += 1.0
    return tr.events()


@pytest.mark.parametrize("top_k", [0, 3])
def test_diagnosis_is_the_references_on_both_tracers_events(top_k):
    ours, theirs = _timeline(LIBS["port"]), _timeline(LIBS["jax"])
    for events in (ours, theirs):
        got = criticalpath.diagnose(events, top_k=top_k).as_dict()
        want = jax_criticalpath.diagnose(events, top_k=top_k).as_dict()
        assert got == want
    assert (criticalpath.diagnose(ours, top_k).as_dict()
            == jax_criticalpath.diagnose(theirs, top_k).as_dict())
    assert criticalpath.VERDICT_CODES == jax_criticalpath.VERDICT_CODES
    for device in ({"dominant_class": "memory"}, {"mfu": 0.5},
                   {"mfu": 0.1}, {"mfu": None}, None):
        assert (criticalpath.refine_device_verdict(device)
                == jax_criticalpath.refine_device_verdict(device))
    assert criticalpath.diagnose([]).as_dict() == \
        jax_criticalpath.diagnose([]).as_dict()


def _dumps(lib, root, trigger: str):
    """One flight recorder driven to one trigger; (dump file set, JSON
    keys of each file, the dump's meta minus times, profile hook calls,
    return values)."""
    fired = []
    reg = lib["registry"].Registry()
    tr = lib["trace"].Tracer(enabled=True)
    tr.complete("trainer.dispatch", 1.0, 1.5)
    tr.complete("serve.request.device", 2.0, 2.1, {"trace_id": "1-1"})
    fr = lib["flightrec"].FlightRecorder(
        str(root), config={"name": "smoke", "obs": {"enabled": True}},
        registry=reg, tracer=tr, blackbox_events=8, slow_step_factor=3.0,
        profile_hook=lambda: fired.append(1), blackbox_keep=2)
    out = []
    if trigger == "nonfinite_loss":
        out.append(fr.note_loss(1.5, step=1))
        out.append(fr.note_loss(np.array([0.5, np.nan]), step=2))
        out.append(fr.note_loss(float("inf"), step=3))
    elif trigger == "slow_step":
        for i in range(20):
            out.append(fr.note_step_time(0.1, step=i + 1))
        out.append(fr.note_step_time(0.35, step=21))
        out.append(fr.note_step_time(0.5, step=22))
    elif trigger == "exception":
        out.append(os.path.basename(fr.record_exception(ValueError("boom"))))
    elif trigger == "sigterm":
        # Off the main thread no handler installs, and the signal would
        # end the process.
        assert threading.current_thread() is threading.main_thread()
        fr.install_signal_handlers()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(1.0)
        except SystemExit as e:
            out.append(e.code)
            out.append(os.path.basename(fr.record_exception(e)))
        finally:
            fr.uninstall_signal_handlers()
    elif trigger == "prune":
        for reason in ("a", "b", "c", "a"):
            d = fr.dump(reason)
            out.append(None if d is None else os.path.basename(d))
            time.sleep(0.02)
        out.append(reg.snapshot()["counters"]["obs.blackbox_pruned"])
    files, keys, metas = [], {}, []
    for d in sorted(os.listdir(root / "blackbox")):
        names = sorted(os.listdir(root / "blackbox" / d))
        files.append((d, names))
        for n in names:
            if n.endswith(".json"):
                obj = json.load(open(root / "blackbox" / d / n))
                keys[(d, n)] = sorted(obj)
                if n == "meta.json":
                    metas.append({k: v for k, v in obj.items() if k != "t"})
        lines = (root / "blackbox" / d / "trace.jsonl").read_text()
        keys[(d, "trace.jsonl")] = [sorted(json.loads(x))
                                    for x in lines.splitlines()]
    return files, keys, metas, len(fired), out


@pytest.mark.parametrize("trigger", ["nonfinite_loss", "slow_step",
                                     "exception", "sigterm", "prune"])
def test_flight_recorder_dumps_as_the_reference(tmp_path, trigger):
    ours = _dumps(LIBS["port"], tmp_path / "port", trigger)
    theirs = _dumps(LIBS["jax"], tmp_path / "jax", trigger)
    assert ours == theirs
    files, _keys, metas, fired, _out = ours
    assert files
    if trigger in ("nonfinite_loss", "slow_step"):
        assert fired == 1  # one capture a run
        assert all("diagnosis.json" in names for _d, names in files)
    if trigger == "sigterm":
        assert metas[0]["reason"] == "sigterm" and metas[0]["signal"] == 15
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_note_loss_reads_a_cpu_tensor():
    import torch

    fr = flightrec.FlightRecorder("/nonexistent", enabled=False)
    assert fr.note_loss(torch.tensor(float("nan"))) is False
    fr = flightrec.FlightRecorder("unused", registry=registry.Registry(),
                                  tracer=trace.Tracer())
    fr._dumped_reasons.add("nonfinite_loss")  # no dump directory needed
    assert fr.note_loss(torch.tensor([1.0, 2.0])) is False


def _infer(rows):
    time.sleep(0.003)
    return rows.reshape(rows.shape[0], -1).astype(np.float64).mean(axis=1)


def _batcher_run(lib):
    tr = lib["trace"].Tracer(enabled=True)
    reg = lib["registry"].Registry()
    b = lib["batcher"].MicroBatcher(_infer, max_batch=4, max_wait_ms=20,
                                    registry=reg, tracer=tr)
    ctx = lib["trace"].TraceContext(trace_id="4-42", origin_pid=4)
    with lib["trace"].use_context(ctx):
        f0 = b.submit(np.ones((2, 3), np.uint8))
    futs = [f0] + [b.submit(np.full((1, 3), i, np.uint8)) for i in range(3)]
    for f in futs:
        f.result(timeout=30)
    b.close()
    return tr.events(), reg.snapshot()


def test_batcher_request_segments_sum_to_the_latency():
    for name in ("port", "jax"):
        events, snap = _batcher_run(LIBS[name])
        by = {}
        for e in events:
            by.setdefault(e["args"]["trace_id"], []).append(e)
        assert len(by) == 4 and "4-42" in by
        lat = snap["histograms"]["serve.request_latency_s"]
        assert lat["count"] == 4
        total = 0.0
        for segs in by.values():
            assert [s["name"] for s in segs] == [
                "serve.request.queue_wait", "serve.request.window_fill",
                "serve.request.device", "serve.request.resolve"]
            t0, t1 = segs[0]["ts"], segs[-1]["ts"] + segs[-1]["dur"]
            assert abs(sum(s["dur"] for s in segs) - (t1 - t0)) <= 1e-3
            total += sum(s["dur"] for s in segs)
        # The histogram summed the same four latencies (us vs s).
        assert abs(total / 1e6 - lat["sum"]) <= 1e-6 * 4
        assert lat["exemplar"]["trace_id"] in by
    ours, theirs = _batcher_run(LIBS["port"]), _batcher_run(LIBS["jax"])
    assert (sorted((e["name"], e["args"]["rows"]) for e in ours[0])
            == sorted((e["name"], e["args"]["rows"]) for e in theirs[0]))


class _Stub:
    """A replica engine with the row contract and a generation."""

    generation = 0

    def probs(self, rows):
        time.sleep(0.002)
        return rows.reshape(rows.shape[0], -1).mean(axis=1) / 255.0


def _router_run(lib):
    cfg = lib["configs"].override(lib["configs"].get_config("smoke"), [
        "serve.bucket_sizes=2,4", "serve.max_batch=4",
        "serve.max_wait_ms=20", "serve.router_tick_ms=1"])
    tr = lib["trace"].Tracer(enabled=True)
    prev = lib["trace"].set_default_tracer(tr)
    reg = lib["registry"].Registry()
    try:
        router = lib["router"].Router(cfg, engines=[_Stub()], registry=reg)
        rng = np.random.default_rng(0)
        futs = [router.submit(rng.integers(0, 255, (n, 2, 2, 3), np.uint8))
                for n in (3, 1, 6)]
        for f in futs:
            f.result(timeout=30)
        router.close()
    finally:
        lib["trace"].set_default_tracer(prev)
    return tr.events(), reg.snapshot()


def test_router_request_segments_sum_to_the_latency():
    for name in ("port", "jax"):
        events, snap = _router_run(LIBS[name])
        reqs = {}
        for e in events:
            if e["name"].startswith("serve.router.request."):
                reqs.setdefault(e["args"]["trace_id"], []).append(e)
        assert len(reqs) == 3
        lat = snap["histograms"]["serve.router.request_latency_s"]
        total = 0.0
        for segs in reqs.values():
            assert [s["name"] for s in segs] == [
                "serve.router.request.queue_wait",
                "serve.router.request.device",
                "serve.router.request.resolve"]
            total += sum(s["dur"] for s in segs)
        assert abs(total / 1e6 - lat["sum"]) <= 1e-6 * 3
        assert lat["exemplar"]["trace_id"] in reqs
        assert snap["histograms"]["serve.router.tick_s"]["count"] > 0
        assert any(e["name"] == "serve.router.tick_s" for e in events)
    names = {n: sorted({e["name"] for e in _router_run(LIBS[n])[0]})
             for n in LIBS}
    assert names["port"] == names["jax"]


def test_escalation_pool_stamps_the_ambient_request():
    for name, lib in LIBS.items():
        tr = lib["trace"].Tracer(enabled=True)
        pool = lib["router"].EscalationPool(
            [_Stub()], registry=lib["registry"].Registry(), tracer=tr)
        ctx = lib["trace"].TraceContext(trace_id="8-1", origin_pid=8)
        rows = np.zeros((2, 2, 2, 3), np.uint8)
        with lib["trace"].use_context(ctx):
            pool.probs(rows)
        pool.probs_speculative(rows)
        got = [(e["name"], e["args"]) for e in tr.events()]
        assert got == [
            ("serve.router.escalate",
             {"rows": 2, "pool_member": 0, "trace_id": "8-1"}),
            ("serve.router.escalate",
             {"rows": 2, "pool_member": 0, "speculative": True})], name
