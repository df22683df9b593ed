"""The port's telemetry plane against the JAX package's on the CPU: the
registry with exemplars, the Prometheus text, the Snapshotter's records,
the stall clock and spans, the TensorBoard mirror, the profiler window,
``train.debug``, and a whole ``fit`` and ``predict --obs_workdir`` read
by the reference's ``scripts/obs_report.py``.

Tolerances: everything is compared exactly (values, bytes, record
fields), except wall-clock values (``t``, ``last_progress_t``, window
and segment seconds), which are never compared: only their presence,
and sums that hold by construction (within the 1e-4 s rounding of each
of the six stall fields).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.obs import export as jax_export
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu.obs import spans as jax_spans
from jama16_retina_tpu.obs import trace as jax_trace
from jama16_retina_tpu.utils import logging as jax_logging
from jama16_retina_tpu_torch import configs, predict, trainer
from jama16_retina_tpu_torch.obs import export, registry, spans, trace
from jama16_retina_tpu_torch.utils import logging as port_logging
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"registry": jax_registry, "export": jax_export, "spans": jax_spans,
       "trace": jax_trace, "logging": jax_logging}
PORT = {"registry": registry, "export": export, "spans": spans,
        "trace": trace, "logging": port_logging}
LIBS = {"jax": JAX, "port": PORT}


def _obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_registry(reg) -> list:
    """One scripted sequence of metric ops; the snapshots along it."""
    c = reg.counter("a.rows", help="rows the stage forwarded")
    g = reg.gauge("a.depth", help='depth "now"\nwith a \\ backslash')
    h = reg.histogram("a.latency_s", help="latency")
    fill = reg.histogram("a.fill", buckets=(0.25, 0.5, 1.0))
    c.inc()
    c.inc(2.5)
    g.set(3)
    g.add(-0.5)
    for i, v in enumerate((0.003, 0.2, 0.0007, 70.0, 0.2, 0.04)):
        h.observe(v, exemplar=f"1-{i}" if i % 2 == 0 else None)
    fill.observe(0.3)
    fill.observe(2.0)
    snaps = [reg.snapshot(), reg.snapshot(reset_exemplars=True),
             reg.snapshot()]
    reg.enabled = False
    c.inc()
    h.observe(1.0, exemplar="off")
    reg.enabled = True
    snaps.append(reg.snapshot())
    assert reg.peek("a.none") is None and reg.peek("a.rows") is c
    assert "a.none" not in reg.snapshot()["counters"]
    reg.remove("a.fill")
    snaps.append(reg.snapshot())
    reg.reset()
    snaps.append(reg.snapshot())
    h.observe(0.5, exemplar="after")
    c.inc()
    snaps.append(reg.snapshot())
    assert h.count == 1
    return snaps


def test_registry_snapshots_equal_the_references_with_exemplars():
    ours = _drive_registry(registry.Registry())
    theirs = _drive_registry(jax_registry.Registry())
    assert ours == theirs
    assert ours[0]["histograms"]["a.latency_s"]["exemplar"] == {
        "value": 0.2, "trace_id": "1-4"}
    assert ours[2]["histograms"]["a.latency_s"]["exemplar"] is None
    assert ours[-1]["histograms"]["a.latency_s"]["exemplar"] == {
        "value": 0.5, "trace_id": "after"}


def test_set_default_registry_swaps_and_restores():
    mine = registry.Registry()
    prev = registry.set_default_registry(mine)
    try:
        assert registry.default_registry() is mine
    finally:
        assert registry.set_default_registry(prev) is mine
    assert registry.default_registry() is prev


def test_prometheus_text_is_byte_equal():
    snaps = (_drive_registry(registry.Registry())
             + _drive_registry(jax_registry.Registry()))
    for snap in snaps:
        assert export.prometheus_text(snap) == jax_export.prometheus_text(
            snap)
    text = export.prometheus_text(snaps[0])
    assert "# HELP a_depth depth \"now\"\\nwith a \\\\ backslash" in text
    assert 'a_latency_s_bucket{le="+Inf"} 6' in text


def _fill(reg) -> None:
    reg.counter("serve.engine.rows", help="rows").inc(8)
    reg.gauge("serve.generation", help="generation").set(1)
    h = reg.histogram("serve.request_latency_s", help="latency")
    h.observe(0.02, exemplar="9-1")
    h.observe(0.3, exemplar="9-2")
    reg.histogram("trainer.input_s")


def test_snapshotter_writes_the_reference_records_and_prom(tmp_path):
    out = {}
    for name, lib in LIBS.items():
        reg = lib["registry"].Registry()
        _fill(reg)
        wd = tmp_path / name
        snap = lib["export"].Snapshotter(reg, str(wd), every_s=3600)
        assert snap.maybe_flush() is None
        snap.progress(7)
        snap.flush()
        reg.counter("serve.engine.rows").inc(4)
        snap.write_record("router", rows=12)
        snap.close()
        recs = port_logging.read_jsonl(str(wd / "metrics.jsonl"))
        for r in recs:
            assert r.pop("t") > 0
            if r["kind"] == "heartbeat":
                assert r.pop("last_progress_t") > 0
        out[name] = (recs, (wd / "telemetry.prom").read_text(),
                     snap.flushes)
    assert out["port"] == out["jax"]
    recs = out["port"][0]
    assert [r["kind"] for r in recs] == ["telemetry", "heartbeat", "router",
                                         "telemetry", "heartbeat"]
    assert recs[0]["histograms"]["serve.request_latency_s"]["exemplar"] == {
        "value": 0.3, "trace_id": "9-2"}
    # The flush closed the exemplar window.
    assert "exemplar" not in recs[3]["histograms"]["serve.request_latency_s"]
    assert recs[1] == {"kind": "heartbeat", "process_index": 0, "step": 7}
    with pytest.raises(NotImplementedError, match="item 11"):
        export.Snapshotter(registry.Registry(), str(tmp_path)).serve_http(0)


def _stall_run(lib) -> tuple:
    reg = lib["registry"].Registry()
    tr = lib["trace"].Tracer(enabled=True)
    clock = lib["spans"].StallClock(reg, tracer=tr)
    with clock.measure("input"):
        time.sleep(0.002)
    with clock.measure("dispatch"):
        pass
    measured = clock.fields()
    clock.add("pause", 0.001)
    t0 = time.perf_counter()
    clock.add("save", 0.0005, t0=t0)
    fields = clock.fields()
    # Measured segments are sub-intervals of the window: the six fields
    # sum to it within their rounding.
    assert abs(sum(v for k, v in measured.items() if k != "window_sec")
               - measured["window_sec"]) <= 6 * 1e-4
    assert measured["input_wait_sec"] >= 0.002
    with lib["spans"].span("x.block_s", reg, tracer=tr):
        pass
    off = lib["registry"].Registry(enabled=False)
    assert lib["spans"].span(
        "x.off_s", off, tracer=lib["trace"].Tracer()).__class__.__name__ \
        == "_NoopSpan"
    snap = reg.snapshot()
    return (fields, sorted(e["name"] for e in tr.events()),
            {k: v["count"] for k, v in snap["histograms"].items()},
            snap["help"])


def test_stall_clock_and_span_feed_the_reference_histograms_and_events():
    (f, names, counts, helps), (jf, jnames, jcounts, jhelps) = (
        _stall_run(PORT), _stall_run(JAX))
    assert list(f) == list(jf) == [
        "window_sec", "input_wait_sec", "dispatch_sec", "pause_sec",
        "save_sec", "other_sec"]
    assert (f["pause_sec"], f["save_sec"]) == (jf["pause_sec"],
                                               jf["save_sec"]) == (0.001,
                                                                   0.0005)
    assert names == jnames == sorted(
        ["trainer.input", "trainer.dispatch", "trainer.pause",
         "trainer.save", "x.block_s"])
    assert counts == jcounts == {"trainer.input_s": 1,
                                 "trainer.dispatch_s": 1,
                                 "trainer.pause_s": 1, "trainer.save_s": 1,
                                 "x.block_s": 1}
    assert helps == jhelps


def test_tensorboard_mirror_reads_back_as_the_references(tmp_path):
    import tensorflow as tf

    writes = [("config", {"name": "smoke", "seed": 0}),
              ("train", {"step": 2, "loss": 0.5,
                         "images_per_sec_window": 12.25, "ok": True,
                         "per_member": [0.1], "name": "x"}),
              ("heartbeat", {"step": 2, "process_index": 0,
                             "last_progress_t": 1.5}),
              ("eval", {"step": 2, "val_auc": 0.7512345678, "best": None}),
              ("train", {"step": 4, "loss": float("nan"), "n": 3})]
    got = {}
    for name, lib in LIBS.items():
        log = lib["logging"].RunLog(str(tmp_path / name), tensorboard=True)
        for kind, fields in writes:
            log.write(kind, **fields)
        log.close()
        [path] = [os.path.join(tmp_path / name / "tb", f)
                  for f in os.listdir(tmp_path / name / "tb")]
        assert os.path.basename(path).startswith("events.out.tfevents.")
        triples = []
        for ev in tf.compat.v1.train.summary_iterator(path):
            for v in ev.summary.value:
                triples.append((ev.step, v.tag,
                                v.metadata.plugin_data.plugin_name,
                                float(tf.make_ndarray(v.tensor))))
        got[name] = triples
    assert len(got["port"]) == 6
    assert repr(got["port"]) == repr(got["jax"])  # nan compares by repr


class _FakeJaxProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, d):
        self.calls.append("start")

    def stop_trace(self):
        self.calls.append("stop")


@pytest.fixture()
def fake_profilers(monkeypatch):
    import jax

    jfake, pcalls = _FakeJaxProfiler(), []
    monkeypatch.setattr(jax.profiler, "start_trace", jfake.start_trace)
    monkeypatch.setattr(jax.profiler, "stop_trace", jfake.stop_trace)
    monkeypatch.setattr(trainer, "_start_trace",
                        lambda dev: pcalls.append("start") or object())
    monkeypatch.setattr(trainer, "_stop_trace",
                        lambda prof, path, dev: pcalls.append("stop"))
    return jfake.calls, pcalls


def _drive_window(pw, steps, arm_at=None, arm_n=2, refuse_at=None):
    """The train loop's calls; the steps at which a capture was open and
    the arm() answers."""
    open_steps, answers = [], []
    for i in range(steps):
        if i == arm_at:
            answers.append(pw.arm(arm_n))
        if i == refuse_at:
            answers.append(pw.arm(arm_n))
        pw.before_step(i)
        if pw._tracing:
            open_steps.append(i)
        if i == refuse_at:
            answers.append(pw.arm(arm_n))
        if pw.__module__.startswith("jama16_retina_tpu_torch"):
            pw.after_step(i)
        else:
            pw.after_step(i, np.zeros(()))
    pw.finalize()
    return open_steps, answers


@pytest.mark.parametrize("sets,drive", [
    (["train.steps=20", "train.profile_steps=3"], {}),
    (["train.steps=5", "train.profile_steps=3"], {}),
    (["train.steps=2", "train.profile_steps=3"], {}),
    (["train.steps=20", "train.profile_steps=0"], {"arm_at": 5}),
    (["train.steps=20", "train.profile_steps=4"], {"refuse_at": 11}),
    (["train.steps=12", "train.profile_steps=3"], {"arm_at": 9, "arm_n": 5}),
], ids=["planned", "clamped", "skipped", "armed", "refused_while_open",
        "truncated"])
def test_profiler_window_opens_and_closes_where_the_references_does(
        tmp_path, fake_profilers, sets, drive):
    jcalls, pcalls = fake_profilers
    got = {}
    for name, cfg_lib, window in (
            ("jax", jax_configs, jax_trainer._ProfilerWindow),
            ("port", configs, trainer._ProfilerWindow)):
        cfg = cfg_lib.override(cfg_lib.get_config("smoke"), sets)
        wd = tmp_path / name
        log = LIBS[name]["logging"].RunLog(str(wd))
        args = (cfg, log, str(wd), 0) + (("cpu",) if name == "port" else ())
        steps = cfg.train.steps
        got[name] = _drive_window(window(*args), steps, **drive)
        log.close()
        recs = port_logging.read_jsonl(str(wd / "metrics.jsonl"))
        got[name] += ([{k: v for k, v in r.items() if k not in ("t", "dir")}
                       for r in recs],)
    assert got["port"] == got["jax"]
    assert pcalls == jcalls
    assert pcalls.count("start") == pcalls.count("stop")


def test_the_profiler_window_captures_a_chrome_trace_on_the_cpu(tmp_path):
    cfg = configs.override(configs.get_config("smoke"),
                           ["train.steps=12", "train.profile_steps=1"])
    log = port_logging.RunLog(str(tmp_path))
    pw = trainer._ProfilerWindow(cfg, log, str(tmp_path), 0, "cpu")
    _drive_window(pw, 12)
    log.close()
    path = tmp_path / "profile" / "steps_10-10.pt.trace.json"
    assert "traceEvents" in json.loads(path.read_text())


def _splits(root: str) -> str:
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        jax_tfrecord.write_synthetic_split(root, split, n, 32, num_shards=2,
                                           seed=seed, encoding="raw")
    return root


FIT = ["train.steps=4", "train.eval_every=2", "train.log_every=1",
       "model.image_size=32", "data.batch_size=8", "eval.batch_size=8",
       "obs.flush_every_s=0", "train.tensorboard=true",
       "obs.quality.alert_rules=trainer.input_s.count > 0 -> slo_breach"]
PREDICT = ["model.image_size=32",
           "obs.quality.alert_rules=serve.engine.rows > 0 -> slo_breach"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 4-step fit and a predict --obs_workdir over its best step, in
    each package, on 32 px splits and five rendered fundus photos."""
    root = tmp_path_factory.mktemp("obs_runs")
    data = _splits(str(root / "data"))
    # Fresh process registries, as each run would have in a process of
    # its own (a reset zeroes the metrics earlier tests registered, but
    # keeps them in the snapshot).
    prev = [lib["registry"].set_default_registry(lib["registry"].Registry())
            for lib in (JAX, PORT)]
    try:
        jax_trainer.fit(jax_configs.override(
            jax_configs.get_config("smoke"), FIT), data,
            str(root / "jax_fit"))
        trainer.fit(configs.override(configs.get_config("smoke"), FIT), data,
                    str(root / "port_fit"), device="cpu")
        _predict(root)
    finally:
        for lib, reg in zip((JAX, PORT), prev):
            lib["registry"].set_default_registry(reg)
    return root


def _predict(root) -> None:
    """The JAX predict.py (its own process) and the port's predict, each
    over its own fit's best step."""
    import cv2

    from jama16_retina_tpu_torch.data import synthetic

    images = root / "images"
    images.mkdir()
    for i in range(5):
        img = synthetic.render_fundus(np.random.default_rng(i), i % 5,
                                      synthetic.SynthConfig(image_size=96))
        cv2.imwrite(str(images / f"eye_{i}.jpeg"), img[..., ::-1])
    sets = [a for s in PREDICT for a in ("--set", s)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "predict.py"), "--config=smoke",
         f"--checkpoint_dir={root / 'jax_fit'}", f"--images={images}",
         "--batch_size=2", f"--obs_workdir={root / 'jax_predict'}", *sets],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    code = predict.main([
        "--config=smoke", f"--checkpoint_dir={root / 'port_fit'}",
        f"--images={images}", "--batch_size=2", "--device=cpu",
        f"--obs_workdir={root / 'port_predict'}", *sets])
    assert code == 0


def _shape(x):
    """The structure of a reader's output: keys and value kinds."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(x[0])] if x else []
    if isinstance(x, bool) or x is None:
        return type(x).__name__
    if isinstance(x, (int, float)):
        return "number"
    return type(x).__name__


@pytest.mark.parametrize("kind", ["fit", "predict"])
def test_obs_report_reads_the_port_workdir_as_a_jax_one(runs, kind):
    rep = _obs_report()
    got = {}
    for name in ("jax", "port"):
        wd = str(runs / f"{name}_{kind}")
        recs = rep.load_records(wd)
        events = rep.load_trace_events(rep.find_trace(wd))
        beats = rep.latest_heartbeats(recs)
        got[name] = {
            # The reference's device plane and compile ledger (ROADMAP
            # item 11, part 4; item 9) write kinds the port has no source
            # of yet.
            "kinds": sorted({r["kind"] for r in recs}
                            - {"device", "compile", "compile_ledger"}),
            "stalls": _shape(rep.stalls_summary(recs)),
            "heartbeats": _shape(beats),
            "final_step": beats[0]["step"],
            "reliability": _shape(rep.reliability_summary(recs)),
            "check_alerts": rep.check_alerts(wd)[0],
            "alerts": [(r["rule"], r["state"], r["reason"]) for r in recs
                       if r["kind"] == "alert"],
            "event_keys": sorted({tuple(sorted(e)) for e in events
                                  if e["ph"] == "X"}),
            "trainer_events": sorted({e["name"] for e in events
                                      if e["name"].startswith("trainer.")}),
            "slowest_steps": _shape(rep.slowest_steps(events)),
            "dumps": sorted(os.listdir(os.path.join(wd, "blackbox"))),
            "dump_files": sorted(os.listdir(os.path.join(
                wd, "blackbox", "01-slo_breach"))),
        }
        diag = json.load(open(os.path.join(wd, "blackbox", "01-slo_breach",
                                           "diagnosis.json")))
        got[name]["diagnosis"] = (sorted(diag), diag["device"])
        meta = json.load(open(os.path.join(wd, "blackbox", "01-slo_breach",
                                           "meta.json")))
        got[name]["meta"] = sorted(meta)
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["check_alerts"] == 1 and g["dumps"] == ["01-slo_breach"]
    assert g["alerts"][0][1:] == ("firing", "slo_breach")
    assert {"telemetry", "heartbeat", "alert"} <= set(g["kinds"])
    if kind == "fit":
        assert g["final_step"] == 4 and g["stalls"] is not None
        # The rule fires at the first flush, after step 1: no eval yet.
        assert g["trainer_events"] == ["trainer.dispatch", "trainer.input"]
        assert g["slowest_steps"]
        assert os.listdir(runs / "port_fit" / "tb")
    else:
        assert g["final_step"] == 5 and g["reliability"] is not None


def test_obs_disabled_writes_no_plane_and_records_nothing(tmp_path):
    data = _splits(str(tmp_path / "data"))
    cfg = configs.override(configs.get_config("smoke"), FIT + [
        "obs.enabled=false"])
    reg, tr = registry.Registry(), trace.Tracer(enabled=True)
    prev = (registry.set_default_registry(reg), trace.set_default_tracer(tr))
    try:
        trainer.fit(cfg, data, str(tmp_path / "fit"), device="cpu")
    finally:
        registry.set_default_registry(prev[0])
        trace.set_default_tracer(prev[1])
    recs = port_logging.read_jsonl(str(tmp_path / "fit" / "metrics.jsonl"))
    assert {r["kind"] for r in recs} == {"config", "train", "eval"}
    assert not (tmp_path / "fit" / "telemetry.prom").exists()
    assert not (tmp_path / "fit" / "blackbox").exists()
    assert not reg.enabled and not tr.enabled and tr.events() == []
    assert all(v["count"] == 0 for v in reg.snapshot()["histograms"].values())
    assert all(k in recs[1] for k in ("input_wait_sec", "other_sec"))


@pytest.mark.parametrize("lib", ["jax", "port"])
def test_train_debug_raises_floating_point_error_on_a_poisoned_batch(
        tmp_path, lib):
    """A NaN label smoothing poisons every batch's targets: under
    ``train.debug`` the first step raises ``FloatingPointError`` in both
    packages (``jax_debug_nans``; the port's anomaly mode and loss check,
    naming the step), and the prior anomaly mode is restored."""
    import torch

    data = _splits(str(tmp_path / "data"))
    items = ["train.steps=2", "train.eval_every=2", "model.image_size=32",
             "data.batch_size=8", "eval.batch_size=8", "train.debug=true",
             "train.label_smoothing=nan"]
    if lib == "jax":
        import jax

        with pytest.raises(FloatingPointError):
            jax_trainer.fit(jax_configs.override(
                jax_configs.get_config("smoke"), items), data,
                str(tmp_path / "wd"))
        assert not jax.config.jax_debug_nans
        return
    with pytest.raises(FloatingPointError, match="step 1"):
        trainer.fit(configs.override(configs.get_config("smoke"), items),
                    data, str(tmp_path / "wd"), device="cpu")
    assert not torch.is_anomaly_enabled()
    dumps = os.listdir(tmp_path / "wd" / "blackbox")
    assert dumps == ["01-exception"]
