"""The port's lifecycle (``jama16_retina_tpu_torch/lifecycle/`` and
``lifecycle_run.py``) held against the JAX package's on the same inputs:
byte-identical journals, the state machine over the same seams (journal
entries, registry values, return values and exceptions equal), crash
safety at every state and under SIGKILL, real engines on the ``smoke``
preset (tiny_cnn, 64 px, float32) through drift -> reject -> promote ->
regression -> rollback with the gates' values within 1e-6, the default
retrain's fits and markers, the operator CLI against
``scripts/lifecycle_run.py``, and the port's run-log records as the
reference's ``obs_report`` renders them."""

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import lifecycle as jax_lifecycle
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.eval import metrics as jax_metrics
from jama16_retina_tpu.integrity import artifact as jax_artifact
from jama16_retina_tpu.lifecycle import controller as jax_controller
from jama16_retina_tpu.obs import alerts as jax_alerts
from jama16_retina_tpu.obs import faultinject as jax_faultinject
from jama16_retina_tpu.obs import quality as jax_quality
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.utils import checkpoint as jax_ckpt
from jama16_retina_tpu_torch import configs, lifecycle_run, trainer
from jama16_retina_tpu_torch import lifecycle
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.integrity import artifact
from jama16_retina_tpu_torch.lifecycle import controller
from jama16_retina_tpu_torch.obs import alerts, faultinject, quality
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve import assemble as assemble_lib
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
SMOKE = [f"model.image_size={SIZE}", "model.compute_dtype=float32",
         "serve.max_batch=8", "serve.bucket_sizes=8",
         "serve.rollback_keep_s=900"]
SEAM = ["lifecycle.enabled=true", "lifecycle.watch_probes=1",
        "lifecycle.watch_interval_s=0", "lifecycle.shadow_wait_s=0.2",
        "lifecycle.shadow_requests=1"]

# The two packages behind one set of names.
JAX = types.SimpleNamespace(
    configs=jax_configs, lifecycle=jax_lifecycle, controller=jax_controller,
    faultinject=jax_faultinject, Registry=JaxRegistry, quality=jax_quality,
    alerts=jax_alerts, metrics=jax_metrics, artifact=jax_artifact,
    trainer=jax_trainer)
PORT = types.SimpleNamespace(
    configs=configs, lifecycle=lifecycle, controller=controller,
    faultinject=faultinject, Registry=Registry, quality=quality,
    alerts=alerts, metrics=metrics, artifact=artifact, trainer=trainer)
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jax_faultinject.disarm()
    faultinject.disarm()


def _cfg(pkg, extra=()):
    return pkg.configs.override(pkg.configs.get_config("smoke"),
                                SMOKE + SEAM + list(extra))


class FakeEngine:
    """The swap surface the controller drives, recording every action
    (the reference test's fake, shared by both packages)."""

    def __init__(self, registry, live_dirs=("live",)):
        self.registry = registry
        self.quality = None
        self._gen = type("G", (), {"member_dirs": list(live_dirs)})()
        self.actions: list = []
        self._shadow_active = False

    def prepare_candidate(self, member_dirs=None, state=None, warm=False):
        self.actions.append(("prepare", tuple(member_dirs or ()), warm))
        return object()

    def begin_shadow(self, candidate=None, fraction=0.25, **kw):
        self._shadow_active = True
        self.actions.append(("begin_shadow", fraction))
        return {"fraction": fraction, "every": 1}

    def shadow_report(self):
        if not self._shadow_active:
            return None
        return {"requests": 5, "rows": 5, "errors": 0,
                "max_abs_dev": 0.01, "mean_abs_dev": 0.005}

    def end_shadow(self, promote=False):
        self._shadow_active = False
        self.actions.append(("end_shadow", promote))
        out = {"requests": 5, "rows": 5, "errors": 0,
               "max_abs_dev": 0.01, "mean_abs_dev": 0.005}
        if promote:
            out["reload"] = {"generation": 1, "n_members": 1}
        return out

    def reload(self, member_dirs=None, state=None):
        self.actions.append(("reload", tuple(member_dirs or ())))
        self._gen = type("G", (), {"member_dirs": list(member_dirs)})()
        return {"generation": 1, "n_members": 1}

    def rollback(self):
        self.actions.append(("rollback",))
        return {"generation": 2, "restored_from": 0, "n_members": 1}


def _strip(entry):
    """An entry without its clock and its trace wire (the trace id comes
    from each package's own counter); the wire's shape is checked."""
    if entry is None:
        return None
    trace = entry.get("trace")
    if trace is not None:
        assert set(trace) == {"trace_id", "origin_pid"}
        assert trace["origin_pid"] == os.getpid()
    return {k: v for k, v in entry.items() if k not in ("t", "trace")}


def _lifecycle_values(reg) -> dict:
    snap = reg.snapshot()
    out = {k: v for k, v in snap["counters"].items()
           if k.startswith("lifecycle.")}
    out.update({k: v for k, v in snap["gauges"].items()
                if k == "serve.lifecycle.state"})
    helps = {k: v for k, v in snap.get("help", {}).items()
             if k in out}
    return {"values": out, "help": helps}


def _call(fn):
    """fn()'s result, or the exception's type and message."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - compared between packages
        return ("raised", type(e).__name__, str(e))
    return _strip(out) if isinstance(out, dict) else out


def _pass_gate(pkg, name="fake"):
    return lambda ctl, cand: pkg.lifecycle.GateVerdict(name, True, 0.0, 1.0)


def _fail_gate(pkg, name="fake"):
    return lambda ctl, cand: pkg.lifecycle.GateVerdict(name, False, 9.0, 1.0)


def _seed_swapped_cycle(pkg, wd, live_member_dirs, repinned=False):
    """A journal that swapped and then watched a regression: what a
    controller killed after WATCH leaves."""
    j = pkg.lifecycle.Journal(os.path.join(wd, "lifecycle"),
                              terminal_states=pkg.lifecycle.TERMINAL_STATES)
    j.append("DRIFT_DETECTED", cycle=0, reason="quality_drift",
             live_member_dirs=live_member_dirs)
    j.append("RETRAIN", cycle=0, member_dirs=["cand"])
    j.append("GATE", cycle=0, passed=True, verdicts=[])
    j.append("STAGED_ROLLOUT", cycle=0, generation=1, shadow={},
             canary_repinned=repinned)
    j.append("WATCH", cycle=0, healthy=False, probes=1,
             fired=["quality.canary_ok<1"], rules=[])
    j.write_live(["cand"])
    return j


def _scenario(pkg, name, wd) -> dict:
    """Drive one seam-level scenario in one package; everything it
    returns must be equal between the packages."""
    reg = pkg.Registry()
    eng = FakeEngine(reg)
    retrains: list = []
    calls: list = []
    out: dict = {}

    def build(cfg=None, engine=eng, gates=None, **kw):
        return pkg.lifecycle.LifecycleController(
            cfg or _cfg(pkg), wd, engine=engine, registry=reg,
            retrain_fn=lambda c, root: retrains.append(root) or ["cand"],
            gate_fns=gates or [_pass_gate(pkg)], live_member_dirs=["live"],
            sleep=lambda s: None, **kw)

    if name == "happy":
        ctl = build()
        calls += [_call(ctl.step), _call(lambda: ctl.trigger(
            reason="quality_drift")), _call(ctl.run)]
        out["metrics"] = [r["state"] for r in read_jsonl(
            os.path.join(wd, "metrics.jsonl")) if r["kind"] == "lifecycle"]
    elif name == "gate_reject":
        ctl = build(gates=[_pass_gate(pkg, "a"), _fail_gate(pkg, "b")])
        calls += [_call(lambda: ctl.trigger(reason="quality_drift")),
                  _call(ctl.run)]
    elif name == "gate_fault":
        pkg.faultinject.arm({"lifecycle.gate": {
            "kind": "error", "on_calls": [1], "error": "RuntimeError"}})
        ctl = build(engine=None)
        calls += [_call(lambda: ctl.trigger(reason="quality_drift")),
                  _call(ctl.run)]
        out["reread"] = pkg.lifecycle.Journal(ctl.journal.dir).state
    elif name == "watch_regression":
        ctl = build()
        calls.append(_call(lambda: ctl.trigger(reason="quality_drift")))
        calls += [_call(ctl.step) for _ in range(3)]
        out["live_mid"] = ctl.journal.read_live()
        reg.gauge("quality.canary_ok").set(0.0)
        calls.append(_call(ctl.run))
    elif name == "trigger_refused":
        ctl = build(engine=None)
        calls += [
            _call(lambda: ctl.on_alert({"reason": "slo_breach",
                                        "rule": "r"})),
            _call(lambda: ctl.on_alert({"reason": "quality_drift",
                                        "rule": "r", "value": 0.5,
                                        "threshold": 0.2})),
            _call(lambda: ctl.trigger(reason="quality_drift")),
            _call(lambda: ctl.on_alert({"reason": "quality_drift",
                                        "rule": "r2"}))]
    elif name == "disabled":
        ctl = build(cfg=_cfg(pkg, ["lifecycle.enabled=false"]), engine=None)
        calls.append(_call(lambda: ctl.on_alert({"reason": "quality_drift",
                                                 "rule": "r"})))
    elif name == "rules_refused":
        for rule in ("rate(serve.reload_rejected)>0",
                     "quality.score_psi > 0.2 for 120"):
            calls.append(_call(lambda rule=rule: build(
                cfg=_cfg(pkg, [f"lifecycle.watch_rules={rule}"]),
                engine=None)))
    elif name == "engineless_rollback":
        images = np.random.default_rng(23).integers(
            0, 256, (4, SIZE, SIZE, 3), np.uint8)
        old_ref = np.linspace(0.1, 0.4, 4)
        path = pkg.quality.save_canary(os.path.join(wd, "canary"), images,
                                       scores=old_ref + 0.3)
        _seed_swapped_cycle(pkg, wd, ["old"], repinned=True)
        pkg.quality.save_canary(
            os.path.join(wd, "lifecycle", "canary-pre-0000"), images,
            scores=old_ref)
        ctl = build(cfg=_cfg(pkg, ["obs.quality.enabled=true",
                                   f"obs.quality.canary_path={path}"]),
                    engine=None)
        calls.append(_call(ctl.run))
        out["canary"] = pkg.quality.load_canary_file(path)[1].tolist()
    elif name == "rollback_unpinned":
        _seed_swapped_cycle(pkg, wd, None)
        eng._gen.member_dirs = ["cand"]
        ctl = build()
        eng._gen.member_dirs = ["restored"]
        calls.append(_call(ctl.run))
    elif name == "step_error":
        pkg.faultinject.arm({"lifecycle.retrain": {
            "kind": "error", "on_calls": [1], "error": "RuntimeError"}})
        ctl = build(engine=None, gates=[_fail_gate(pkg)])
        calls += [_call(lambda: ctl.trigger(reason="quality_drift")),
                  _call(ctl.step)]
        out["held"] = ctl.state
        calls.append(_call(ctl.step))
    else:
        raise AssertionError(name)
    pkg.faultinject.disarm()
    journal = pkg.lifecycle.Journal(os.path.join(wd, "lifecycle"))
    return {"calls": calls, "entries": [_strip(e) for e in journal.entries],
            "live": journal.read_live(), "registry": _lifecycle_values(reg),
            "actions": eng.actions, "retrains": len(retrains), **out}


SCENARIOS = ("happy", "gate_reject", "gate_fault", "watch_regression",
             "trigger_refused", "disabled", "rules_refused",
             "engineless_rollback", "rollback_unpinned", "step_error")


@pytest.mark.parametrize("name", SCENARIOS)
def test_state_machine_equals_the_reference_over_seams(name, tmp_path):
    want = _scenario(JAX, name, str(tmp_path / "jax"))
    got = _scenario(PORT, name, str(tmp_path / "port"))
    assert got == want
    if name == "happy":
        assert [e["state"] for e in got["entries"]] == [
            "DRIFT_DETECTED", "RETRAIN", "GATE", "STAGED_ROLLOUT", "WATCH",
            "COMMIT"] == got["metrics"]
        assert got["registry"]["values"]["serve.lifecycle.state"] == 6.0
        assert ("prepare", ("cand",), True) in got["actions"]
    if name == "gate_fault":
        assert got["entries"][2]["verdicts"][0]["name"] == "gate_error"
    if name == "step_error":
        assert got["held"] == "DRIFT_DETECTED"
        assert got["registry"]["values"]["lifecycle.step_errors"] == 1
    if name == "engineless_rollback":
        np.testing.assert_array_equal(got["canary"], np.linspace(0.1, 0.4, 4))


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


def _clock():
    t = iter(range(1_700_000_000, 1_700_000_100))
    return lambda: next(t) + 0.25


def _write_journal(pkg, d):
    j = pkg.lifecycle.Journal(d, now_fn=_clock())
    wire = {"trace_id": "41-7", "origin_pid": 41}
    j.append("DRIFT_DETECTED", cycle=0, reason="drift", trace=wire,
             live_member_dirs=["/ckpt/m0", "/ckpt/m1"])
    j.append("RETRAIN", cycle=0, member_dirs=["a", "b"], n_members=2)
    j.append("ROLLBACK", cycle=0, cause="gate_rejected", swapped=False)
    j.append("DRIFT_DETECTED", reason="again", trace=wire)
    j.write_live(["/ckpt/m0", "/ckpt/m1"])
    return j


def test_journal_bytes_equal_the_reference_and_each_reads_the_other(
        tmp_path):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jj, pj = _write_journal(JAX, jd), _write_journal(PORT, pd)
    for name in ("journal.json", "live.json"):
        with open(os.path.join(jd, name), "rb") as a, \
                open(os.path.join(pd, name), "rb") as b:
            assert a.read() == b.read(), name
    for reader, d in ((PORT, jd), (JAX, pd)):
        j = reader.lifecycle.Journal(d)
        assert j.entries == jj.entries == pj.entries
        assert j.state == "DRIFT_DETECTED" and j.cycle == 1
        assert j.cycle_open() and len(j.cycle_entries()) == 1
        assert j.find("RETRAIN", cycle=0)["member_dirs"] == ["a", "b"]
        assert j.read_live() == ["/ckpt/m0", "/ckpt/m1"]


def test_journal_refresh_picks_up_an_append_of_the_other_package(tmp_path):
    d = str(tmp_path / "lc")
    reader = PORT.lifecycle.Journal(d)
    JAX.lifecycle.Journal(d).append("DRIFT_DETECTED", cycle=0, reason="x")
    assert reader.state is None and not reader.cycle_open()
    reader.refresh()
    assert reader.state == "DRIFT_DETECTED" and reader.cycle_open()


def _damage(kind, d):
    path = os.path.join(d, "journal.json")
    if kind == "torn":
        with open(path, "w") as f:
            f.write('{"format": "jama16.lifecycle", "version')
        return
    with open(path) as f:
        doc = json.load(f)
    if kind == "version":
        doc["version"] = 99
    elif kind == "tampered":
        doc["entries"][0]["reason"] = "forged"
    elif kind == "unsealed":
        doc.pop("__seal__")
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("kind", ["torn", "version", "tampered",
                                  "unsealed"])
def test_journal_refusals_equal_the_reference(kind, tmp_path):
    """A torn file, a wrong version and a seal that disagrees with the
    content are refused by both packages, with the same error; an
    unsealed journal loads in both, as the reference's does."""
    results = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        _write_journal(pkg, d)
        _damage(kind, d)
        results[name] = _call(lambda: pkg.lifecycle.Journal(d).entries)
    want, got = results["jax"], results["port"]
    if kind == "unsealed":
        assert got == want and got[0]["state"] == "DRIFT_DETECTED"
        return
    assert got[0] == want[0] == "raised"
    assert got[1] == want[1] == {"torn": "ValueError",
                                 "version": "ValueError",
                                 "tampered": "ArtifactCorrupt"}[kind]
    # The same message; a seal's names the rebuild of the port's own.
    got_msg = got[2].replace(str(tmp_path / "port"), "D")
    want_msg = want[2].replace(str(tmp_path / "jax"), "D")
    if kind == "tampered":
        got_msg, hint = got_msg.split("[journal] — ")
        want_msg = want_msg.split("[journal] — ")[0]
        assert hint.startswith("NOT derivable")
    assert got_msg == want_msg


# ---------------------------------------------------------------------------
# Crash safety
# ---------------------------------------------------------------------------


def _seam_ctl(wd, retrains, reg=None):
    reg = reg if reg is not None else Registry()
    eng = FakeEngine(reg)
    return lifecycle.LifecycleController(
        _cfg(PORT), wd, engine=eng, registry=reg,
        retrain_fn=lambda c, root: retrains.append(root) or ["cand"],
        gate_fns=[_pass_gate(PORT)], live_member_dirs=["live"],
        sleep=lambda s: None)


@pytest.mark.parametrize("k", range(1, 6))
def test_kill_at_every_state_resumes_to_the_reference_terminal(k, tmp_path):
    """Abandon the controller after its k-th journaled state (all kill -9
    leaves: the journal is the only durable state): a fresh controller
    reaches the states of the reference's uninterrupted run, and the
    retrain ran once across both."""
    want = [e["state"] for e in _scenario(
        JAX, "happy", str(tmp_path / "ref"))["entries"]]
    wd = str(tmp_path / "wd")
    retrains: list = []
    ctl = _seam_ctl(wd, retrains)
    ctl.trigger(reason="quality_drift")
    for _ in range(k - 1):
        ctl.step()
    assert [e["state"] for e in ctl.journal.cycle_entries()] == want[:k]
    del ctl
    resumed = _seam_ctl(wd, retrains)
    assert resumed.run() == "COMMIT"
    assert [e["state"] for e in resumed.journal.cycle_entries()] == want
    assert len(retrains) == 1
    assert resumed.journal.read_live() == ["cand"]


_KILL_CHILD = r"""
import os, signal, sys
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.lifecycle import LifecycleController

cfg = configs.override(configs.get_config("smoke"), [
    "lifecycle.enabled=true", "lifecycle.watch_probes=1",
    "lifecycle.watch_interval_s=0"])

def retrain(ctl, root):
    open(sys.argv[2], "a").write("ran\n")
    return ["cand"]

def kill_gate(ctl, cand):
    os.kill(os.getpid(), signal.SIGKILL)

ctl = LifecycleController(cfg, sys.argv[1], retrain_fn=retrain,
                          gate_fns=[kill_gate], live_member_dirs=["live"],
                          sleep=lambda s: None, device="cpu")
ctl.trigger(reason="quality_drift")
ctl.run()
"""


def test_sigkill_in_a_subprocess_resumes_without_a_second_retrain(tmp_path):
    wd, marker = str(tmp_path / "wd"), str(tmp_path / "retrain_ran")
    proc = subprocess.run([sys.executable, "-c", _KILL_CHILD, wd, marker],
                          cwd=REPO, capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    assert lifecycle.Journal(os.path.join(wd, "lifecycle")).state == "RETRAIN"
    eng = FakeEngine(Registry())
    resumed = lifecycle.LifecycleController(
        _cfg(PORT), wd, engine=eng, registry=eng.registry,
        retrain_fn=lambda c, root: (_ for _ in ()).throw(
            AssertionError("retrain repeated after resume")),
        gate_fns=[_pass_gate(PORT)], live_member_dirs=["live"],
        sleep=lambda s: None)
    assert resumed.run() == "COMMIT"
    with open(marker) as f:
        assert f.read() == "ran\n"


# ---------------------------------------------------------------------------
# Real engines on the smoke preset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """Member sets A (live) and B (the candidate) of k=2 seeded random
    members: JAX checkpoints, and the same trees as port member dirs (the
    engine carries them over through ``models/convert.py``); a 16-record
    raw val split; 4 canary images and a reference profile."""
    root = tmp_path_factory.mktemp("lifecycle_real")
    jcfg = _cfg(JAX)
    model = jax_models.build(jcfg.model)
    base, _ = jax_train_lib.create_state(jcfg, model, jax.random.key(0))
    base = jax.device_get(base)
    dirs = {"jax": {}, "port": {}}
    for tag, seed in (("a", 50), ("b", 60)):
        dirs["jax"][tag], dirs["port"][tag] = [], []
        for m in range(2):
            flat = random_flat(model, (2, SIZE, SIZE, 3), seed=seed + m)
            v = variables(flat)
            d = str(root / "jax" / tag / f"member_{m:02d}")
            ck = jax_ckpt.Checkpointer(d)
            ck.save(1, base.replace(params=v["params"],
                                    batch_stats=v["batch_stats"]),
                    {"val_auc": 0.5})
            ck.wait()
            ck.close()
            dirs["jax"][tag].append(d)
            dirs["port"][tag].append(ckpt_lib.member_dir(
                str(root / "port" / tag), m))
            ckpt_lib.save_member(dirs["port"][tag][-1], flat)
    data = str(root / "data")
    jax_tfrecord.write_synthetic_split(data, "val", 16, SIZE, num_shards=2,
                                       seed=5, encoding="raw")
    rng = np.random.default_rng(11)
    canary = rng.integers(0, 256, (4, SIZE, SIZE, 3), np.uint8)
    profile = jax_quality.build_profile(rng.uniform(0.2, 0.8, 2048),
                                        bins=jcfg.obs.quality.score_bins)
    return {"root": root, "dirs": dirs, "data": data, "canary": canary,
            "profile": profile, "model": model}


def _engine(pkg, cfg, member_dirs, real, registry):
    if pkg is JAX:
        return jax_engine.ServingEngine(cfg, member_dirs, model=real["model"],
                                        registry=registry)
    return ServingEngine(cfg, member_dirs, device="cpu", registry=registry)


def _e2e(pkg, real, wd) -> dict:
    """The reference's end-to-end drive: a drifted window fires the
    quality_drift rule -> on_fire opens a cycle -> a degraded candidate
    is rejected at GATE -> a good one promotes through shadow and reload
    -> a regression after the swap trips WATCH -> ROLLBACK. Live
    requests ride the sleep seam, so the shadow's counts are fixed."""
    name = "jax" if pkg is JAX else "port"
    dirs_a, dirs_b = real["dirs"][name]["a"], real["dirs"][name]["b"]
    os.makedirs(wd)
    base = _cfg(pkg)
    probe = _engine(pkg, base, dirs_a, real, pkg.Registry())
    pinned = np.asarray(pkg.metrics.ensemble_average(
        list(probe.member_probs(real["canary"]))), np.float64).ravel()
    canary_path = pkg.quality.save_canary(os.path.join(wd, "canary"),
                                          real["canary"], scores=pinned)
    profile_path = pkg.quality.save_profile(os.path.join(wd, "profile.json"),
                                            real["profile"])
    c1 = pkg.configs.override(base, [
        "obs.quality.enabled=true", f"obs.quality.canary_path={canary_path}",
        "obs.quality.canary_every_s=0",
        f"obs.quality.profile_path={profile_path}",
        "lifecycle.shadow_wait_s=30", "lifecycle.shadow_requests=2",
        "lifecycle.shadow_fraction=1", "lifecycle.gate_eval_rows=16",
        "lifecycle.gate_canary_max_dev=0.000001"])
    reg = pkg.Registry()
    engine = _engine(pkg, c1, dirs_a, real, reg)
    imgs = np.random.default_rng(3).integers(0, 256, (8, SIZE, SIZE, 3),
                                             np.uint8)
    ref_a = engine.probs(imgs)

    def ctl_for(cfg):
        return pkg.lifecycle.LifecycleController(
            cfg, os.path.join(wd, "lc"), engine=engine, registry=reg,
            data_dir=real["data"], retrain_fn=lambda c, root: dirs_b,
            live_member_dirs=dirs_a, sleep=lambda s: engine.probs(imgs))

    ctl = ctl_for(c1)
    rng = np.random.default_rng(13)
    monitor = pkg.quality.QualityMonitor(
        dataclasses.replace(c1.obs.quality, window_scores=256),
        registry=reg, profile=real["profile"])
    mgr = pkg.alerts.AlertManager(pkg.alerts.quality_rules(c1.obs.quality),
                                  registry=reg, on_fire=ctl.on_alert)
    mgr.evaluate(now=0.0)
    idle = ctl.state
    monitor.observe(None, rng.uniform(0.85, 0.99, 256))
    fired = [f["reason"] for f in mgr.evaluate(now=1.0)]
    out = {"idle": idle, "fired": fired, "triggered": ctl.state}
    out["cycle1"] = ctl.run()
    out["gen_after_reject"] = engine.generation
    out["reject_probs_equal"] = bool(np.array_equal(engine.probs(imgs),
                                                    ref_a))
    c2 = pkg.configs.override(c1, ["lifecycle.gate_canary_max_dev=0.5",
                                   "lifecycle.gate_parity_psi_max=100",
                                   "lifecycle.gate_auc_floor_delta=1"])
    ctl2 = ctl_for(c2)
    out["trigger2"] = ctl2.trigger(reason="quality_drift")
    for _ in range(3):
        ctl2.step()
    out["mid"] = ctl2.state
    out["gen_promoted"] = engine.generation
    out["live_promoted"] = ctl2.journal.read_live() == dirs_b
    out["promoted_probs"] = engine.probs(imgs)
    engine.quality.canary.reference = engine.quality.canary.reference + 0.25
    out["cycle2"] = ctl2.run()
    out["live_restored"] = ctl2.journal.read_live() == dirs_a
    out["final_probs"] = engine.probs(imgs)
    out["ref_a"] = ref_a
    out["gen_final"] = engine.generation
    out["canary_restored"] = bool(np.array_equal(
        engine.quality.canary.reference, pinned))
    out["entries"] = [_strip(e) for e in ctl2.journal.entries]
    out["registry"] = _lifecycle_values(reg)
    return out


def _close(a, b, path=""):
    """a == b with floats within 1e-6 (the gates' values, the shadow's
    deviations)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, abs=1e-6), path
    else:
        assert a == b, path


def _normalize(entries, real):
    """Member dirs as their set and member, so two packages' paths
    compare."""
    names = {}
    for pkg in ("jax", "port"):
        for tag in ("a", "b"):
            for m, d in enumerate(real["dirs"][pkg][tag]):
                names[d] = f"{tag}{m}"

    def fix(v):
        if isinstance(v, list):
            return [fix(x) for x in v]
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        return names.get(v, v)

    return [fix(e) for e in entries]


def test_e2e_drift_reject_promote_regression_rollback_equal_the_reference(
        real, tmp_path):
    want = _e2e(JAX, real, str(tmp_path / "jax"))
    got = _e2e(PORT, real, str(tmp_path / "port"))
    assert got["idle"] == "IDLE" and "quality_drift" in got["fired"]
    for k in ("idle", "fired", "triggered", "cycle1", "gen_after_reject",
              "reject_probs_equal", "trigger2", "mid", "gen_promoted",
              "live_promoted", "cycle2", "live_restored", "gen_final",
              "canary_restored"):
        assert got[k] == want[k], k
    assert (got["cycle1"], got["cycle2"]) == ("ROLLBACK", "ROLLBACK")
    assert got["reject_probs_equal"] and got["canary_restored"]
    assert got["gen_final"] == 2
    # The restored generation scores bitwise as before the cycle.
    np.testing.assert_array_equal(got["final_probs"], got["ref_a"])
    np.testing.assert_allclose(got["promoted_probs"], want["promoted_probs"],
                               rtol=0, atol=1e-6)
    # States, verdicts and the gates' values (canary deviation, PSI,
    # candidate and live AUC) equal within 1e-6; the shadow saw 2 live
    # requests in both.
    _close(_normalize(got["entries"], real), _normalize(want["entries"],
                                                         real))
    gate = [e for e in got["entries"] if e["state"] == "GATE"][0]
    assert [v["name"] for v in gate["verdicts"]] == [
        "golden_canary", "profile_parity", "auc_floor"]
    assert not any(v["skipped"] for v in gate["verdicts"])
    assert gate["verdicts"][0]["passed"] is False
    rollout = [e for e in got["entries"]
               if e["state"] == "STAGED_ROLLOUT"][0]
    assert rollout["shadow"]["requests"] >= 2 and rollout["canary_repinned"]
    _close(got["registry"], want["registry"])


def test_multi_head_canary_convention_and_cascade_unwrap(real, tmp_path):
    """The canary's scores and re-pin take the engine's raw raveled
    [n*C] shape for the 5-class head, as the reference's; a cascade hands
    the controller its ensemble."""
    cfg = configs.override(_cfg(PORT), ["model.head=multi"])
    from jama16_retina_tpu_torch import models
    from jama16_retina_tpu_torch.models import init

    sd = init.init_flax_default(models.build(cfg.model), 3).state_dict()
    probe = ServingEngine(cfg, state_dicts=[sd], device="cpu",
                          registry=Registry())
    pinned = np.asarray(metrics.ensemble_average(list(
        probe.member_probs(real["canary"]))), np.float64).ravel()
    assert pinned.shape == (4 * 5,)
    path = quality.save_canary(str(tmp_path / "canary"), real["canary"],
                               scores=pinned)
    ecfg = configs.override(cfg, [
        "obs.quality.enabled=true", f"obs.quality.canary_path={path}",
        "obs.quality.canary_every_s=0"])
    reg = Registry()
    engine = ServingEngine(ecfg, state_dicts=[sd], device="cpu",
                           registry=reg)
    ctl = lifecycle.LifecycleController(ecfg, str(tmp_path / "wd"),
                                        engine=engine, registry=reg,
                                        sleep=lambda s: None)
    assert ctl.device == engine.device
    cand = engine.prepare_candidate(state_dicts=[sd])
    v = controller.gate_golden_canary(ctl, cand)
    assert not v.skipped and v.passed and v.value == 0.0
    assert ctl._repin_canary(cand) is True
    np.testing.assert_array_equal(engine.quality.canary.reference, pinned)

    dirs = real["dirs"]["port"]["a"]
    cascade = assemble_lib.assemble(assemble_lib.EngineSpec(
        cfg=_cfg(PORT), member_dirs=tuple(dirs), student_dirs=(dirs[0],),
        device="cpu", registry=Registry()))
    ctl = lifecycle.LifecycleController(_cfg(PORT), str(tmp_path / "c"),
                                        engine=cascade, sleep=lambda s: None)
    assert ctl.cascade is cascade and ctl.engine is cascade.ensemble
    assert ctl.registry is cascade.ensemble.registry
    assert ctl.live_member_dirs() == dirs


# ---------------------------------------------------------------------------
# The default retrain
# ---------------------------------------------------------------------------


def test_default_retrain_seeds_configs_and_markers_equal_the_reference(
        tmp_path, monkeypatch):
    """With the fit replaced by a recorder in both packages: the same
    seeds, workdirs and warm-start fields per member, the same marker
    payload keys and schema, and a durable member reused."""
    results = {}
    for name, pkg in PKGS.items():
        calls = []

        def fake_fit(cfg, data_dir, workdir, seed=None, **kw):
            calls.append({"data_dir": data_dir, "workdir": workdir,
                          "seed": seed, "init_from": cfg.train.init_from,
                          "steps": cfg.train.steps,
                          "resume": cfg.train.resume})
            return {"best_auc": 0.75, "best_step": 3,
                    "stopped_early": False}

        monkeypatch.setattr(pkg.trainer, "fit", fake_fit)
        ctl = pkg.lifecycle.LifecycleController(
            _cfg(pkg, ["lifecycle.retrain_steps=3", "train.seed=7"]),
            str(tmp_path / name / "wd"), registry=pkg.Registry(),
            data_dir="DATA", live_member_dirs=["m0", "m1"],
            sleep=lambda s: None)
        ctl.journal.entries = [{"seq": 0, "cycle": 2,
                                "state": "DRIFT_DETECTED"}]
        root = str(tmp_path / name / "cand")
        dirs = pkg.controller._default_retrain(ctl, root)
        markers = []
        for d in dirs:
            doc, seal = pkg.artifact.read_sealed_json(
                os.path.join(d, "RETRAIN_DONE.json"))
            doc.pop("t")
            markers.append((doc, seal["schema"], seal["schema_version"]))
        again = pkg.controller._default_retrain(ctl, root)
        results[name] = {
            "dirs": [os.path.relpath(d, root) for d in dirs],
            "again": again == dirs, "markers": markers,
            "calls": [{**c, "workdir": os.path.relpath(c["workdir"], root)}
                      for c in calls]}
    assert results["port"] == results["jax"]
    assert [c["seed"] for c in results["port"]["calls"]] == [3007, 3008]
    assert results["port"]["markers"][0][1] == "lifecycle.retrain_marker"


def test_default_retrain_fits_on_the_cpu_and_reuses_a_durable_member(
        real, tmp_path, monkeypatch):
    """A real warm-start fit of one member on the CPU: the candidate's run
    log has the warm start from the live member, and a second drive does
    not fit again."""
    data = str(tmp_path / "data")
    jax_tfrecord.write_synthetic_split(data, "train", 8, SIZE, num_shards=1,
                                       seed=1, encoding="raw")
    jax_tfrecord.write_synthetic_split(data, "val", 8, SIZE, num_shards=1,
                                       seed=2, encoding="raw")
    live = real["dirs"]["port"]["a"][:1]
    ctl = lifecycle.LifecycleController(
        _cfg(PORT, ["lifecycle.retrain_steps=2", "train.log_every=1",
                    "train.eval_every=2", "data.batch_size=4",
                    "data.augment=false", "eval.batch_size=4",
                    "obs.flush_every_s=0"]),
        str(tmp_path / "wd"), registry=Registry(), data_dir=data,
        live_member_dirs=live, gate_fns=[_pass_gate(PORT)],
        sleep=lambda s: None, device="cpu")
    ctl.trigger(reason="quality_drift")
    fits = []
    real_fit = trainer.fit
    monkeypatch.setattr(trainer, "fit", lambda *a, **kw: fits.append(
        kw["device"]) or real_fit(*a, **kw))
    root = ctl._candidate_root()
    dirs = controller._default_retrain(ctl, root)
    assert fits == ["cpu"]
    recs = read_jsonl(os.path.join(dirs[0], "metrics.jsonl"))
    assert [r["init_from"] for r in recs if r["kind"] == "warm_start"] == live
    assert controller._default_retrain(ctl, root) == dirs and len(fits) == 1


# ---------------------------------------------------------------------------
# The operator CLI and the run log
# ---------------------------------------------------------------------------


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _scrub(text, *pairs):
    for old, new in pairs:
        text = text.replace(old, new)
    return text


def test_cli_status_trigger_and_step_equal_the_reference(real, tmp_path,
                                                         capsys):
    """Each package's CLI on its own workdir, the same commands: the same
    output and JSON apart from ``t``, the trace id and the paths, and
    the same exit codes (0, and 2 at ROLLBACK)."""
    jax_main = _load_script("lifecycle_run").main
    outs = {}
    for name, main in (("jax", jax_main), ("port", lifecycle_run.main)):
        pkg = PKGS[name]
        wd = str(tmp_path / name / "wd")
        dirs = real["dirs"][name]
        common = ["--workdir", wd, "--config", "smoke",
                  *sum((["--set", s] for s in SMOKE + [
                      "lifecycle.shadow_wait_s=0",
                      "lifecycle.gate_eval_rows=16",
                      "lifecycle.watch_rules=serve.generation >= 0"]), [])]
        extra = ["--device", "cpu"] if name == "port" else []
        got = [_cli(main, common + ["--status", "--json"], capsys),
               _cli(main, common + ["--trigger", "manual", "--ckpt",
                                    *dirs["a"]], capsys),
               _cli(main, common + ["--trigger", "manual"], capsys),
               _cli(main, common + ["--status", "--json"], capsys)]
        j = pkg.lifecycle.Journal(os.path.join(wd, "lifecycle"))
        j.append("RETRAIN", cycle=0, member_dirs=dirs["b"], n_members=2)
        got.append(_cli(main, common + extra + [
            "--data_dir", real["data"], "--ckpt", *dirs["a"], "--step",
            "--json"], capsys))
        j.refresh()
        j.append("STAGED_ROLLOUT", cycle=0, generation=1, shadow={},
                 canary_repinned=False)
        j.write_live(dirs["b"])
        got.append(_cli(main, common + extra + [
            "--data_dir", real["data"], "--step", "--json"], capsys))
        got.append(_cli(main, common + extra + ["--step", "--json"],
                        capsys))
        got.append(_cli(main, common + ["--status"], capsys))
        trace = pkg.lifecycle.Journal(os.path.join(wd, "lifecycle")).find(
            "DRIFT_DETECTED")["trace"]["trace_id"]
        pairs = [(str(tmp_path / name), "ROOT"), (trace, "TRACE")]
        pairs += [(d, f"{tag}{m}") for tag in ("a", "b")
                  for m, d in enumerate(dirs[tag])]
        outs[name] = [(rc, _scrub(o, *pairs)) for rc, o in got]
    want, got = outs["jax"], outs["port"]
    assert [rc for rc, _ in got] == [rc for rc, _ in want] == [
        0, 0, 0, 0, 0, 0, 2, 0]
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        if g.startswith("{"):
            g, w = json.loads(g), json.loads(w)
            for doc in (g, w):
                for e in doc.get("timeline", []) + [doc.get("entry") or {}]:
                    e.pop("t", None)
            _close(g, w, f"output {i}")
        else:
            assert g == w, i
    assert "opened (reason=manual, trace TRACE)" in got[1][1]
    assert "refused" in got[2][1]
    gate = json.loads(got[4][1])["entry"]
    assert gate["state"] == "GATE" and gate["verdicts"][2]["name"] == \
        "auc_floor" and not gate["verdicts"][2]["skipped"]
    assert json.loads(got[5][1])["entry"]["healthy"] is False
    rollback = json.loads(got[6][1])
    assert rollback["state"] == "ROLLBACK" and rollback["entry"][
        "restored_generation"] == 1


def test_obs_report_renders_the_port_run_log_as_the_reference_s(tmp_path):
    """The reference's ``obs_report`` Lifecycle section from the port
    controller's ``lifecycle`` records is the one from the JAX
    controller's, for a cycle that commits and one rejected at GATE."""
    obs_report = _load_script("obs_report")
    for scenario in ("happy", "gate_reject"):
        texts, summaries = {}, {}
        for name, pkg in PKGS.items():
            wd = str(tmp_path / scenario / name)
            _scenario(pkg, scenario, wd)
            recs = read_jsonl(os.path.join(wd, "metrics.jsonl"))
            texts[name] = obs_report.render_lifecycle(recs)
            s = obs_report.lifecycle_summary(recs)
            for e in s["timeline"]:
                e.pop("t")
            summaries[name] = s
        assert texts["port"] == texts["jax"] and "lifecycle:" in texts["port"]
        assert summaries["port"] == summaries["jax"]
