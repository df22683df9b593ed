"""The port's alert plane (``obs/alerts.py``) against the JAX package's on
the CPU: the rule grammar, the rule sets every preset implies, the
trainerless ``manager_for`` wiring, and ``AlertManager.evaluate`` over
one scripted sequence of snapshots with an injected clock.

Everything is compared exactly: rules as dataclass fields, firing lists,
``alert`` records (minus the log's own time) and blackbox dumps.
"""

import dataclasses
import json
import os

import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu.obs import alerts as jax_alerts
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.obs import alerts, registry

GOOD = [
    "quality.score_psi > 0.2 for 120 -> quality_drift",
    "serve.request_latency_s.p99 > 0.5 for 60",
    "rate(serve.reload_rejected) > 0",
    "serve.batcher.queue_depth>=32",
    "x.y_z <= -1.5e-3 for 2.5s -> my_reason",
    "  a == 1  ",
    "a != .5 -> r",
    "a<3",
]
BAD = [
    "", "quality.score_psi", "a > ", "a >> 1", "a > 1 for x",
    "a > 1 -> bad-reason", "rate(a > 1", "burn(a/b, 300, 60) > 0.02",
    "a > 1 extra", "a => 1",
]


def _fields(rules) -> list:
    return [(dataclasses.asdict(r), r.name) for r in rules]


def test_parse_rule_corpus_equals_the_references():
    for text in GOOD:
        assert _fields([alerts.parse_rule(text)]) == _fields(
            [jax_alerts.parse_rule(text)]), text
    for text in BAD:
        with pytest.raises(ValueError) as ours:
            alerts.parse_rule(text)
        with pytest.raises(ValueError) as theirs:
            jax_alerts.parse_rule(text)
        assert str(ours.value) == str(theirs.value)


VARIANTS = [
    [],
    ["obs.quality.enabled=true", "obs.quality.psi_alert=0.3",
     "obs.quality.input_psi_alert=0.4", "obs.quality.alert_for_s=30"],
    ["obs.quality.alert_rules=serve.engine.rows > 0 -> slo_breach",
     "serve.shed_queue_depth=8", "serve.shed_in_flight=16"],
]


@pytest.mark.parametrize("preset", sorted(configs.PRESETS))
@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_quality_and_reliability_rules_equal_the_references(preset,
                                                            variant):
    items = VARIANTS[variant]
    ours = configs.override(configs.get_config(preset), items)
    theirs = jax_configs.override(jax_configs.get_config(preset), items)
    configs.check_supported(ours)
    assert _fields(alerts.quality_rules(ours.obs.quality)) == _fields(
        jax_alerts.quality_rules(theirs.obs.quality))
    assert _fields(alerts.reliability_rules(ours)) == _fields(
        jax_alerts.reliability_rules(theirs))
    reasons = {r.reason for r in alerts.reliability_rules(ours)}
    assert {"hbm_pressure", "data_quarantine", "reload_rejected"} <= reasons


def test_manager_for_wires_the_references_rules_and_recorder(tmp_path):
    items = VARIANTS[2] + ["obs.blackbox_events=64", "obs.blackbox_keep=3"]
    ours = configs.override(configs.get_config("smoke"), items)
    theirs = jax_configs.override(jax_configs.get_config("smoke"), items)
    m = alerts.manager_for(ours, str(tmp_path / "p"),
                           registry=registry.Registry())
    jm = jax_alerts.manager_for(theirs, str(tmp_path / "j"),
                                registry=jax_registry.Registry())
    assert _fields(m.rules) == _fields(jm.rules)
    for attr in ("blackbox_events", "blackbox_keep", "slow_step_factor",
                 "diagnosis", "diagnosis_top_k"):
        assert getattr(m._flight, attr) == getattr(jm._flight, attr), attr
    assert m._flight.blackbox_dir == str(tmp_path / "p" / "blackbox")
    off = configs.override(ours, ["obs.enabled=false"])
    assert alerts.manager_for(off, str(tmp_path)) is None
    assert jax_alerts.manager_for(
        jax_configs.override(theirs, ["obs.enabled=false"]),
        str(tmp_path)) is None


class _Log:
    def __init__(self):
        self.records = []

    def write(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


class _Flight:
    def __init__(self):
        self.dumps = []

    def dump(self, reason, **meta):
        self.dumps.append((reason, meta))
        return reason


SCRIPT = [
    # (now, counters, gauges, histograms)
    (0.0, {"serve.reload_rejected": 0, "c": 1}, {"quality.score_psi": 0.1},
     {}),
    (10.0, {"serve.reload_rejected": 0, "c": 5}, {"quality.score_psi": 0.3},
     {"serve.request_latency_s": {"p99": 0.7, "count": 3}}),
    (20.0, {"serve.reload_rejected": 2, "c": 5}, {"quality.score_psi": 0.3},
     {"serve.request_latency_s": {"p99": 0.9, "count": 9}}),
    (45.0, {"serve.reload_rejected": 2, "c": 6}, {"quality.score_psi": 0.35},
     {"serve.request_latency_s": {"p99": 0.2, "count": 12}}),
    (50.0, {"serve.reload_rejected": 3, "c": 6}, {"quality.score_psi": 0.1},
     {}),
    (60.0, {"serve.reload_rejected": 3, "c": 9}, {}, {}),
]
RULES = [
    "quality.score_psi > 0.2 for 20 -> quality_drift",
    "serve.request_latency_s.p99 > 0.5",
    "rate(serve.reload_rejected) > 0 -> reload_rejected",
    "rate(c) >= 0.3 -> burn",
    "missing.metric > 0",
]


def _evaluate(lib, reg_lib):
    log, flight, fired = _Log(), _Flight(), []

    def on_fire(info):
        fired.append(info)
        if info["reason"] == "burn":
            raise RuntimeError("handler failed")

    reg = reg_lib.Registry()
    m = lib.AlertManager(RULES, registry=reg, flight=flight,
                         on_fire=on_fire)
    firing = []
    for now, counters, gauges, hists in SCRIPT:
        snap = {"counters": counters, "gauges": gauges, "histograms": hists}
        firing.append(m.evaluate(snapshot=snap, now=now, runlog=log))
        firing.append(m.firing())
    return (firing, log.records, flight.dumps, fired,
            reg.snapshot()["counters"])


def test_alert_manager_fires_and_resolves_as_the_reference():
    ours = _evaluate(alerts, registry)
    theirs = _evaluate(jax_alerts, jax_registry)
    assert ours == theirs
    firing, records, dumps, fired, counters = ours
    assert [(r["rule"], r["state"]) for r in records] == [
        ("serve.request_latency_s.p99>0.5", "firing"),
        ("rate(c)>=0.3", "firing"),
        ("rate(serve.reload_rejected)>0", "firing"),
        ("rate(c)>=0.3", "resolved"),
        ("quality.score_psi>0.2 for 20s", "firing"),
        ("serve.request_latency_s.p99>0.5", "resolved"),
        ("rate(serve.reload_rejected)>0", "resolved"),
        ("quality.score_psi>0.2 for 20s", "resolved"),
        ("rate(serve.reload_rejected)>0", "firing"),
        ("rate(serve.reload_rejected)>0", "resolved"),
        ("rate(c)>=0.3", "firing")]
    # The stub recorder keeps every dump; the real one one per reason.
    assert [d[0] for d in dumps] == [
        "slo_breach", "burn", "reload_rejected", "quality_drift",
        "reload_rejected", "burn"]
    assert [f["reason"] for f in fired] == [d[0] for d in dumps]
    assert counters == {"obs.alerts_fired": 6.0,
                        "obs.alert_callback_errors": 2.0}
    assert firing[0] == [] and firing[-1] == ["rate(c)>=0.3"]


def test_rule_holds_and_resolve_metric_equal_the_references():
    snap = {"counters": {"a": 2.0}, "gauges": {"g": 1.0, "a": 5.0},
            "histograms": {"h": {"p50": 0.1, "mean": None, "count": 4}}}
    for metric in ("a", "g", "h.p50", "h.mean", "h.count", "h.p99",
                   "rate(a)", "nope", "h"):
        assert alerts.resolve_metric(snap, metric) == \
            jax_alerts.resolve_metric(snap, metric), metric
    prev = {"counters": {"a": 1.0}}
    assert alerts.resolve_metric(snap, "rate(a)", prev, 4.0) == 0.25
    for text in ("g >= 1", "a > 4", "h.mean > 0", "nope < 1"):
        rule = alerts.parse_rule(text)
        assert alerts.rule_holds(rule, snap) == jax_alerts.rule_holds(
            jax_alerts.parse_rule(text), snap)


def test_a_firing_rule_trips_a_real_dump(tmp_path):
    cfg = configs.override(configs.get_config("smoke"), [
        "obs.quality.alert_rules=serve.engine.rows > 0 for 0 -> slo_breach"])
    reg = registry.Registry()
    m = alerts.manager_for(cfg, str(tmp_path), registry=reg)
    reg.counter("serve.engine.rows").inc(3)
    log = _Log()
    assert [f["reason"] for f in m.evaluate(runlog=log)] == ["slo_breach"]
    [d] = os.listdir(tmp_path / "blackbox")
    meta = json.load(open(tmp_path / "blackbox" / d / "meta.json"))
    assert meta["reason"] == "slo_breach" and meta["value"] == 3.0
    assert log.records[0]["state"] == "firing"
