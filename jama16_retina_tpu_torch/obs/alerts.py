"""Declarative SLO and quality alert rules over registry snapshots
(counterpart of ``jama16_retina_tpu/obs/alerts.py``).

A rule is

    metric OP threshold [for SECONDS] [-> reason]

e.g. ``quality.score_psi > 0.2 for 120 -> quality_drift`` or
``serve.request_latency_s.p99 > 0.5 for 60``. A metric resolves against
the gauges, then the counters, then ``<histogram>.{p50,p95,p99,mean,
count,sum}``; ``rate(counter)`` is the counter's per-second delta between
two snapshots (none on the first, so a rate rule never fires cold). The
condition must hold for ``for`` seconds before the rule fires. On firing
the manager writes an ``alert`` record (state ``firing``, and
``resolved`` when the condition clears), trips the flight recorder with
the rule's reason (one dump per reason per run), counts
``obs.alerts_fired`` and calls ``on_fire`` once. A metric absent from
the snapshot leaves its rule inactive, so the built-in rules are safe to
install unconditionally.

The fleet grammar (``burn()`` rules, evaluated by the fleet aggregator)
comes with the fleet plane, ROADMAP item 11, part 5.
"""

from __future__ import annotations

import dataclasses
import logging
import operator
import re
import time

from jama16_retina_tpu_torch.obs import registry as registry_lib

_log = logging.getLogger(__name__)

_OPS = {
    ">": operator.gt, ">=": operator.ge,
    "<": operator.lt, "<=": operator.le,
    "==": operator.eq, "!=": operator.ne,
}

_HIST_FIELDS = ("p50", "p95", "p99", "mean", "count", "sum")

_RULE_RE = re.compile(
    r"^\s*(?P<metric>rate\([A-Za-z0-9_.]+\)|[A-Za-z0-9_.]+)\s*"
    r"(?P<op>>=|<=|==|!=|>|<)\s*"
    r"(?P<threshold>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*"
    r"(?:for\s+(?P<for>[0-9]*\.?[0-9]+)\s*s?)?\s*"
    r"(?:->\s*(?P<reason>[A-Za-z0-9_]+))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    metric: str
    op: str
    threshold: float
    for_seconds: float = 0.0
    reason: str = "slo_breach"

    @property
    def name(self) -> str:
        txt = f"{self.metric}{self.op}{self.threshold:g}"
        if self.for_seconds:
            txt += f" for {self.for_seconds:g}s"
        return txt


def parse_rule(text: str) -> AlertRule:
    """One rule from the declarative grammar above; raises on anything
    it cannot parse COMPLETELY (a half-understood alert rule is worse
    than none)."""
    m = _RULE_RE.match(text)
    if not m:
        raise ValueError(
            f"cannot parse alert rule {text!r}; expected "
            "'metric OP threshold [for SECONDS] [-> reason]', e.g. "
            "'quality.score_psi > 0.2 for 120 -> quality_drift'"
        )
    if m.group("op") not in _OPS:  # pragma: no cover - regex pins these
        raise ValueError(f"unknown operator in alert rule {text!r}")
    return AlertRule(
        metric=m.group("metric"),
        op=m.group("op"),
        threshold=float(m.group("threshold")),
        for_seconds=float(m.group("for") or 0.0),
        reason=m.group("reason") or "slo_breach",
    )


def quality_rules(qcfg) -> list:
    """The rule set one QualityConfig implies: the built-in drift/canary
    triad when the monitor is enabled (all reason=quality_drift — the
    flight-recorder trigger the acceptance pins), plus every user rule
    string. Empty when quality is off and no user rules exist."""
    rules: list = []
    if getattr(qcfg, "enabled", False):
        f = float(getattr(qcfg, "alert_for_s", 0.0))
        rules += [
            AlertRule("quality.score_psi", ">", float(qcfg.psi_alert),
                      for_seconds=f, reason="quality_drift"),
            AlertRule("quality.input_psi_max", ">",
                      float(qcfg.input_psi_alert),
                      for_seconds=f, reason="quality_drift"),
            AlertRule("quality.canary_ok", "<", 1.0,
                      for_seconds=f, reason="quality_drift"),
        ]
    for text in getattr(qcfg, "alert_rules", ()) or ():
        rules.append(parse_rule(text))
    return rules


def reliability_rules(cfg) -> list:
    """The reliability rule set one ExperimentConfig implies.

    Shedding thresholds are EXPRESSED as alert rules over the exact
    gauges the MicroBatcher's shed decision reads
    (``serve.batcher.{queue_depth,in_flight}``), so "we are shedding"
    and "we are alerting" can never disagree; the quarantine rule
    reads the data plane's ``data.quarantined`` burn rate (one poison
    record is routine, a sustained stream is systemic rot); the reload
    rule fires on any rejected rollout. Rules over metrics that never
    get published are inactive — installing these unconditionally
    costs nothing on runs that never shed/quarantine/reload."""
    rules: list = []
    sc = getattr(cfg, "serve", None)
    oc = getattr(cfg, "obs", None)
    if sc is not None:
        if sc.shed_queue_depth > 0:
            rules.append(AlertRule(
                "serve.batcher.queue_depth", ">=",
                float(sc.shed_queue_depth), reason="overload_shed",
            ))
        if sc.shed_in_flight > 0:
            rules.append(AlertRule(
                "serve.batcher.in_flight", ">=",
                float(sc.shed_in_flight), reason="overload_shed",
            ))
    per_s = float(getattr(oc, "quarantine_alert_per_s", 0.0) or 0.0)
    if per_s > 0:
        rules.append(AlertRule(
            "rate(data.quarantined)", ">", per_s, reason="data_quarantine",
        ))
    rules.append(AlertRule(
        "rate(serve.reload_rejected)", ">", 0.0, reason="reload_rejected",
    ))
    # Front-door router: sustained dispatch imbalance means
    # the policy (or a sick replica) is concentrating load; a latched
    # scaler-saturation gauge means demand wants more replicas than
    # serve.scaler_max_replicas allows. Both are inactive until the
    # router publishes its gauges.
    rules.append(AlertRule(
        "serve.router.imbalance", ">", 3.0, for_seconds=60.0,
        reason="router_imbalance",
    ))
    rules.append(AlertRule(
        "serve.scaler.saturated", ">=", 1.0, for_seconds=120.0,
        reason="scaler_saturated",
    ))
    # Durable-state integrity: ANY detected artifact
    # corruption (a sealed checksum or seal sidecar failing on load)
    # pages — silent on-disk rot is the failure mode the stack cannot
    # otherwise see. Inactive until integrity.corrupt first counts.
    rules.append(AlertRule(
        "rate(integrity.corrupt)", ">", 0.0, reason="artifact_corrupt",
    ))
    # Device-utilization plane: sustained low HBM headroom
    # on the tightest local device pages BEFORE the allocator OOMs —
    # the gauge is the DeviceMonitor's worst-device view. Inactive on
    # backends without memory_stats (the gauge never publishes).
    headroom = float(getattr(oc, "device_hbm_headroom_alert", 0.0) or 0.0)
    if headroom > 0:
        rules.append(AlertRule(
            "device.hbm.headroom_frac", "<", headroom,
            for_seconds=60.0, reason="hbm_pressure",
        ))
    return rules


def manager_for(cfg, workdir: str, registry=None,
                on_fire=None) -> "AlertManager | None":
    """The AlertManager a TRAINERLESS process (serving session, batch
    predict) hangs on its Snapshotter: the rules ``cfg.obs.quality``
    implies, wired to a fresh FlightRecorder over ``workdir`` so a
    firing rule writes `alert` records AND trips its
    ``quality_drift``/``slo_breach`` blackbox dump (one per reason per
    run) exactly like a train run. None when obs is off or the config
    implies no rules. One copy of this wiring — the trainer keeps its
    own because its FlightRecorder carries profiler capture hooks and
    step/loss sentinels no serving process has."""
    from jama16_retina_tpu_torch.obs import flightrec

    if not cfg.obs.enabled:
        return None
    rules = quality_rules(cfg.obs.quality) + reliability_rules(cfg)
    if not rules:
        return None
    flight = flightrec.FlightRecorder(
        workdir,
        config=dataclasses.asdict(cfg),
        registry=registry,
        blackbox_events=cfg.obs.blackbox_events,
        # No step loop to watch in a serving/predict process.
        slow_step_factor=float("inf"),
        blackbox_keep=cfg.obs.blackbox_keep,
    )
    return AlertManager(rules, registry=registry, flight=flight,
                        on_fire=on_fire)


def resolve_metric(snapshot: dict, metric: str,
                   prev: "dict | None" = None,
                   dt: "float | None" = None) -> "float | None":
    """A rule's metric reference against one snapshot; None = no data.
    ``prev``/``dt`` feed the rate() form (previous snapshot and the
    seconds between them)."""
    if metric.startswith("rate(") and metric.endswith(")"):
        inner = metric[len("rate("):-1]
        if prev is None or not dt or dt <= 0:
            return None
        cur_v = snapshot.get("counters", {}).get(inner)
        prev_v = prev.get("counters", {}).get(inner)
        if cur_v is None or prev_v is None:
            return None
        return (cur_v - prev_v) / dt
    gauges = snapshot.get("gauges", {})
    if metric in gauges:
        return float(gauges[metric])
    counters = snapshot.get("counters", {})
    if metric in counters:
        return float(counters[metric])
    base, _, field = metric.rpartition(".")
    if field in _HIST_FIELDS:
        h = snapshot.get("histograms", {}).get(base)
        if h is not None and h.get(field) is not None:
            return float(h[field])
    return None


def rule_holds(rule: AlertRule, snapshot: dict) -> bool:
    """One stateless evaluation of a rule's CONDITION against one
    snapshot — no `for` latching, no rate() history. The lifecycle
    WATCH phase uses this to probe its regression rules at its own
    cadence; a missing metric is False (no evidence, no regression)."""
    value = resolve_metric(snapshot, rule.metric)
    return value is not None and _OPS[rule.op](value, rule.threshold)


class _RuleState:
    __slots__ = ("since", "firing")

    def __init__(self):
        self.since: "float | None" = None
        self.firing = False


class AlertManager:
    """Evaluate a rule set against successive registry snapshots.

    One per process (trainer run or serving session); normally driven
    by the Snapshotter's flush (``export.Snapshotter(alerts=...)``), so
    alert latency == telemetry cadence. ``flight`` is the run's
    FlightRecorder (or None): a rule's firing transition trips
    ``flight.dump(rule.reason)``, one dump per reason per run (the
    recorder's rate limit). Not thread-safe by design — exactly one flush loop
    drives it (the Snapshotter contract).
    """

    def __init__(self, rules, registry: "registry_lib.Registry | None" = None,
                 flight=None, on_fire=None):
        self.rules = [
            r if isinstance(r, AlertRule) else parse_rule(r) for r in rules
        ]
        self._registry = (
            registry if registry is not None
            else registry_lib.default_registry()
        )
        self._flight = flight
        # The action seam: ``on_fire(info_dict)`` runs ONCE
        # per rule transition to firing — never re-invoked while the
        # rule stays latched — so alerts become actions (the lifecycle
        # controller's trigger rides here). Callback exceptions are
        # COUNTED (obs.alert_callback_errors) and logged, never raised
        # into the Snapshotter's flush thread: a broken action handler
        # must not kill telemetry export.
        self.on_fire = on_fire
        self._state = {r.name: _RuleState() for r in self.rules}
        self._prev_snapshot: "dict | None" = None
        self._prev_t: "float | None" = None
        self._c_fired = self._registry.counter(
            "obs.alerts_fired",
            help="alert rules that transitioned to firing this run",
        )
        self._c_cb_errors = self._registry.counter(
            "obs.alert_callback_errors",
            help="exceptions raised by the on_fire callback (swallowed; "
                 "the flush thread survives)",
        )

    def evaluate(self, snapshot: "dict | None" = None,
                 now: "float | None" = None, runlog=None) -> list:
        """One evaluation pass; returns the currently-FIRING rules as
        dicts (rule/metric/value/threshold/for_s/reason). ``runlog``
        receives the firing/resolved transition records."""
        now = time.time() if now is None else now
        if snapshot is None:
            snapshot = self._registry.snapshot()
        dt = (now - self._prev_t) if self._prev_t is not None else None
        firing = []
        for rule in self.rules:
            st = self._state[rule.name]
            value = resolve_metric(
                snapshot, rule.metric, prev=self._prev_snapshot, dt=dt
            )
            cond = value is not None and _OPS[rule.op](value, rule.threshold)
            if cond:
                if st.since is None:
                    st.since = now
                held = now - st.since
                if not st.firing and held >= rule.for_seconds:
                    st.firing = True
                    self._c_fired.inc()
                    if runlog is not None:
                        runlog.write(
                            "alert", rule=rule.name, state="firing",
                            metric=rule.metric, value=round(value, 6),
                            threshold=rule.threshold,
                            for_s=round(held, 3), reason=rule.reason,
                        )
                    if self._flight is not None:
                        self._flight.dump(
                            rule.reason, rule=rule.name,
                            metric=rule.metric, value=round(value, 6),
                            threshold=rule.threshold,
                        )
                    if self.on_fire is not None:
                        try:
                            self.on_fire({
                                "rule": rule.name, "metric": rule.metric,
                                "value": value,
                                "threshold": rule.threshold,
                                "for_s": held, "reason": rule.reason,
                            })
                        except Exception as e:  # noqa: BLE001
                            self._c_cb_errors.inc()
                            _log.error(
                                "alert on_fire callback failed for %s: "
                                "%s: %s", rule.name, type(e).__name__, e,
                            )
                if st.firing:
                    firing.append({
                        "rule": rule.name, "metric": rule.metric,
                        "value": value, "threshold": rule.threshold,
                        "for_s": held, "reason": rule.reason,
                    })
            else:
                if st.firing and runlog is not None:
                    runlog.write(
                        "alert", rule=rule.name, state="resolved",
                        metric=rule.metric,
                        value=(round(value, 6) if value is not None
                               else None),
                        reason=rule.reason,
                    )
                st.since = None
                st.firing = False
        self._prev_snapshot = snapshot
        self._prev_t = now
        return firing

    def firing(self) -> list:
        """Rule names currently in the firing state (between evaluates)."""
        return [name for name, st in self._state.items() if st.firing]
