"""The drift-to-retrain state machine (counterpart of
``jama16_retina_tpu/lifecycle/controller.py``).

One controller drives one serving deployment around the loop::

    IDLE --trigger(alert)--> DRIFT_DETECTED
      --retrain--------> RETRAIN          (warm-start fine-tunes, durable
                                           candidate checkpoints)
      --gates----------> GATE             (named verdicts: golden canary,
                                           profile parity, AUC floor;
                                           fail -> ROLLBACK)
      --shadow+promote-> STAGED_ROLLOUT   (ServingEngine.begin_shadow over
                                           live traffic, canary re-pin,
                                           the reload swap, live pointer)
      --regress-window-> WATCH            (declarative rules over the
                                           quality gauges)
      --------> COMMIT  or  ROLLBACK      (engine.rollback() re-swaps the
                                           retained previous generation)

Crash safety: every arrival is one atomic append to the journal
(``lifecycle/journal.py``), and each step is idempotent (the retrain
skips members whose candidates are durable, the gates only evaluate, the
promote re-applies the live pointer, the rollback re-swaps), so a
controller killed at any state, even between a step's work and its
append, resumes by re-running at most that one step and reaches the
same terminal state.

Seams: ``retrain_fn``, ``gate_fns`` and the watch rules are injectable;
the defaults are the real thing: ``trainer.fit`` with ``train.init_from``
on the controller's device (the engine's), gates scored through the
engine's generations (kernel B4 on the fused path) over the val split,
and registry probes. The fault sites ``lifecycle.retrain``,
``lifecycle.gate`` and ``lifecycle.swap`` (``obs/faultinject.py``) fail
each phase; a gate that cannot run fails closed. A ``CascadeEngine``
unwraps to its ensemble: the retrain, gates, shadow, swap and rollback
act on the ensemble while the student keeps serving.

The journal entries, the registry's names and help strings, the run-log
``lifecycle`` records and the gates' values are the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.integrity import artifact as artifact_lib
from jama16_retina_tpu_torch.lifecycle.journal import Journal
from jama16_retina_tpu_torch.obs import alerts as obs_alerts
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

STATES = (
    "IDLE", "DRIFT_DETECTED", "RETRAIN", "GATE", "STAGED_ROLLOUT",
    "WATCH", "COMMIT", "ROLLBACK",
)
TERMINAL_STATES = ("COMMIT", "ROLLBACK")
STATE_IDS = {name: i for i, name in enumerate(STATES)}


@dataclasses.dataclass(frozen=True)
class GateVerdict:
    """One named gate's typed verdict over a candidate. ``skipped``
    gates pass vacuously but say so (no artifact / no data to judge
    with), so the journal records why a gate did not bind. The cascade's
    go-live gate returns them too (``serve/cascade.py``)."""

    name: str
    passed: bool
    value: "float | None" = None
    threshold: "float | None" = None
    detail: str = ""
    skipped: bool = False

    def as_dict(self) -> dict:
        return {
            "name": self.name, "passed": bool(self.passed),
            "value": (round(float(self.value), 6)
                      if self.value is not None else None),
            "threshold": (float(self.threshold)
                          if self.threshold is not None else None),
            "detail": self.detail, "skipped": bool(self.skipped),
        }


def _referable(scores: np.ndarray) -> np.ndarray:
    """Ensemble-averaged scores -> referable probability [n] (the one
    scalar every gate compares on), for either head."""
    s = np.asarray(scores, np.float64)
    if s.ndim == 2:
        from jama16_retina_tpu_torch.eval import metrics

        s = np.asarray(metrics.referable_probs_from_multiclass(s),
                       np.float64)
    return s.ravel()


class LifecycleController:
    """One deployment's lifecycle state machine over a crash-safe journal.

    ``engine``: the live ``ServingEngine`` (or ``CascadeEngine``); None
    only where every phase is seam-injected, since the default gates,
    rollout and rollback need one. ``data_dir``: the dataset root (the
    retrain's training data and the val split the gates score).
    ``live_member_dirs``: the deployment's checkpoint set, the identity of
    the live model until the first promote writes the journal's live
    pointer. ``runlog``: a RunLog for the ``lifecycle`` records (the
    serving session's own); None opens ``<workdir>/metrics.jsonl`` at the
    first write. ``device``: where the default retrain's fits run (None:
    the engine's device, else the card).
    """

    def __init__(self, cfg: configs.ExperimentConfig, workdir: str, *,
                 engine=None, data_dir: str = "", live_member_dirs=None,
                 registry: "obs_registry.Registry | None" = None,
                 runlog=None, retrain_fn=None, gate_fns=None,
                 sleep=time.sleep, device=None):
        self.cfg = cfg
        self.lc = cfg.lifecycle
        self.workdir = workdir
        self.dir = os.path.join(workdir, "lifecycle")
        self.cascade = None
        if (engine is not None and hasattr(engine, "student")
                and hasattr(engine, "ensemble")):
            self.cascade = engine
            engine = engine.ensemble
        self.engine = engine
        self.device = (device if device is not None
                       else getattr(engine, "device", None))
        self.data_dir = data_dir
        self._live_fallback = (list(live_member_dirs) if live_member_dirs
                               else None)
        self.registry = (
            registry if registry is not None
            else (engine.registry if engine is not None
                  else obs_registry.default_registry()))
        self._log = runlog
        self._retrain_fn = retrain_fn or _default_retrain
        self._gate_fns = gate_fns  # None: the default engine gates
        self._sleep = sleep
        self.journal = Journal(self.dir, terminal_states=TERMINAL_STATES)
        self._watch_rules = [obs_alerts.parse_rule(r)
                             for r in self.lc.watch_rules]
        for r in self._watch_rules:
            if r.metric.startswith("rate("):
                # A probe is one snapshot: a rate() would resolve to no
                # data and read as healthy.
                raise ValueError(
                    f"lifecycle.watch_rules entry {r.name!r}: rate() "
                    "needs snapshot history, which the WATCH probe "
                    "does not keep — watch a plain counter/gauge "
                    "threshold instead")
            if r.for_seconds:
                raise ValueError(
                    f"lifecycle.watch_rules entry {r.name!r}: the "
                    "'for N' clause needs continuous-hold tracking the "
                    "WATCH probe does not keep — use "
                    "lifecycle.watch_probes/watch_interval_s for "
                    "sustained evidence instead")
        # The candidate generation, kept between GATE and STAGED_ROLLOUT
        # (the gates and the shadow score the same residency); a resumed
        # controller rebuilds it from the journaled dirs.
        self._candidate = None
        self._gate_data = None
        reg = self.registry
        self._g_state = reg.gauge(
            "serve.lifecycle.state",
            help="lifecycle controller state: "
                 + " ".join(f"{i}={n}" for n, i in STATE_IDS.items())
                 + " [fleet:max]")
        self._c_transitions = reg.counter(
            "lifecycle.transitions",
            help="journaled lifecycle state transitions (all states)")
        self._c_by_state = {
            s: reg.counter(f"lifecycle.transition.{s}",
                           help=f"lifecycle arrivals at {s}")
            for s in STATES[1:]}
        self._c_retrains = reg.counter(
            "lifecycle.retrains",
            help="warm-start retrain phases completed (candidate "
                 "checkpoint sets made durable)")
        self._c_gate_rejects = reg.counter(
            "lifecycle.gate_rejects",
            help="candidates rejected at GATE (live model kept serving)")
        self._c_promotes = reg.counter(
            "lifecycle.promotes",
            help="candidates promoted live via staged rollout")
        self._c_rollbacks = reg.counter(
            "lifecycle.rollbacks",
            help="cycles that ended in ROLLBACK (gate reject or "
                 "post-swap regression)")
        self._c_commits = reg.counter(
            "lifecycle.commits",
            help="cycles that ended in COMMIT (candidate retained live)")
        self._c_step_errors = reg.counter(
            "lifecycle.step_errors",
            help="lifecycle steps that raised (journal unadvanced; the "
                 "step retries on the next drive)")
        self._g_state.set(STATE_IDS.get(self.state, 0))
        if engine is not None:
            self.ensure_live()

    # -- identity ------------------------------------------------------------

    @property
    def state(self) -> str:
        return self.journal.state or "IDLE"

    def live_member_dirs(self) -> "list[str] | None":
        """The checkpoint set that is the live model now: the journal's
        live pointer once a promote or rollback wrote one, else the
        deployment's set, else the engine's."""
        live = self.journal.read_live()
        if live is not None:
            return live
        if self._live_fallback is not None:
            return list(self._live_fallback)
        if self.engine is not None and self.engine._gen.member_dirs:
            return list(self.engine._gen.member_dirs)
        return None

    def ensure_live(self) -> bool:
        """Reconcile the engine with the journal's live pointer (the
        resume half of a crash-safe promote: the swap is durable as the
        pointer, and re-applying it is a reload). True when it
        reloaded."""
        live = self.journal.read_live()
        if live is None or self.engine is None:
            return False
        cur = self.engine._gen.member_dirs
        if cur is not None and list(cur) == list(live):
            return False
        _log.info("lifecycle resume: engine serves %s but the live pointer "
                  "names %s — reloading", cur, live)
        self.engine.reload(live)
        return True

    # -- trigger (the AlertManager on_fire seam) -----------------------------

    def on_alert(self, info: dict) -> bool:
        """``AlertManager(on_fire=controller.on_alert)``: a firing rule
        whose reason is in ``lifecycle.trigger_reasons`` opens a cycle.
        False while a cycle is open, for another reason, or with the
        lifecycle disabled."""
        if not self.lc.enabled:
            return False
        if info.get("reason") not in self.lc.trigger_reasons:
            return False
        return self.trigger(
            reason=info.get("reason", "unknown"), rule=info.get("rule"),
            value=info.get("value"), threshold=info.get("threshold"))

    def trigger(self, reason: str = "manual", **detail) -> bool:
        """Open a cycle at DRIFT_DETECTED. The entry pins the current
        live checkpoint set (what ROLLBACK restores and RETRAIN starts
        from) and the cycle's trace context: a ``trace`` wire dict passed
        in, else a new one, which later steps (in any process) run
        under."""
        if self.journal.cycle_open():
            _log.warning("lifecycle trigger (%s) ignored: cycle %d is still "
                         "at %s", reason, self.journal.cycle, self.state)
            return False
        live = self.live_member_dirs()
        trace_wire = detail.pop("trace", None)
        if trace_wire is None:
            trace_wire = obs_trace.new_context().wire()
        self._arrive(
            "DRIFT_DETECTED", cycle=self.journal.cycle + 1,
            reason=reason, live_member_dirs=live, trace=trace_wire,
            **{k: v for k, v in detail.items() if v is not None})
        return True

    # -- driving -------------------------------------------------------------

    def step(self) -> "dict | None":
        """One transition (the operator's ``--step``): the current
        state's work, idempotently, then the arrival it produced. Returns
        the new entry, or None when idle or terminal. A step that raises
        leaves the journal where it was (counted in
        ``lifecycle.step_errors``): the next drive retries that step."""
        state = self.state
        if state == "IDLE" or state in TERMINAL_STATES:
            return None
        ctx = self._cycle_context()
        tracer = obs_trace.default_tracer()
        args = ({"trace_id": ctx.trace_id, "state": state}
                if ctx is not None else {"state": state})
        try:
            with obs_trace.use_context(ctx), \
                    tracer.trace(f"lifecycle.{state.lower()}", args=args):
                if state == "DRIFT_DETECTED":
                    return self._step_retrain()
                if state == "RETRAIN":
                    return self._step_gate()
                if state == "GATE":
                    gate = self.journal.find("GATE")
                    if gate and not gate["passed"]:
                        return self._step_rollback("gate_rejected")
                    return self._step_rollout()
                if state == "STAGED_ROLLOUT":
                    return self._step_watch()
                if state == "WATCH":
                    watch = self.journal.find("WATCH")
                    if watch and not watch["healthy"]:
                        return self._step_rollback("watch_regression")
                    return self._step_commit()
        except Exception:
            self._c_step_errors.inc()
            raise
        raise AssertionError(f"unreachable lifecycle state {state!r}")

    def _cycle_context(self):
        """The open cycle's TraceContext, from its DRIFT_DETECTED entry
        (None for an entry without one)."""
        trigger = self.journal.find("DRIFT_DETECTED")
        if not trigger:
            return None
        return obs_trace.TraceContext.from_wire(trigger.get("trace"))

    def run(self, max_steps: int = 16) -> str:
        """Drive to a terminal state (the ``--watch`` inner loop); returns
        it. ``max_steps`` bounds a runaway (a cycle is 6 transitions)."""
        for _ in range(max_steps):
            if self.step() is None:
                break
        return self.state

    # -- the steps -----------------------------------------------------------

    def _arrive(self, state: str, cycle: "int | None" = None,
                **payload) -> dict:
        entry = self.journal.append(state, cycle=cycle, **payload)
        self._g_state.set(STATE_IDS[state])
        self._c_transitions.inc()
        self._c_by_state[state].inc()
        obs_trace.default_tracer().instant(
            "lifecycle.transition",
            args={"state": state, "cycle": entry["cycle"],
                  "seq": entry["seq"]})
        if self._log is None and self.workdir:
            from jama16_retina_tpu_torch.utils.logging import RunLog

            self._log = RunLog(self.workdir)
        if self._log is not None:
            self._log.write("lifecycle", **{
                k: v for k, v in entry.items()
                if k not in ("live_member_dirs", "member_dirs")})
        _log.info("lifecycle: cycle %d -> %s", entry["cycle"], state)
        return entry

    def _candidate_root(self) -> str:
        return os.path.join(self.dir, f"candidate-{self.journal.cycle:04d}")

    def _step_retrain(self) -> dict:
        faultinject.check("lifecycle.retrain")
        member_dirs = self._retrain_fn(self, self._candidate_root())
        self._c_retrains.inc()
        return self._arrive(
            "RETRAIN", cycle=self.journal.cycle,
            member_dirs=list(member_dirs), n_members=len(member_dirs),
            # The rawshard manifest the cycle trained from, when there is
            # one: the lineage from a served score to its training data.
            data_dir=self.data_dir or None,
            data_manifest=self._data_manifest())

    def _data_manifest(self) -> "dict | None":
        """The train split's rawshard manifest (path and sha256) under
        ``data.rawshard_dir`` or its default place, or None; advisory,
        never a step failure."""
        if not self.data_dir:
            return None
        try:
            from jama16_retina_tpu_torch.data import rawshard

            shard_dir = (self.cfg.data.rawshard_dir
                         or rawshard.default_shard_dir(
                             self.data_dir, self.cfg.model.image_size))
            path = rawshard.manifest_path(shard_dir, "train")
            if not os.path.exists(path):
                return None
            return {"path": path, "sha256": artifact_lib.sha256_file(path)}
        except Exception:  # noqa: BLE001 - lineage is advisory here
            return None

    def _step_gate(self) -> dict:
        member_dirs = self.journal.find("RETRAIN")["member_dirs"]
        try:
            faultinject.check("lifecycle.gate")
            if self._gate_fns is not None:
                fns = self._gate_fns
            else:
                if self.engine is None:
                    raise RuntimeError(
                        "default gates need a ServingEngine; pass "
                        "gate_fns= or an engine")
                fns = [gate_golden_canary, gate_profile_parity,
                       gate_auc_floor]
            # Warmed: the shadow session reuses this handle, and a sampled
            # live request must not pay a candidate's first forwards.
            self._candidate = (
                self.engine.prepare_candidate(member_dirs, warm=True)
                if self.engine is not None else None)
            verdicts = [fn(self, self._candidate) for fn in fns]
        except Exception as e:  # noqa: BLE001 - gates fail closed
            # A candidate that could not be judged does not ship: the
            # failure is a failing verdict, and the cycle rolls back.
            _log.error("lifecycle gate evaluation failed (failing closed): "
                       "%s: %s", type(e).__name__, e)
            verdicts = [GateVerdict(name="gate_error", passed=False,
                                    detail=f"{type(e).__name__}: {e}")]
        passed = all(v.passed for v in verdicts)
        if not passed:
            self._c_gate_rejects.inc()
            self._candidate = None
        return self._arrive(
            "GATE", cycle=self.journal.cycle, passed=passed,
            verdicts=[v.as_dict() for v in verdicts])

    def _step_rollout(self) -> dict:
        engine = self.engine
        if engine is None:
            raise RuntimeError("STAGED_ROLLOUT needs a ServingEngine")
        member_dirs = self.journal.find("RETRAIN")["member_dirs"]
        candidate = self._candidate
        if candidate is None:  # a resumed controller: rebuild from dirs
            candidate = engine.prepare_candidate(member_dirs, warm=True)
        if engine.shadow_report() is not None:
            # A session left by a step interrupted mid-rollout in this
            # process; its evidence died with the interruption.
            engine.end_shadow()
        faultinject.check("lifecycle.swap")
        engine.begin_shadow(candidate=candidate,
                            fraction=self.lc.shadow_fraction)
        deadline = time.monotonic() + self.lc.shadow_wait_s
        while True:
            rep = engine.shadow_report()
            if rep is None:
                # A concurrent reload or rollback cleared the session:
                # the journal holds at GATE and the next drive restarts
                # the rollout against the new live generation.
                raise RuntimeError(
                    "shadow session cleared by a concurrent "
                    "reload/rollback — rollout aborted; re-drive to "
                    "retry against the new live generation")
            if rep["requests"] >= self.lc.shadow_requests:
                break
            if time.monotonic() >= deadline:
                _log.warning("lifecycle shadow window timed out at %s — "
                             "promoting on partial evidence", rep)
                break
            self._sleep(0.02)
        # The canary is re-pinned to the candidate before the swap: the
        # reload's canary gate and the WATCH rules judge the model being
        # shipped. The previous reference is backed up for ROLLBACK.
        repin = self._repin_canary(candidate)
        try:
            report = engine.end_shadow(promote=True)
        except Exception:
            # The old model keeps serving, so its reference is the truth
            # again (else every canary run until the retry false-alerts).
            if repin:
                self._restore_canary()
            raise
        reload_info = report.pop("reload")
        self.journal.write_live(member_dirs)
        self._candidate = None
        self._c_promotes.inc()
        return self._arrive(
            "STAGED_ROLLOUT", cycle=self.journal.cycle,
            generation=reload_info["generation"], shadow=report,
            canary_repinned=repin)

    def _run_live_canary(self) -> None:
        """Refresh the golden-canary gauges against the live generation
        before a watch probe reads them (the gauge otherwise holds the
        last cadence run's verdict, of the model before the swap)."""
        from jama16_retina_tpu_torch.eval import metrics

        engine = self.engine
        q = getattr(engine, "quality", None) if engine is not None else None
        if q is None or q.canary is None:
            return
        q.run_canary(lambda imgs: metrics.ensemble_average(
            list(engine.member_probs(imgs))))

    def _step_watch(self) -> dict:
        fired: list = []
        probes = 0
        for i in range(max(1, self.lc.watch_probes)):
            if i:
                self._sleep(self.lc.watch_interval_s)
            self._run_live_canary()
            snap = self.registry.snapshot()
            probes += 1
            fired = [r.name for r in self._watch_rules
                     if obs_alerts.rule_holds(r, snap)]
            if fired:
                break
        return self._arrive(
            "WATCH", cycle=self.journal.cycle, healthy=not fired,
            probes=probes, fired=fired,
            rules=[r.name for r in self._watch_rules])

    def _step_commit(self) -> dict:
        rollout = self.journal.find("STAGED_ROLLOUT")
        self._c_commits.inc()
        self._gate_data = None  # the cycle is over: release the eval rows
        if self.engine is not None and hasattr(self.engine,
                                              "release_retained"):
            # The rollout is healthy: the outgoing generation's device
            # memory buys nothing now.
            self.engine.release_retained()
        return self._arrive(
            "COMMIT", cycle=self.journal.cycle,
            generation=rollout["generation"] if rollout else None)

    def _step_rollback(self, cause: str) -> dict:
        restored = None
        rollout = self.journal.find("STAGED_ROLLOUT")
        trigger = self.journal.find("DRIFT_DETECTED")
        prev_dirs = (trigger or {}).get("live_member_dirs")
        if rollout is not None:
            # A swap happened this cycle. The durable undo comes first and
            # needs no engine: the live pointer names the pre-cycle set
            # again, and the canary artifact is restored before any reload
            # judges against it.
            if prev_dirs:
                self.journal.write_live(prev_dirs)
            self._restore_canary()
            if self.engine is not None:
                # Instantly off the retained generation when the window
                # holds, else a reload of the pre-cycle set.
                from jama16_retina_tpu_torch.serve.engine import (
                    RollbackUnavailable)

                try:
                    restored = self.engine.rollback()
                except RollbackUnavailable as e:
                    if not prev_dirs:
                        raise RuntimeError(
                            "rollback needs the pre-cycle checkpoint "
                            "set but the trigger entry pinned none") from e
                    _log.warning("instant rollback unavailable (%s); "
                                 "reloading the pre-cycle checkpoint set", e)
                    restored = self.engine.reload(prev_dirs)
                else:
                    if not prev_dirs and self.engine._gen.member_dirs:
                        # The trigger pinned no set: the restored
                        # generation's own dirs are what the pointer must
                        # name, or the next process serves the candidate.
                        self.journal.write_live(
                            list(self.engine._gen.member_dirs))
        # No rollout: nothing was promoted and the live model never
        # stopped serving; the rollback is the cycle's bookkeeping.
        self._candidate = None
        self._gate_data = None
        self._c_rollbacks.inc()
        return self._arrive(
            "ROLLBACK", cycle=self.journal.cycle, cause=cause,
            swapped=rollout is not None,
            restored_generation=(restored.get("generation")
                                 if restored else None))

    # -- canary custody across promote and rollback --------------------------

    def _canary_backup_path(self) -> str:
        return os.path.join(self.dir,
                            f"canary-pre-{self.journal.cycle:04d}.npz")

    def _repin_canary(self, candidate) -> bool:
        """Score the golden set through the candidate and pin those
        scores (in memory, and in the artifact when one is configured),
        backing up the previous reference for ROLLBACK. Returns whether
        it re-pinned. Idempotent: a re-run after a crash scores the same
        state through the same program."""
        from jama16_retina_tpu_torch.obs import quality as quality_lib

        engine = self.engine
        q = engine.quality if engine is not None else None
        canary = q.canary if q is not None else None
        if canary is None or candidate is None:
            return False
        scores = self._canary_scores(candidate)
        backup = self._canary_backup_path()
        if canary.reference is not None and not os.path.exists(backup):
            quality_lib.save_canary(backup, canary.images,
                                    scores=canary.reference)
        canary.reference = scores
        path = self.cfg.obs.quality.canary_path
        if path:
            quality_lib.save_canary(path, canary.images, scores=scores)
        return True

    def _restore_canary(self) -> bool:
        """Undo ``_repin_canary`` from its backup (the ROLLBACK path),
        the durable artifact included, with or without an engine."""
        from jama16_retina_tpu_torch.obs import quality as quality_lib

        backup = self._canary_backup_path()
        if not os.path.exists(backup):
            return False
        images, ref = quality_lib.load_canary_file(backup)
        path = self.cfg.obs.quality.canary_path
        if path:
            quality_lib.save_canary(path, images, scores=ref)
        engine = self.engine
        q = engine.quality if engine is not None else None
        canary = q.canary if q is not None else None
        if canary is not None:
            canary.reference = ref
            canary._g_ok.set(1.0)  # the restored model matches again
        return True

    # -- gate data -----------------------------------------------------------

    def _gate_eval_data(self):
        """(images, grades) of the val split for the parity and AUC gates
        (at most ``lifecycle.gate_eval_rows``), decoded by the data
        plane's ``ParallelDecoder`` under a detached registry and kept for
        this cycle only. None without a data_dir or val split: those gates
        then skip, saying so."""
        cycle = self.journal.cycle
        if self._gate_data is not None and self._gate_data[0] == cycle:
            return self._gate_data[1]
        self._gate_data = None
        if not self.data_dir:
            return None
        from jama16_retina_tpu_torch.data import tfrecord
        from jama16_retina_tpu_torch.data.grain_pipeline import (
            ParallelDecoder, TFRecordIndex, resolve_decode_workers)

        try:
            paths = tfrecord.list_split(self.data_dir, "val")
        except (FileNotFoundError, ValueError):
            return None
        if not paths:
            return None
        index = TFRecordIndex(paths)
        n = len(index)
        if self.lc.gate_eval_rows > 0:
            n = min(n, self.lc.gate_eval_rows)
        # Gate-time decode counters stay out of the serving session's
        # data-plane telemetry (and its quarantine alert).
        dec = ParallelDecoder(index, self.cfg.model.image_size,
                              workers=resolve_decode_workers(0),
                              registry=obs_registry.Registry())
        try:
            batch = dec.decode_batch(range(n))
        finally:
            dec.close()
        self._gate_data = (cycle, (batch["image"],
                                   np.asarray(batch["grade"])))
        return self._gate_data[1]

    def _score_gen(self, gen, images: np.ndarray) -> np.ndarray:
        """Referable probabilities [n] through one generation: the scalar
        the parity and AUC gates compare on (either head)."""
        from jama16_retina_tpu_torch.eval import metrics

        return _referable(metrics.ensemble_average(
            list(self.engine.member_probs(images, _gen=gen))))

    def _canary_scores(self, gen) -> np.ndarray:
        """Golden-set scores through one generation in the engine's
        canary convention: the raw ensemble average raveled ([n] binary,
        [n*C] multi), not collapsed to the referable score, as the pinned
        reference, the reload's gate and every cadence run have it."""
        from jama16_retina_tpu_torch.eval import metrics

        return np.asarray(metrics.ensemble_average(list(
            self.engine.member_probs(self.engine.quality.canary.images,
                                     _gen=gen))), np.float64).ravel()


# ---------------------------------------------------------------------------
# The default seams: the warm-start retrain and the three named gates
# ---------------------------------------------------------------------------


def _default_retrain(ctl: LifecycleController, cand_root: str) -> list:
    """Fine-tune every live member on the data_dir's train split from its
    own weights (``trainer.fit`` with ``train.init_from``, on
    ``ctl.device``), member m with seed ``train.seed + 1000 * (cycle + 1)
    + m``. Idempotent per member: a candidate whose ``RETRAIN_DONE.json``
    marker (written after its fit returned) exists is reused, and
    ``train.resume`` continues a member interrupted mid-fit."""
    from jama16_retina_tpu_torch import trainer

    live = ctl.live_member_dirs()
    if not live:
        raise RuntimeError(
            "RETRAIN needs the live checkpoint set (live_member_dirs= "
            "or a journal live pointer)")
    if not ctl.data_dir:
        raise RuntimeError("RETRAIN needs data_dir= (fresh training data)")
    cfg = ctl.cfg
    steps = ctl.lc.retrain_steps or cfg.train.steps
    cycle = ctl.journal.cycle
    out = []
    for m, src in enumerate(live):
        dst = os.path.join(cand_root, f"member_{m:02d}")
        marker = os.path.join(dst, "RETRAIN_DONE.json")
        if os.path.exists(marker):
            out.append(dst)
            continue
        mcfg = cfg.replace(train=dataclasses.replace(
            cfg.train, init_from=src, steps=steps, resume=True))
        result = trainer.fit(
            mcfg, ctl.data_dir, dst,
            seed=cfg.train.seed + 1000 * (cycle + 1) + m,
            device=ctl.device)
        artifact_lib.write_sealed_json(marker, {
            "cycle": cycle, "init_from": src, "steps": steps,
            "best_auc": result.get("best_auc"),
            "t": round(time.time(), 3),
        }, schema="lifecycle.retrain_marker", version=1)
        out.append(dst)
    return out


def gate_golden_canary(ctl: LifecycleController, candidate) -> GateVerdict:
    """|candidate - pinned reference| on the golden set, at most
    ``lifecycle.gate_canary_max_dev``: loose by design (a fine-tune moves
    scores; a degenerate candidate moves them wildly)."""
    q = ctl.engine.quality if ctl.engine is not None else None
    canary = q.canary if q is not None else None
    if canary is None or canary.reference is None:
        return GateVerdict(name="golden_canary", passed=True, skipped=True,
                           detail="no canary artifact configured/pinned")
    scores = ctl._canary_scores(candidate)
    ref = np.asarray(canary.reference, np.float64).ravel()
    if scores.shape != ref.shape:
        return GateVerdict(
            name="golden_canary", passed=False,
            detail=f"score shape {scores.shape} vs pinned {ref.shape}")
    dev = float(np.max(np.abs(scores - ref)))
    thr = float(ctl.lc.gate_canary_max_dev)
    return GateVerdict(name="golden_canary", passed=dev <= thr, value=dev,
                       threshold=thr)


def gate_profile_parity(ctl: LifecycleController, candidate) -> GateVerdict:
    """Debiased PSI of the candidate's val-split score histogram against
    the loaded reference profile: the drift monitor's statistic, before
    the swap."""
    from jama16_retina_tpu_torch.obs import quality as quality_lib

    q = ctl.engine.quality if ctl.engine is not None else None
    profile = q.profile if q is not None else None
    if profile is None:
        return GateVerdict(name="profile_parity", passed=True, skipped=True,
                           detail="no reference profile loaded")
    data = ctl._gate_eval_data()
    if data is None:
        return GateVerdict(name="profile_parity", passed=True, skipped=True,
                           detail="no val split available to score")
    images, _ = data
    scores = ctl._score_gen(candidate, images)
    counts = quality_lib.bin_counts(scores, int(profile["bins"]))
    value = quality_lib.psi_debiased(
        np.asarray(profile["score_hist"], np.float64), counts)
    thr = float(ctl.lc.gate_parity_psi_max)
    if thr < 0:
        thr = float(ctl.cfg.obs.quality.psi_alert)
    return GateVerdict(name="profile_parity", passed=value <= thr,
                       value=value, threshold=thr)


def gate_auc_floor(ctl: LifecycleController, candidate) -> GateVerdict:
    """Candidate val AUC >= live val AUC - ``lifecycle.gate_auc_floor_delta``,
    both scored on the same rows through the same engine path."""
    from jama16_retina_tpu_torch.eval import metrics

    data = ctl._gate_eval_data()
    if data is None:
        return GateVerdict(name="auc_floor", passed=True, skipped=True,
                           detail="no val split available to score")
    images, grades = data
    labels = (np.asarray(grades) >= 2).astype(np.float64)
    if not (0.0 < labels.mean() < 1.0):
        return GateVerdict(name="auc_floor", passed=True, skipped=True,
                           detail="val split is single-class; AUC undefined")
    auc_cand = metrics.roc_auc(labels, ctl._score_gen(candidate, images))
    auc_live = metrics.roc_auc(labels,
                               ctl._score_gen(ctl.engine._gen, images))
    delta = float(ctl.lc.gate_auc_floor_delta)
    return GateVerdict(
        name="auc_floor", passed=auc_cand >= auc_live - delta,
        value=float(auc_cand), threshold=float(auc_live - delta),
        detail=f"live_auc={auc_live:.6f}")
