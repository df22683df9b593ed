"""Black-box flight recorder (counterpart of
``jama16_retina_tpu/obs/flightrec.py``): anomaly-triggered state dumps.

The recorder watches for four triggers and on each dumps the process's
last moments to ``<workdir>/blackbox/<seq>-<reason>/``:

  * an unhandled exception leaving the train loop (``record_exception``);
  * SIGTERM or SIGINT: ``install_signal_handlers`` turns the signal into
    an in-band ``SystemExit`` in the main thread, so the dump runs in
    the loop's own ``except``, never in a signal handler that could meet
    a registry lock the interrupted frame holds;
  * a non-finite loss (``note_loss``, on a loss the caller has already
    read to the host: the recorder adds no device synchronization);
  * a slow step: a loop iteration above ``slow_step_factor`` times the
    rolling median of the last 64 (``note_step_time``).

A dump holds the newest ``blackbox_events`` trace events
(``trace.jsonl``, one event a line), the registry snapshot
(``registry.json``), the run config (``config.json``), ``meta.json``
(reason, step, time, events dropped) and, with ``diagnosis``, the
critical-path verdict (``diagnosis.json``), whose code and confidence
are also published as the ``obs.diagnosis.{verdict,confidence}`` gauges.
One dump per reason per run; after each, the oldest dump directories
beyond ``blackbox_keep`` are pruned. The NaN and slow-step triggers
request one profiler capture a run through ``profile_hook`` (the
trainer wires ``_ProfilerWindow.arm``).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import statistics
import threading
import time
from collections import deque

import numpy as np

from jama16_retina_tpu_torch.integrity import artifact as artifact_lib
from jama16_retina_tpu_torch.obs import registry as registry_lib
from jama16_retina_tpu_torch.obs import trace as trace_lib


class FlightRecorder:
    """One per run; ``enabled=False`` makes every hook one branch.
    ``config`` is a JSON-serializable mapping (``dataclasses.asdict(cfg)``);
    ``profile_hook`` is called at most once a run."""

    STEP_WINDOW = 64          # rolling-median sample size
    MIN_STEP_SAMPLES = 16     # no slow-step verdict before this many

    def __init__(self, workdir: str, config: "dict | None" = None,
                 registry: "registry_lib.Registry | None" = None,
                 tracer: "trace_lib.Tracer | None" = None,
                 blackbox_events: int = 1024, slow_step_factor: float = 4.0,
                 profile_hook=None, enabled: bool = True,
                 blackbox_keep: int = 20, diagnosis: bool = True,
                 diagnosis_top_k: int = 3):
        self.enabled = bool(enabled)
        self.workdir = workdir
        self.blackbox_dir = os.path.join(workdir, "blackbox")
        self._config = config or {}
        self._registry = (registry if registry is not None
                          else registry_lib.default_registry())
        self._tracer = (tracer if tracer is not None
                        else trace_lib.default_tracer())
        self.blackbox_events = int(blackbox_events)
        self.slow_step_factor = float(slow_step_factor)
        # <= 0 keeps every dump.
        self.blackbox_keep = int(blackbox_keep)
        self.diagnosis = bool(diagnosis)
        self.diagnosis_top_k = int(diagnosis_top_k)
        self._profile_hook = profile_hook
        self._profile_fired = False
        self._step_times: deque = deque(maxlen=self.STEP_WINDOW)
        self._step_median: "float | None" = None
        self._steps_since_median = 0
        self._last_step: "int | None" = None
        self._dumped_reasons: set = set()
        self._dump_seq = 0
        self._dump_lock = threading.Lock()
        self._prev_handlers: dict = {}
        self._pending_signal: "int | None" = None
        self.dumps: "list[str]" = []

    def progress(self, step: int) -> None:
        """The latest completed step (dump metadata)."""
        self._last_step = int(step)

    # -- triggers ----------------------------------------------------------

    def note_loss(self, loss, step: "int | None" = None) -> bool:
        """Non-finite sentinel on a loss already on the host: a float, an
        array (per-member losses) or a CPU tensor. Returns True when it
        dumped."""
        if not self.enabled:
            return False
        if hasattr(loss, "detach"):
            loss = loss.detach().cpu().numpy()
        arr = np.asarray(loss, dtype=np.float64)
        bad = (not math.isfinite(float(arr)) if arr.ndim == 0
               else not np.isfinite(arr).all())
        if not bad:
            return False
        if step is not None:
            self._last_step = int(step)
        dumped = self.dump(
            "nonfinite_loss",
            loss=(repr(float(arr)) if arr.ndim == 0
                  else [repr(float(x)) for x in arr.ravel()[:16]]),
        ) is not None
        self._request_profile()
        return dumped

    def note_step_time(self, dt: float, step: "int | None" = None) -> bool:
        """A loop iteration of ``dt`` seconds (eval and save pauses left
        out by the caller) against ``slow_step_factor`` times the rolling
        median, recomputed every 16 steps. Returns True when it dumped."""
        if not self.enabled:
            return False
        st = self._step_times
        triggered = False
        med = self._step_median
        if med is not None and med > 0 and dt > self.slow_step_factor * med:
            if step is not None:
                self._last_step = int(step)
            triggered = self.dump(
                "slow_step", step_sec=round(dt, 6),
                rolling_median_sec=round(med, 6),
                factor=self.slow_step_factor,
            ) is not None
            self._request_profile()
        st.append(dt)
        self._steps_since_median += 1
        if (self._steps_since_median >= 16
                and len(st) >= self.MIN_STEP_SAMPLES):
            # A slow step joins the window it tripped; the median absorbs
            # it, so stragglers back to back still meet a healthy baseline.
            self._step_median = statistics.median(st)
            self._steps_since_median = 0
        return triggered

    def record_exception(self, exc: BaseException) -> "str | None":
        """The exception and signal trigger: call from the loop's
        ``except BaseException`` before re-raising."""
        if not self.enabled:
            return None
        sig = self._pending_signal
        if sig is not None:
            self._pending_signal = None
            reason = {signal.SIGTERM: "sigterm",
                      signal.SIGINT: "sigint"}.get(sig, f"signal_{sig}")
            return self.dump(reason, signal=int(sig))
        if isinstance(exc, KeyboardInterrupt):
            return self.dump("sigint", error=type(exc).__name__)
        return self.dump("exception", error=f"{type(exc).__name__}: {exc}")

    # -- signals -----------------------------------------------------------

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT -> ``SystemExit(128 + signum)`` raised in the
        main thread, so the dump and the preemption save run in the
        loop's ``except``/``finally``. A no-op off the main thread."""
        if not self.enabled:
            return
        if threading.current_thread() is not threading.main_thread():
            return

        def _handler(signum, frame):
            self._pending_signal = signum
            raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, _handler)

    def uninstall_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        self._prev_handlers = {}

    # -- the dump ----------------------------------------------------------

    def _request_profile(self) -> None:
        """At most one trigger-driven capture a run: a run whose every
        step is slow must not make the profiler the workload."""
        if self._profile_fired or self._profile_hook is None:
            return
        self._profile_fired = True
        try:
            self._profile_hook()
        except Exception:  # noqa: BLE001 - the capture is best effort
            pass

    def dump(self, reason: str, **meta) -> "str | None":
        """Write one dump directory; its path, or None when disabled or
        this reason already dumped this run."""
        if not self.enabled:
            return None
        with self._dump_lock:
            if reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
            self._dump_seq += 1
            seq = self._dump_seq
        d = os.path.join(self.blackbox_dir, f"{seq:02d}-{reason}")
        os.makedirs(d, exist_ok=True)
        events = self._tracer.events(last_n=self.blackbox_events)
        with open(os.path.join(d, "trace.jsonl"), "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        if self.diagnosis:
            self._diagnose_into(d, events)
        artifact_lib.write_json(os.path.join(d, "registry.json"),
                                self._registry.snapshot())
        artifact_lib.write_json(os.path.join(d, "config.json"),
                                self._config, default=str)
        artifact_lib.write_json(os.path.join(d, "meta.json"), {
            "reason": reason,
            "t": round(time.time(), 3),
            "step": self._last_step,
            "n_trace_events": len(events),
            "trace_events_dropped": self._tracer.dropped(),
            **meta,
        })
        self.dumps.append(d)
        self._prune_blackbox()
        return d

    def _diagnose_into(self, d: str, events: list) -> None:
        """The dump-time diagnosis; never raises, so the dump lands even
        when the analyzer chokes. The gauges are set before
        ``registry.json`` is written, so the dump carries them. No device
        summary refines the verdict: the port does not publish the device
        gauges yet (ROADMAP item 11, part 4)."""
        try:
            from jama16_retina_tpu_torch.obs import criticalpath

            verdict = criticalpath.diagnose(
                events, top_k=self.diagnosis_top_k, device=None)
            self._registry.gauge(
                "obs.diagnosis.verdict",
                help="latest dump-time critical-path verdict as its "
                     "stable numeric code (criticalpath.VERDICT_CODES: "
                     "0 balanced, 1 device, 2 decode, 3 credit, 4 h2d, "
                     "5 queue, 6 device-compute, 7 device-membw, "
                     "8 device-underutilized)",
            ).set(verdict.code)
            self._registry.gauge(
                "obs.diagnosis.confidence",
                help="evidence fraction of the dominant category behind "
                     "the latest obs.diagnosis.verdict (0..1)",
            ).set(verdict.confidence)
            artifact_lib.write_json(os.path.join(d, "diagnosis.json"),
                                    verdict.as_dict())
        except Exception:  # noqa: BLE001 - the diagnosis is freight
            pass

    def _prune_blackbox(self) -> None:
        """Keep the ``blackbox_keep`` newest dump directories (by mtime:
        sequence numbers restart each run) and delete the rest, counted
        as ``obs.blackbox_pruned``."""
        if self.blackbox_keep <= 0:
            return
        try:
            dirs = [os.path.join(self.blackbox_dir, n)
                    for n in os.listdir(self.blackbox_dir)]
            dirs = sorted((p for p in dirs if os.path.isdir(p)),
                          key=os.path.getmtime)
        except OSError:  # pragma: no cover - a racing cleanup
            return
        excess = dirs[:max(0, len(dirs) - self.blackbox_keep)]
        if not excess:
            return
        c = self._registry.counter(
            "obs.blackbox_pruned",
            help="blackbox dump directories deleted oldest-first to "
                 "enforce the cross-run obs.blackbox_keep cap",
        )
        for p in excess:
            try:
                shutil.rmtree(p)
                c.inc()
            except OSError:  # pragma: no cover - a racing cleanup
                pass
