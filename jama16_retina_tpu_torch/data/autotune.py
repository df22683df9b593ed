"""Closed-loop ingest autotuner: the ``data.autotune=true`` option
(counterpart of ``jama16_retina_tpu/data/autotune.py``).

A lightweight controller observes tumbling windows of the signals the
train loops and loaders already export (the trainer's
``input_wait_sec``, ``data.decode.busy_s``, the tiered loader's
resident/streamed row counters) and turns the knobs that only change
WHEN data arrives (``data.decode_workers``, ``data.stage_depth``, the
prefetch depth), never WHAT arrives:

  * TIMING-ONLY KNOBS. ``ParallelDecoder`` output does not depend on the
    worker count, and stage and prefetch depth are pure run-ahead, so a
    run with ``data.autotune=true`` produces the same batches, and the
    same eval metrics, as the same seed with hand-set knobs. Residency
    (``tiered_resident_bytes``) is not a live knob: the tiered plan
    derives each batch's composition from it.
  * DETERMINISTIC DECISIONS. ``decide()`` is a pure function of (window
    stats, current knobs, limits, controller state), the reference's
    rule for rule, so its decision sequences can be pinned.
  * BUDGET-SAFE. The run-ahead knobs pin streamed batches in card
    memory. Their total is clamped so the staged bytes never exceed
    ``Limits.hbm_headroom_bytes`` (10 % of the card's budget, the eval
    cache's discipline). The clamp is the first rule in ``decide``.
  * NON-OSCILLATING. Increases need the input-wait fraction above
    ``HIGH_WATER``; decays need ``QUIET_WINDOWS`` consecutive windows
    below ``LOW_WATER``; a decay that starves the very next window is
    reverted and its value becomes that knob's floor.
  * DISABLED == NOTHING. ``data.autotune=false`` builds no Knobs and no
    tuner; the loaders' poll sites cost one ``is not None`` branch.

Every applied adjustment is counted (``data.autotune.adjustments`` and
``data.autotune.adjust.<knob>``), mirrored into a ``data.autotune.<knob>``
gauge and emitted as a ``data.autotune.<knob>`` instant trace event
carrying {old, new, reason}.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading

from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

# --- Policy constants (the reference's values; see the module docstring
# for their roles) -------------------------------------------------------
HIGH_WATER = 0.10     # input-wait fraction: above = the card is starved
LOW_WATER = 0.02      # below = the pipeline is comfortably ahead
BUSY_HIGH = 0.75      # decoder-pool utilization: above = decode-bound
QUIET_WINDOWS = 3     # consecutive quiet windows before one decay step
MIN_WINDOW_S = 0.05   # shorter windows carry no usable signal
MAX_STAGE_DEPTH = 16  # hard ceilings for the run-ahead knobs — past
MAX_PREFETCH = 8      # these, more queue is latency, not throughput
MAX_WORKERS_CAP = 16  # decode threads stop scaling past the shared
                      # TFRecordIndex descriptors (grain_pipeline)


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """The signals of one tumbling window, normalized.

    ``input_wait_frac``: fraction of the window the trainer spent
    blocked in ``next(batches)`` (StallClock ``input_wait_sec`` /
    ``window_sec``). ``decoder_busy_frac``: ``data.decode.busy_s``
    delta / (window * workers). ``spill_frac``: streamed-row fraction of
    the window's rows (tiered counter deltas; 1.0 when the loader keeps
    nothing resident, so the whole batch is staged).
    """

    window_sec: float
    input_wait_frac: float
    decoder_busy_frac: float
    spill_frac: float = 1.0


@dataclasses.dataclass(frozen=True)
class Limits:
    """Knob bounds + the card-memory staging headroom the clamp enforces."""

    min_decode_workers: int = 1
    max_decode_workers: int = 8
    min_stage_depth: int = 1
    max_stage_depth: int = MAX_STAGE_DEPTH
    min_prefetch_depth: int = 1
    max_prefetch_depth: int = MAX_PREFETCH
    # Total card bytes the staged run-ahead may pin (streamed rows of
    # stage_depth + prefetch_depth batches). <= 0 disables the clamp.
    hbm_headroom_bytes: int = 0
    # Card bytes one full batch costs when fully streamed.
    batch_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class ControlState:
    """Controller memory threaded through ``decide``."""

    quiet_windows: int = 0
    # Ratchet floors learned from reverted decays.
    stage_floor: int = 0
    prefetch_floor: int = 0
    # The single decay issued last window, as (knob, old_value).
    last_decay: tuple = ()


@dataclasses.dataclass(frozen=True)
class Adjustment:
    knob: str   # "decode_workers" | "stage_depth" | "prefetch_depth"
    old: int
    new: int
    reason: str


class Knobs:
    """Thread-safe live knob values: the loaders poll them between
    batches, the tuner writes them from the trainer's thread at window
    boundaries."""

    __slots__ = ("_lock", "_v")

    FIELDS = ("decode_workers", "stage_depth", "prefetch_depth")

    def __init__(self, decode_workers: int, stage_depth: int,
                 prefetch_depth: int):
        self._lock = threading.Lock()
        self._v = {
            "decode_workers": int(decode_workers),
            "stage_depth": int(stage_depth),
            "prefetch_depth": int(prefetch_depth),
        }

    @property
    def decode_workers(self) -> int:
        with self._lock:
            return self._v["decode_workers"]

    @property
    def stage_depth(self) -> int:
        with self._lock:
            return self._v["stage_depth"]

    @property
    def prefetch_depth(self) -> int:
        with self._lock:
            return self._v["prefetch_depth"]

    def get(self, knob: str) -> int:
        with self._lock:
            return self._v[knob]

    def set(self, knob: str, value: int) -> None:
        if knob not in self._v:
            raise KeyError(knob)
        with self._lock:
            self._v[knob] = int(value)

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._v)


def staged_cap(limits: Limits, spill_frac: float) -> "int | None":
    """Max total run-ahead (stage_depth + prefetch_depth) the headroom
    admits, budgeted against the loaders' fill peak: the tiered fill
    holds up to stage_depth+1 batches while filling and the prefetch
    queue prefetch_depth+1 at its append point, so depths summing to C
    pin C+2 batches at peak. Only the streamed fraction of a batch is
    staged, so the cap scales inversely with spill_frac; a fully
    resident stream (spill_frac 0) stages nothing and has no cap. None =
    no cap. Never below 2."""
    if limits.hbm_headroom_bytes <= 0 or limits.batch_bytes <= 0:
        return None
    per_batch = limits.batch_bytes * min(max(spill_frac, 0.0), 1.0)
    if per_batch <= 0:
        return None
    return max(2, int(limits.hbm_headroom_bytes // per_batch) - 2)


def decide(
    stats: WindowStats, knobs: dict, limits: Limits, state: ControlState
) -> tuple[tuple[Adjustment, ...], ControlState]:
    """One window's decision: (adjustments, next state). PURE.

    Rule order (first match wins):
      1. Budget clamp (hard constraint; also consulted before any
         increase).
      2. Starved + a decay issued last window: revert it and ratchet.
      3. Starved: raise the bottleneck knob by one — decode workers
         when the pool is saturated, else staging depth, else prefetch
         depth, else workers as the last resort.
      4. Quiet for QUIET_WINDOWS: decay ONE run-ahead knob by one
         (stage first), respecting ratchet floors. Worker threads are
         never decayed.
      5. Dead band: hold still.
    """
    if stats.window_sec < MIN_WINDOW_S:
        return (), state
    w = int(knobs["decode_workers"])
    s = int(knobs["stage_depth"])
    p = int(knobs["prefetch_depth"])
    cap = staged_cap(limits, stats.spill_frac)
    adjs: list[Adjustment] = []

    # 1) Budget clamp.
    if cap is not None and s + p > cap:
        s0, p0 = s, p
        while s + p > cap and s > limits.min_stage_depth:
            s -= 1
        while s + p > cap and p > limits.min_prefetch_depth:
            p -= 1
        if s != s0:
            adjs.append(Adjustment("stage_depth", s0, s, "hbm_budget"))
        if p != p0:
            adjs.append(Adjustment("prefetch_depth", p0, p, "hbm_budget"))
        return tuple(adjs), dataclasses.replace(
            state, quiet_windows=0, last_decay=()
        )

    starved = stats.input_wait_frac > HIGH_WATER
    quiet = stats.input_wait_frac < LOW_WATER

    if starved:
        if state.last_decay:
            # 2) The decay last window caused this starvation: undo it
            # and never decay that knob below the reverted value again.
            knob, old = state.last_decay
            adjs.append(Adjustment(knob, knobs[knob], old, "decay_reverted"))
            floors = {}
            if knob == "stage_depth":
                floors["stage_floor"] = old
            elif knob == "prefetch_depth":
                floors["prefetch_floor"] = old
            return tuple(adjs), dataclasses.replace(
                state, quiet_windows=0, last_decay=(), **floors
            )
        # 3) Hill-climb the bottleneck knob.
        room = cap is None or s + p + 1 <= cap
        if (stats.decoder_busy_frac >= BUSY_HIGH
                and w < limits.max_decode_workers):
            adjs.append(
                Adjustment("decode_workers", w, w + 1, "decoder_saturated")
            )
        elif s < limits.max_stage_depth and room:
            adjs.append(Adjustment("stage_depth", s, s + 1, "staging_shallow"))
        elif p < limits.max_prefetch_depth and room:
            adjs.append(
                Adjustment("prefetch_depth", p, p + 1, "prefetch_shallow")
            )
        elif w < limits.max_decode_workers:
            adjs.append(
                Adjustment("decode_workers", w, w + 1, "starved_fallback")
            )
        return tuple(adjs), dataclasses.replace(
            state, quiet_windows=0, last_decay=()
        )

    if quiet:
        q = state.quiet_windows + 1
        if q < QUIET_WINDOWS:
            return (), dataclasses.replace(
                state, quiet_windows=q, last_decay=()
            )
        # 4) One decay step, floors respected.
        if s > max(limits.min_stage_depth, state.stage_floor):
            adjs.append(Adjustment("stage_depth", s, s - 1, "quiet_decay"))
            return tuple(adjs), dataclasses.replace(
                state, quiet_windows=0, last_decay=("stage_depth", s)
            )
        if p > max(limits.min_prefetch_depth, state.prefetch_floor):
            adjs.append(Adjustment("prefetch_depth", p, p - 1, "quiet_decay"))
            return tuple(adjs), dataclasses.replace(
                state, quiet_windows=0, last_decay=("prefetch_depth", p)
            )
        return (), dataclasses.replace(state, quiet_windows=q, last_decay=())

    # 5) Dead band.
    return (), dataclasses.replace(state, quiet_windows=0, last_decay=())


class IngestAutotuner:
    """Reads the registry over tumbling windows, applies ``decide``'s
    adjustments to the shared ``Knobs``, and records every adjustment as
    counter + gauge + trace event. The window cadence is the caller's
    (the trainer observes at its log boundary)."""

    def __init__(self, knobs: Knobs, limits: Limits,
                 registry: "obs_registry.Registry | None" = None,
                 tracer: "obs_trace.Tracer | None" = None):
        self.knobs = knobs
        self.limits = limits
        self.state = ControlState()
        self._reg = (
            registry if registry is not None
            else obs_registry.default_registry()
        )
        self._tracer = (
            tracer if tracer is not None else obs_trace.default_tracer()
        )
        # Read-side handles: the owning loaders register these with
        # their help text (grain_pipeline / tiered_pipeline).
        self._c_busy = self._reg.counter("data.decode.busy_s")
        self._c_hit = self._reg.counter("data.tiered.resident_rows")
        self._c_spill = self._reg.counter("data.tiered.streamed_rows")
        self._c_adjust = self._reg.counter(
            "data.autotune.adjustments",
            help="ingest-autotuner knob adjustments applied, all knobs "
                 "(data/autotune.py); per-knob counts under "
                 "data.autotune.adjust.<knob>, current values under the "
                 "data.autotune.<knob> gauges",
        )
        # Window deltas start from the counters' current values.
        self._prev = {
            "busy": self._c_busy.value,
            "hit": self._c_hit.value,
            "spill": self._c_spill.value,
        }
        for k in Knobs.FIELDS:
            self._reg.gauge(
                f"data.autotune.{k}",
                help="current value of this live ingest knob "
                     "(decode_workers/stage_depth/prefetch_depth)",
            ).set(knobs.get(k))

    def window_stats(self, window_sec: float,
                     input_wait_sec: float) -> WindowStats:
        """Normalize this window's registry deltas into WindowStats."""
        busy, hit, spill = (
            self._c_busy.value, self._c_hit.value, self._c_spill.value
        )
        d_busy = max(0.0, busy - self._prev["busy"])
        d_hit = max(0.0, hit - self._prev["hit"])
        d_spill = max(0.0, spill - self._prev["spill"])
        self._prev = {"busy": busy, "hit": hit, "spill": spill}
        wall = max(window_sec, 1e-9)
        workers = max(1, self.knobs.decode_workers)
        rows = d_hit + d_spill
        return WindowStats(
            window_sec=window_sec,
            input_wait_frac=min(1.0, max(0.0, input_wait_sec / wall)),
            decoder_busy_frac=min(1.0, d_busy / (wall * workers)),
            # No tier counters moving: treat the batch as fully staged —
            # the conservative budget view.
            spill_frac=(d_spill / rows) if rows else 1.0,
        )

    def observe(self, window_sec: float,
                input_wait_sec: float) -> tuple[Adjustment, ...]:
        """One tumbling window: read signals, decide, apply, record."""
        stats = self.window_stats(window_sec, input_wait_sec)
        adjs, self.state = decide(
            stats, self.knobs.as_dict(), self.limits, self.state
        )
        for a in adjs:
            self.knobs.set(a.knob, a.new)
            self._c_adjust.inc()
            self._reg.counter(
                f"data.autotune.adjust.{a.knob}",
                help="autotuner adjustments applied to this one knob",
            ).inc()
            self._reg.gauge(f"data.autotune.{a.knob}").set(a.new)
            self._tracer.instant(
                f"data.autotune.{a.knob}",
                args={"old": a.old, "new": a.new, "reason": a.reason},
            )
            _log.info(
                "autotune: %s %d -> %d (%s; input_wait %.0f%%, decoder "
                "busy %.0f%%)", a.knob, a.old, a.new, a.reason,
                100 * stats.input_wait_frac, 100 * stats.decoder_busy_frac,
            )
        return adjs


def for_config(cfg, mesh=None, registry=None, tracer=None,
               max_fraction: float = 0.6,
               device=None) -> tuple[Knobs, IngestAutotuner]:
    """(Knobs, tuner) for one run. The knobs start at the config's own
    resolved values, so an autotuned run starts where a hand-set run
    sits. The staging headroom is 10 % of the card's budget
    (``hbm_pipeline.hbm_budget_bytes``, ``data.hbm_budget_bytes``
    applied), the eval cache's discipline. A mesh is not ported
    (ROADMAP.md Queue A item 8, part 2)."""
    from jama16_retina_tpu_torch.data.grain_pipeline import (
        resolve_decode_workers,
    )
    from jama16_retina_tpu_torch.data.hbm_pipeline import (
        hbm_budget_bytes,
        row_bytes,
    )
    from jama16_retina_tpu_torch.data.tiered_pipeline import (
        resolve_stage_depth,
    )

    if mesh is not None:
        raise NotImplementedError(
            "autotune.for_config: a mesh is not ported yet; see ROADMAP.md "
            "Queue A item 8, part 2")
    workers0 = resolve_decode_workers(cfg.data.decode_workers)
    knobs = Knobs(
        decode_workers=workers0,
        stage_depth=resolve_stage_depth(cfg.data),
        prefetch_depth=max(1, cfg.data.prefetch_batches),
    )
    budget = hbm_budget_bytes(
        max_fraction=max_fraction,
        budget_base_bytes=cfg.data.hbm_budget_bytes,
        device=device,
    )
    limits = Limits(
        min_decode_workers=1,
        # Never below the configured start; otherwise one thread per
        # core up to the shared-descriptor scaling cliff.
        max_decode_workers=max(
            workers0,
            min(MAX_WORKERS_CAP, max(1, (os.cpu_count() or 2) - 1)),
        ),
        hbm_headroom_bytes=int(0.1 * budget),
        batch_bytes=cfg.data.batch_size * row_bytes(cfg.model.image_size),
    )
    tuner = IngestAutotuner(knobs, limits, registry=registry, tracer=tracer)
    _log.info(
        "autotune: enabled — start %s, worker cap %d, staging headroom "
        "%.0f MB", knobs.as_dict(), limits.max_decode_workers,
        limits.hbm_headroom_bytes / 1e6,
    )
    return knobs, tuner
