"""Replica autoscaling signals (counterpart of
``jama16_retina_tpu/serve/scaler.py``): a pure, hysteresis-guarded
policy over the router's own load gauges.

``decide`` maps one tumbling window's statistics and the controller's
explicit state to a decision: the same stats and state give the same
decision and reason (no clocks, no random draws). The router runs it at
its tick cadence, always publishes the desired replica count
(``serve.scaler.desired_replicas``), and acts on it in-process (activate
or drain a replica) when it owns a replica factory.

Hysteresis (the constants are module-level so tests pin the shipped
values):

  * scale up after ``HOT_WINDOWS`` consecutive hot windows: the queue
    holds more than ``QUEUE_HIGH`` of one dispatch wave's rows, or rows
    in flight exceed ``IN_FLIGHT_HIGH`` of capacity, or the p99 latency
    breaches the SLO;
  * scale down after ``QUIET_WINDOWS`` consecutive quiet windows: an
    empty queue, rows in flight under ``IN_FLIGHT_LOW`` of capacity, p99
    under half the SLO;
  * a window between the two holds and resets both streaks;
  * one replica per decision, within [min_replicas, max_replicas]; still
    hot at max_replicas reports ``saturated``.
"""

from __future__ import annotations

import dataclasses

QUEUE_HIGH = 0.5       # queued rows > this share of one dispatch wave
                       # (active * max_batch): a backlog is building
IN_FLIGHT_HIGH = 0.75  # rows in flight / capacity above: replicas busy
IN_FLIGHT_LOW = 0.25   # below, with an empty queue: over-provisioned
HOT_WINDOWS = 2        # consecutive hot windows before one scale-up
QUIET_WINDOWS = 3      # consecutive quiet windows before one scale-down
MIN_WINDOW_S = 0.05    # shorter windows carry no usable signal


@dataclasses.dataclass(frozen=True)
class ScalerStats:
    """One tumbling window's load signals: mean queued rows, mean rows in
    flight, and the window's p99 request latency (0: no requests)."""

    window_sec: float
    queue_rows: float
    in_flight_rows: float
    p99_latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScalerState:
    """The controller's memory, threaded through ``decide`` so that the
    decision stays a pure function."""

    hot_windows: int = 0
    quiet_windows: int = 0


@dataclasses.dataclass(frozen=True)
class ScalerLimits:
    min_replicas: int = 1
    max_replicas: int = 8
    # p99 SLO in seconds; 0 disables the latency signal.
    slo_p99_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScalerDecision:
    desired: int
    state: ScalerState
    reason: str
    saturated: bool = False


def decide(stats: ScalerStats, active: int, max_batch: int,
           state: ScalerState, limits: ScalerLimits) -> ScalerDecision:
    """One scaling decision. ``active`` is the replica count the window's
    stats describe and ``max_batch`` sizes one dispatch wave. ``desired``
    is at most one step from ``active`` and always inside the limits."""
    active = max(1, int(active))
    lo = max(1, int(limits.min_replicas))
    hi = max(lo, int(limits.max_replicas))
    clamped = min(hi, max(lo, active))
    if stats.window_sec < MIN_WINDOW_S:
        return ScalerDecision(clamped, state, "window_too_short")
    capacity = float(active * max(1, int(max_batch)))
    in_flight_frac = stats.in_flight_rows / capacity
    slo = float(limits.slo_p99_s)
    slo_hot = slo > 0 and stats.p99_latency_s > slo
    hot = (
        stats.queue_rows > QUEUE_HIGH * capacity
        or in_flight_frac > IN_FLIGHT_HIGH
        or slo_hot
    )
    quiet = (
        stats.queue_rows == 0
        and in_flight_frac < IN_FLIGHT_LOW
        and (slo <= 0 or stats.p99_latency_s < 0.5 * slo)
    )
    if hot:
        streak = state.hot_windows + 1
        if streak >= HOT_WINDOWS:
            if clamped >= hi:
                # Still hot at the ceiling: hold and report saturation,
                # keeping the streak so the signal stays on every window.
                return ScalerDecision(
                    hi, ScalerState(hot_windows=min(streak, HOT_WINDOWS)),
                    "saturated_at_max", saturated=True,
                )
            return ScalerDecision(
                min(hi, clamped + 1), ScalerState(),
                "scale_up:" + ("slo_p99" if slo_hot else
                               "queue" if stats.queue_rows
                               > QUEUE_HIGH * capacity else "in_flight"),
            )
        return ScalerDecision(
            clamped, ScalerState(hot_windows=streak), "hot_streak"
        )
    if quiet:
        streak = state.quiet_windows + 1
        if streak >= QUIET_WINDOWS and clamped > lo:
            return ScalerDecision(
                clamped - 1, ScalerState(), "scale_down:quiet"
            )
        return ScalerDecision(
            clamped, ScalerState(quiet_windows=min(streak, QUIET_WINDOWS)),
            "quiet_streak",
        )
    # Between hot and quiet: hold, and reset both streaks (the evidence
    # must come in consecutive windows to move the replica count).
    return ScalerDecision(clamped, ScalerState(), "hold")
