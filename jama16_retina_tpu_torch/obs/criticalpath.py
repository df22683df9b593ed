"""Critical-path analysis over trace events (counterpart of
``jama16_retina_tpu/obs/criticalpath.py``): typed bottleneck verdicts.

A pure function family over Chrome-shaped events (``Tracer.events``):
per-request and per-step waterfalls grouped by the ``trace_id`` the
instrumented seams stamp, seconds per category over the window, and a
``DiagnosisVerdict`` (``device_bound``, ``decode_bound``,
``credit_starved``, ``h2d_bound``, ``queue_bound`` or ``balanced``)
with its evidence fractions and the slowest waterfalls.

Categories: ``device`` is ``trainer.dispatch`` and the request
``device`` segments (the ``serve.engine.*`` spans nest inside them and
are left out); ``decode`` the consumer's ``ingest.batch.{decode,cache}``
or, without them, ``trainer.input``; ``credit``
``ingest.batch.credit_wait``; ``queue`` the request ``queue_wait`` and
``window_fill`` segments; ``h2d`` any segment whose name holds ``h2d``;
``other`` the rest. A verdict needs the largest bound category to carry
at least ``DOMINANT_FRACTION`` of the attributed time, else the window
is ``balanced``; ``confidence`` is that fraction either way.

The flight recorder runs ``diagnose`` in every dump. The device summary
that splits ``device_bound`` into its sub-causes comes from the device
plane (ROADMAP item 11, part 4), which the port does not publish yet, so
the port's dumps pass ``device=None`` and keep the unrefined verdict, as
the reference's do on a backend without those gauges.
"""

from __future__ import annotations

import dataclasses

# Verdict -> stable numeric code for the obs.diagnosis.verdict gauge
# (alert rules compare numbers; the order is append-only). Codes 6-8
# are the device-plane refinements of ``device_bound``: when
# ``diagnose(device=...)`` gets a device summary (obs/device.py MFU +
# roofline gauges), "the device is the bottleneck" splits into WHY.
VERDICT_CODES = {
    "balanced": 0,
    "device_bound": 1,
    "decode_bound": 2,
    "credit_starved": 3,
    "h2d_bound": 4,
    "queue_bound": 5,
    "device_compute_bound": 6,
    "device_membw_bound": 7,
    "device_underutilized": 8,
}

# Category -> the verdict it argues for.
_CATEGORY_VERDICT = {
    "device": "device_bound",
    "decode": "decode_bound",
    "credit": "credit_starved",
    "h2d": "h2d_bound",
    "queue": "queue_bound",
}

# Share of attributed wall the dominant category must carry before the
# diagnosis commits to a typed verdict (below it: "balanced").
DOMINANT_FRACTION = 0.4
# MFU at or above which a compute-class device window is saturated
# (the reference's ``obs/device.SATURATED_MFU``).
SATURATED_MFU = 0.4

_DEVICE = {"trainer.dispatch", "serve.request.device",
           "serve.router.request.device"}
_DECODE = {"ingest.batch.decode", "ingest.batch.cache"}
_CREDIT = {"ingest.batch.credit_wait"}
_QUEUE = {"serve.request.queue_wait", "serve.request.window_fill",
          "serve.router.request.queue_wait"}
# Sub-spans nested inside an already-counted parent segment: counting
# them again would double the wall they share.
_NESTED_PREFIXES = ("serve.engine.",)

_REQUEST_PREFIXES = ("serve.request.", "serve.router.request.",
                     "ingest.batch.")
_STEP_PREFIX = "trainer."


def _complete_events(events) -> list:
    """The ph='X' events with a usable duration, as (name, ts_us,
    dur_s, args) tuples sorted by timestamp."""
    out = []
    for e in events or ():
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        if not name or any(name.startswith(p) for p in _NESTED_PREFIXES):
            continue
        try:
            dur_s = float(e.get("dur", 0.0)) / 1e6
            ts = float(e.get("ts", 0.0))
        except (TypeError, ValueError):
            continue
        if dur_s < 0.0:
            continue
        out.append((name, ts, dur_s, e.get("args") or {}))
    out.sort(key=lambda t: t[1])
    return out


def _category(name: str) -> str:
    if name in _DEVICE:
        return "device"
    if name in _DECODE:
        return "decode"
    if name in _CREDIT:
        return "credit"
    if name in _QUEUE:
        return "queue"
    if "h2d" in name:
        return "h2d"
    return "other"


def attribute(events) -> dict:
    """Seconds per category over the whole event window, double-count
    disciplined (module docstring): {'device','decode','credit','h2d',
    'queue','other'} -> seconds."""
    evs = _complete_events(events)
    totals = {k: 0.0 for k in ("device", "decode", "credit", "h2d",
                               "queue", "other")}
    have_consumer_ingest = any(
        n.startswith("ingest.batch.") for n, _t, _d, _a in evs
    )
    input_total = 0.0
    ingest_total = 0.0
    for name, _ts, dur_s, _args in evs:
        if name == "trainer.input":
            input_total += dur_s
            continue
        if name == "ingest.decode.batch":
            # Server lane of the same wall the consumer's
            # ingest.batch.* segments tile — only stands in when that
            # decomposition is absent (server-only traces).
            if not have_consumer_ingest:
                totals["decode"] += dur_s
            continue
        totals[_category(name)] += dur_s
        if name.startswith("ingest.batch."):
            ingest_total += dur_s
    if have_consumer_ingest:
        # The ingest.batch.* segments tile the input wait; whatever
        # trainer.input measured beyond them is loader overhead the
        # decomposition did not see.
        totals["other"] += max(0.0, input_total - ingest_total)
    else:
        totals["decode"] += input_total
    return totals


def _group_waterfalls(evs, want) -> list:
    """Group (name, ts, dur, args) tuples by args['trace_id'] for names
    ``want`` admits -> waterfall dicts, slowest first."""
    groups: dict = {}
    for name, ts, dur_s, args in evs:
        if not want(name):
            continue
        tid = args.get("trace_id")
        if not tid:
            continue
        groups.setdefault(tid, []).append((ts, name, dur_s))
    out = []
    for tid, segs in groups.items():
        segs.sort()
        total = sum(d for _ts, _n, d in segs)
        out.append({
            "trace_id": tid,
            "total_s": round(total, 6),
            "dominant": (
                max(segs, key=lambda s: s[2])[1] if segs else None
            ),
            "segments": [
                {"name": n, "dur_s": round(d, 6),
                 "frac": round(d / total, 4) if total > 0 else 0.0}
                for _ts, n, d in segs
            ],
        })
    out.sort(key=lambda w: -w["total_s"])
    return out


def request_waterfalls(events) -> list:
    """Per-request (and per-served-batch) waterfalls: the serve.request
    / router / ingest.batch segment families grouped by the trace id
    their instrumentation stamps into args, slowest first."""
    evs = _complete_events(events)
    return _group_waterfalls(
        evs, lambda n: any(n.startswith(p) for p in _REQUEST_PREFIXES)
    )


def step_waterfalls(events) -> list:
    """Per-train-step waterfalls: the ``trainer.*`` segment timeline
    split at each ``trainer.dispatch`` (one dispatch == one step; the
    segments since the previous dispatch belong to this step), slowest
    first."""
    evs = [t for t in _complete_events(events)
           if t[0].startswith(_STEP_PREFIX)]
    steps: list = []
    cur: list = []
    for name, ts, dur_s, _args in evs:
        cur.append((ts, name, dur_s))
        if name == "trainer.dispatch":
            steps.append(cur)
            cur = []
    out = []
    for i, segs in enumerate(steps):
        total = sum(d for _ts, _n, d in segs)
        out.append({
            "step_index": i,
            "total_s": round(total, 6),
            "dominant": max(segs, key=lambda s: s[2])[1],
            "segments": [
                {"name": n, "dur_s": round(d, 6),
                 "frac": round(d / total, 4) if total > 0 else 0.0}
                for _ts, n, d in segs
            ],
        })
    out.sort(key=lambda w: -w["total_s"])
    return out


@dataclasses.dataclass(frozen=True)
class DiagnosisVerdict:
    """The typed answer. ``evidence`` maps every category (including
    ``other``) to its fraction of attributed wall; ``confidence`` is
    the dominant bound category's fraction (0.0 when nothing was
    attributable)."""

    verdict: str
    code: int
    confidence: float
    evidence: dict
    totals_s: dict
    n_events: int
    request_waterfalls: list
    step_waterfalls: list
    # Device summary (obs/device.summary_from_gauges) that refined a
    # device_bound verdict into its sub-cause, or None when no device
    # plane was available (the verdict stays unrefined).
    device: "dict | None" = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def refine_device_verdict(device: "dict | None") -> "str | None":
    """device summary -> the typed sub-cause of ``device_bound``, or
    None when the summary cannot commit (no MFU, no roofline class).

    A memory-bandwidth-bound dominant program means more FLOP/s is not
    on the table regardless of MFU (``device_membw_bound``); a
    compute-class window at >= ``device.SATURATED_MFU`` is genuinely
    compute-saturated (``device_compute_bound``); below it the chip is
    the bottleneck only because each dispatch is too small to fill it —
    the batch-size MFU cliff (``device_underutilized``)."""
    if not device:
        return None
    if device.get("dominant_class") == "memory":
        return "device_membw_bound"
    mfu = device.get("mfu")
    if mfu is None:
        return None
    if float(mfu) >= SATURATED_MFU:
        return "device_compute_bound"
    return "device_underutilized"


def diagnose(events, top_k: int = 3,
             device: "dict | None" = None) -> DiagnosisVerdict:
    """events -> DiagnosisVerdict. Pure; an empty / unattributable
    window diagnoses ``balanced`` at confidence 0.0 rather than
    guessing. ``device`` (obs/device.summary_from_gauges) refines a
    ``device_bound`` verdict into its typed sub-cause; every other
    verdict ignores it."""
    totals = attribute(events)
    wall = sum(totals.values())
    evidence = {
        k: (round(v / wall, 4) if wall > 0 else 0.0)
        for k, v in totals.items()
    }
    best_cat, best_frac = None, 0.0
    for cat in _CATEGORY_VERDICT:
        if evidence[cat] > best_frac:
            best_cat, best_frac = cat, evidence[cat]
    if best_cat is not None and best_frac >= DOMINANT_FRACTION:
        verdict = _CATEGORY_VERDICT[best_cat]
    else:
        verdict = "balanced"
    used_device = None
    if verdict == "device_bound" and device:
        sub = refine_device_verdict(device)
        if sub is not None:
            verdict = sub
            used_device = dict(device)
    k = max(0, int(top_k))
    return DiagnosisVerdict(
        verdict=verdict,
        code=VERDICT_CODES[verdict],
        confidence=round(best_frac, 4),
        evidence=evidence,
        totals_s={k2: round(v, 6) for k2, v in totals.items()},
        n_events=len(_complete_events(events)),
        request_waterfalls=request_waterfalls(events)[:k],
        step_waterfalls=step_waterfalls(events)[:k],
        device=used_device,
    )
