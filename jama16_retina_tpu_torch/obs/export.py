"""Telemetry export (counterpart of ``jama16_retina_tpu/obs/export.py``):
periodic snapshots as JSONL records and a Prometheus text file.

A ``Snapshotter`` flush writes, from one registry snapshot:

  * a ``telemetry`` record through the run's RunLog (counters, gauges,
    histogram summaries with their exemplars), the record
    ``scripts/obs_report.py`` renders;
  * a ``heartbeat`` record with ``step`` and ``last_progress_t`` (when
    the step last advanced), so a host that stopped writing and one that
    writes but stopped progressing both show in the JSONL;
  * ``<workdir>/telemetry.prom``, rewritten atomically, for a file-based
    scraper.

The port runs one process, so the process index is always 0 (the
reference's per-process ``.p{N}`` names never arise). The fleet bus and
the device monitor (ROADMAP item 11, parts 4 and 5) are not ported:
their seams are absent, and ``serve_http`` refuses.
"""

from __future__ import annotations

import os
import re
import time

from jama16_retina_tpu_torch.obs import registry as registry_lib

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
HTTP_ITEM = "Queue A item 11 (part 5: obs/httpd.py, the HTTP endpoint)"


def _prom_name(name: str) -> str:
    """Dotted registry names -> Prometheus metric names."""
    return _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(float(v))


def _escape_help(text: str) -> str:
    """HELP text escaping: backslash and newline only."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text(snapshot: dict) -> str:
    """A ``Registry.snapshot()`` as Prometheus text exposition: counters,
    gauges and cumulative ``le`` histogram series with ``_sum`` and
    ``_count``, each metric with help text preceded by its ``# HELP``
    line."""
    help_by = snapshot.get("help", {})

    def _help_line(lines: list, name: str, prom: str) -> None:
        text = help_by.get(name)
        if text:
            lines.append(f"# HELP {prom} {_escape_help(text)}")

    lines: "list[str]" = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        n = _prom_name(name)
        _help_line(lines, name, n)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(v)}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        n = _prom_name(name)
        _help_line(lines, name, n)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(v)}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        n = _prom_name(name)
        _help_line(lines, name, n)
        lines.append(f"# TYPE {n} histogram")
        for bound, cum in h["buckets"]:
            lines.append(f'{n}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{n}_sum {_fmt(h['sum'])}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"


def _round(v):
    return round(v, 6) if v is not None else None


def _jsonl_histograms(snapshot: dict) -> dict:
    """Histogram summaries for the ``telemetry`` record: quantiles and
    count/sum, and the window's exemplar, without the bucket series (the
    ``.prom`` file has those)."""
    return {
        name: {
            "count": h["count"],
            "sum": round(h["sum"], 6),
            **{k: _round(h[k]) for k in ("mean", "p50", "p95", "p99")},
            **({"exemplar": h["exemplar"]} if h.get("exemplar") else {}),
        }
        for name, h in snapshot.get("histograms", {}).items()
    }


class Snapshotter:
    """Registry snapshot -> ``telemetry`` record + ``heartbeat`` record +
    atomic ``telemetry.prom``, at most every ``every_s`` seconds.

    Pass the run's ``runlog`` (the trainer does), or let the snapshotter
    open its own RunLog in ``workdir`` (predict, serving sessions); an
    owned log is closed by ``close()``. ``progress(step)`` is the hot
    path: two attribute writes. ``alerts`` (an ``AlertManager``) is
    evaluated on every flush against the snapshot just taken, and may be
    attached after construction. ``fleet`` and ``device`` must be None
    (ROADMAP item 11, parts 4 and 5).
    """

    def __init__(self, registry: "registry_lib.Registry | None" = None,
                 workdir: str = "", runlog=None, every_s: float = 60.0,
                 prom_name: str = "telemetry.prom", alerts=None,
                 fleet=None, device=None):
        if not workdir and runlog is None:
            raise ValueError("Snapshotter needs a workdir and/or a runlog")
        if fleet is not None or device is not None:
            raise NotImplementedError(
                "the fleet bus and the device monitor are not ported yet; "
                "see ROADMAP.md Queue A item 11 (parts 4 and 5)")
        self._registry = (registry if registry is not None
                          else registry_lib.default_registry())
        self._workdir = workdir
        self._owns_log = runlog is None
        if runlog is None:
            from jama16_retina_tpu_torch.utils.logging import RunLog

            runlog = RunLog(workdir)
        self._log = runlog
        self.every_s = float(every_s)
        self._prom_name = prom_name
        self.alerts = alerts
        self._last_flush = time.time()
        self._step: "int | None" = None
        self._last_progress_t: "float | None" = None
        self.flushes = 0

    def progress(self, step: int) -> None:
        """Record forward progress (the heartbeat's payload)."""
        self._step = int(step)
        self._last_progress_t = time.time()

    def write_record(self, kind: str, **fields) -> None:
        """One custom record through the snapshotter's RunLog (the
        router's report as a ``router`` record)."""
        self._log.write(kind, **fields)

    def flush(self) -> dict:
        """Snapshot now: one ``telemetry`` and one ``heartbeat`` record,
        the alert rules, and (with a workdir) the ``.prom`` rewrite.
        Returns the snapshot. The flush is the one reader that closes the
        histograms' exemplar windows."""
        snap = self._registry.snapshot(reset_exemplars=True)
        self._log.write(
            "telemetry",
            counters={k: round(v, 6) for k, v in snap["counters"].items()},
            gauges={k: round(v, 6) for k, v in snap["gauges"].items()},
            histograms=_jsonl_histograms(snap),
        )
        self._log.write(
            "heartbeat", process_index=0, step=self._step,
            last_progress_t=(round(self._last_progress_t, 3)
                             if self._last_progress_t is not None else None),
        )
        if self.alerts is not None:
            self.alerts.evaluate(snapshot=snap, runlog=self._log)
        if self._workdir:
            from jama16_retina_tpu_torch.integrity import (
                artifact as artifact_lib)

            os.makedirs(self._workdir, exist_ok=True)
            # Rewritten every flush: whole for a scraper, not durable.
            artifact_lib.atomic_write_text(
                os.path.join(self._workdir, self._prom_name),
                prometheus_text(snap), fsync=False)
        self._last_flush = time.time()
        self.flushes += 1
        return snap

    def maybe_flush(self) -> "dict | None":
        if time.time() - self._last_flush >= self.every_s:
            return self.flush()
        return None

    def serve_http(self, port: int, max_age_s: float = 300.0):
        raise NotImplementedError(
            f"obs.http_port={port}: the HTTP endpoint is not ported yet; "
            f"see ROADMAP.md {HTTP_ITEM}")

    def close(self) -> None:
        """A final flush, then close the owned RunLog (never one the
        caller passed in)."""
        self.flush()
        if self._owns_log:
            self._log.close()
