"""Observability of the port (counterpart of ``jama16_retina_tpu/obs/``).

  * ``registry``     named Counters, Gauges and fixed-bucket Histograms
                     (with exemplars), a process-wide default registry;
  * ``spans``        ``span(name)`` timing blocks into histograms and the
                     timeline, and ``StallClock``, the train loops' stall
                     attribution;
  * ``trace``        per-thread ring buffers of events, trace contexts,
                     Chrome-trace export;
  * ``export``       the ``Snapshotter``: ``telemetry`` and ``heartbeat``
                     records and the atomic ``telemetry.prom``;
  * ``flightrec``    anomaly-triggered blackbox dumps with their
                     critical-path diagnosis (``criticalpath``);
  * ``alerts``       declarative SLO and quality rules evaluated at flush;
  * ``quality``      reference profiles, the drift monitor and the golden
                     canary.

Records, metric names and help strings are the reference's, so
``scripts/obs_report.py`` reads a port run's workdir; the metric
glossary is ``docs/OBSERVABILITY.md``.
"""

from jama16_retina_tpu_torch.obs.alerts import (
    AlertManager,
    AlertRule,
    parse_rule,
)
from jama16_retina_tpu_torch.obs.flightrec import FlightRecorder
from jama16_retina_tpu_torch.obs.quality import (
    GoldenCanary,
    QualityMonitor,
    build_profile,
    load_profile,
    monitor_from_config,
    psi,
    save_profile,
)
from jama16_retina_tpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    set_default_registry,
)
from jama16_retina_tpu_torch.obs.spans import StallClock, span
from jama16_retina_tpu_torch.obs.trace import (
    Tracer,
    chrome_trace,
    default_tracer,
    set_default_tracer,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "AlertManager",
    "AlertRule",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "GoldenCanary",
    "Histogram",
    "QualityMonitor",
    "Registry",
    "StallClock",
    "Tracer",
    "build_profile",
    "chrome_trace",
    "default_registry",
    "default_tracer",
    "load_profile",
    "monitor_from_config",
    "parse_rule",
    "psi",
    "save_profile",
    "set_default_registry",
    "set_default_tracer",
    "span",
]
