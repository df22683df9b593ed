"""Bounded exponential-backoff retry for transient I/O (counterpart of
``jama16_retina_tpu/utils/retry.py``).

The TFRecord reads of the train stream, ``Checkpointer.restore``,
``count_records`` and the host stage's per-image reads under ``predict
--max_retries`` route transient failures through ``retry_call``:

  * bounded: ``attempts`` is a hard cap, and the last attempt's
    exception is re-raised unchanged;
  * cheap when quiet: a first attempt that succeeds costs one try frame;
  * observable: every retried failure counts ``io.retries`` and
    ``io.retries.{site}`` in the process registry (a reader process's
    counts travel back to the trainer's with its batch);
  * deterministic: the delays are ``base * 2^k`` capped, no jitter,
    slept through an injectable ``sleep``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable

from jama16_retina_tpu_torch.obs import registry as obs_registry

_log = logging.getLogger(__name__)

# Transient by default: filesystem and network hiccups. A malformed
# payload (ValueError) does not get better on retry.
DEFAULT_TRANSIENT: tuple = (OSError, IOError)

RETRIES_HELP = ("transient I/O failures that were retried "
                "(utils/retry.py), all sites")
SITE_RETRIES_HELP = "transient I/O failures retried at this one call site"


def backoff_delays(attempts: int, base_delay: float,
                   max_delay: float) -> Iterable[float]:
    """The sleeps between attempts: base * 2^k, capped at ``max_delay``."""
    d = base_delay
    for _ in range(max(0, attempts - 1)):
        yield min(d, max_delay)
        d *= 2.0


def retry_call(
    fn: Callable,
    *args,
    attempts: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: tuple = DEFAULT_TRANSIENT,
    site: str = "",
    sleep: Callable[[float], None] = time.sleep,
    registry: "obs_registry.Registry | None" = None,
    **kwargs,
):
    """``fn(*args, **kwargs)`` with up to ``attempts`` tries. An exception
    in ``retry_on`` backs off and retries; any other propagates at once;
    the last attempt's exception is re-raised unchanged. ``site`` names
    the call site in ``io.retries.{site}`` and the log."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = backoff_delays(attempts, base_delay, max_delay)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == attempts:
                # The text, not the exception: a handler that keeps its
                # records would keep the failing frames (and the buffers
                # they point into) alive with it.
                _log.warning(
                    "retry budget exhausted%s after %d attempts: %s: %s",
                    f" at {site}" if site else "", attempts,
                    type(e).__name__, str(e))
                raise
            reg = (registry if registry is not None
                   else obs_registry.default_registry())
            reg.counter("io.retries", help=RETRIES_HELP).inc()
            if site:
                reg.counter(f"io.retries.{site}",
                            help=SITE_RETRIES_HELP).inc()
            delay = next(delays)
            _log.warning(
                "transient %s%s (attempt %d/%d), retrying in %.3fs: %s",
                type(e).__name__, f" at {site}" if site else "",
                attempt, attempts, delay, str(e))
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
