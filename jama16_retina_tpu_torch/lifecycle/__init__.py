"""The drift-to-retrain lifecycle (counterpart of
``jama16_retina_tpu/lifecycle/``): a journaled state machine that turns a
firing alert into retrain -> gate -> staged rollout -> watch -> commit or
rollback, crash-safe at every step.

  * ``journal``    — the atomic on-disk transition journal and the live
    pointer.
  * ``controller`` — ``LifecycleController``, with seams for every
    expensive phase (``retrain_fn``, ``gate_fns``, the watch rules), and
    the three default gates.

Operator surface: ``python -m jama16_retina_tpu_torch.lifecycle_run``, the
``serve.lifecycle.state`` gauge and ``lifecycle.*`` counters, and the
``lifecycle`` run-log records the reference's ``obs_report`` renders.
"""

from jama16_retina_tpu_torch.lifecycle.controller import (
    GateVerdict,
    LifecycleController,
    STATES,
    TERMINAL_STATES,
)
from jama16_retina_tpu_torch.lifecycle.journal import Journal

__all__ = [
    "GateVerdict",
    "Journal",
    "LifecycleController",
    "STATES",
    "TERMINAL_STATES",
]
