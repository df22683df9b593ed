"""``GateVerdict`` of ``jama16_retina_tpu/lifecycle/controller.py``: the
typed verdict of one named gate, which the cascade's go-live gate
returns (``serve/cascade.py``). The lifecycle controller itself is not
ported (ROADMAP Queue A item 11)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GateVerdict:
    """One named gate's typed verdict over a candidate. ``skipped``
    gates pass vacuously but say so (no artifact / no data to judge
    with), so a record says why a gate did not bind."""

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
