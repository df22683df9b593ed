"""Ensemble averaging (copy of ``jama16_retina_tpu/eval/metrics.py:288``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def ensemble_average(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    """Per-model probabilities averaged linearly, in float64."""
    if not len(prob_list):
        raise ValueError("empty ensemble")
    stacked = np.stack([np.asarray(p, dtype=np.float64) for p in prob_list])
    return np.mean(stacked, axis=0)
