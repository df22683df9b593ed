"""The port's metrics (a copy of ``jama16_retina_tpu/eval/metrics.py``)
against the JAX package's, exactly: the same reports, AUCs, thresholds,
intervals and calibration numbers to the bit, on seeded labels and scores
with ties, and on the degenerate single-class split."""

import json
import math
import re

import numpy as np
import pytest

from jama16_retina_tpu.eval import metrics as jax_metrics
from jama16_retina_tpu_torch.eval import metrics


def _same(got, want):
    """Equal to the bit, NaN equal to NaN, through nested containers."""
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _data(seed: int, n: int = 60, ties: bool = True):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.35).astype(np.float64)
    scores = np.clip(0.3 * labels + rng.normal(0.35, 0.25, n), 0, 1)
    if ties:  # coarse scores: many tied values across both classes
        scores = np.round(scores, 1)
    return labels, scores.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluation_report_matches(seed):
    labels, scores = _data(seed)
    for kw in ({}, {"bootstrap_samples": 50, "bootstrap_seed": seed}):
        _same(metrics.evaluation_report(labels, scores, (0.87, 0.98), **kw),
              jax_metrics.evaluation_report(labels, scores, (0.87, 0.98),
                                            **kw))


@pytest.mark.parametrize("seed", [3, 4])
def test_transferred_operating_points_match(seed):
    tune = _data(seed)
    ev = _data(seed + 100, ties=False)
    for kw in ({}, {"bootstrap_samples": 40}):
        _same(metrics.transferred_operating_points(*tune, *ev, (0.87, 0.98),
                                                   **kw),
              jax_metrics.transferred_operating_points(*tune, *ev,
                                                       (0.87, 0.98), **kw))


def test_roc_curve_and_point_functions_match():
    labels, scores = _data(5)
    for a, b in zip(metrics.roc_curve(labels, scores),
                    jax_metrics.roc_curve(labels, scores)):
        np.testing.assert_array_equal(a, b)
    for spec in (0.5, 0.87, 0.98, 1.0):
        _same(metrics.sensitivity_at_specificity(labels, scores, spec)
              .as_dict(),
              jax_metrics.sensitivity_at_specificity(labels, scores, spec)
              .as_dict())
    for thr in (0.2, 0.5, math.inf):
        _same(metrics.confusion_at_threshold(labels, scores, thr),
              jax_metrics.confusion_at_threshold(labels, scores, thr))


def test_bootstrap_ci_matches():
    labels, scores = _data(6)
    for seed in (0, 9):
        assert metrics.bootstrap_ci(labels, scores, metrics.roc_auc, 100,
                                    seed) == jax_metrics.bootstrap_ci(
            labels, scores, jax_metrics.roc_auc, 100, seed)
    with pytest.raises(ValueError, match="bootstrap"):
        metrics.bootstrap_ci(labels[:3], scores[:3], metrics.roc_auc, 20)


def test_calibration_and_averaging_match():
    labels, scores = _data(7, ties=False)
    assert metrics.brier_score(labels, scores) == jax_metrics.brier_score(
        labels, scores)
    assert metrics.expected_calibration_error(
        labels, scores) == jax_metrics.expected_calibration_error(
        labels, scores)
    t = metrics.fit_temperature(labels, scores)
    assert t == jax_metrics.fit_temperature(labels, scores)
    np.testing.assert_array_equal(metrics.apply_temperature(scores, t),
                                  jax_metrics.apply_temperature(scores, t))
    members = [_data(s, ties=False)[1] for s in (8, 9, 10)]
    np.testing.assert_array_equal(metrics.ensemble_average(members),
                                  jax_metrics.ensemble_average(members))
    multi = np.random.default_rng(11).dirichlet(np.ones(5), 30)
    grades = np.random.default_rng(12).integers(0, 5, 30)
    np.testing.assert_array_equal(
        metrics.referable_probs_from_multiclass(multi),
        jax_metrics.referable_probs_from_multiclass(multi))
    _same(metrics.evaluation_report(grades, multi),
          jax_metrics.evaluation_report(grades, multi))


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_single_class_split_raises_like_the_reference(label):
    """One class only: both refuse the ROC curve with the same error, and
    the bootstrap skips such resamples the same way."""
    scores = _data(13)[1]
    labels = np.full(scores.shape, label)
    for fn in (lambda m: m.evaluation_report(labels, scores),
               lambda m: m.roc_auc(labels, scores)):
        with pytest.raises(ValueError) as got:
            fn(metrics)
        with pytest.raises(ValueError) as want:
            fn(jax_metrics)
        assert str(got.value) == str(want.value)
    # A nearly single-class split: most resamples lack a positive.
    labels[:2] = 1.0 - label
    for samples in (30, 400):
        try:
            want = jax_metrics.bootstrap_ci(labels, scores,
                                            jax_metrics.roc_auc, samples)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                metrics.bootstrap_ci(labels, scores, metrics.roc_auc,
                                     samples)
        else:
            assert metrics.bootstrap_ci(labels, scores, metrics.roc_auc,
                                        samples) == want
