"""Evaluation metrics of the port: a copy of
``jama16_retina_tpu/eval/metrics.py`` (pure numpy), kept verbatim below
this docstring so the port's reports equal the reference's to the bit.

ROC-AUC and sensitivity at fixed-specificity operating points
(specificity 0.87 and 0.98), thresholds transferred from a tuning
split, bootstrap confidence intervals, calibration (Brier, ECE,
temperature scaling), ensemble probability averaging, and the 5-class
ICDR metrics. All functions accept 1-D numpy arrays; probabilities are
P(positive).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """ROC curve via single descending sort (O(n log n)).

    Returns (fpr, tpr, thresholds) with one point per distinct score,
    matching sklearn.metrics.roc_curve's convention of prepending the
    (0, 0) point with threshold +inf.
    """
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    if labels.shape != scores.shape:
        raise ValueError("labels and scores must have the same shape")
    if labels.size == 0:
        raise ValueError(
            "roc_curve got empty input — no examples reached the metric "
            "(check eval split / mask filtering)"
        )
    if not np.all((labels == 0.0) | (labels == 1.0)):
        raise ValueError(
            "roc_curve expects binary labels in {0, 1}; got values "
            f"{np.unique(labels)[:6]} — binarize grades first "
            "(e.g. synthetic.binary_labels)"
        )
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    scores = scores[order]

    # Cumulative TP/FP counts at each distinct-score cut.
    distinct = np.where(np.diff(scores))[0]
    cut = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[cut]
    fps = (cut + 1) - tps
    p = tps[-1] if tps.size else 0.0
    n = fps[-1] if fps.size else 0.0
    if p == 0 or n == 0:
        raise ValueError("roc_curve needs at least one positive and one negative")
    tpr = np.r_[0.0, tps / p]
    fpr = np.r_[0.0, fps / n]
    thresholds = np.r_[np.inf, scores[cut]]
    return fpr, tpr, thresholds


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve (trapezoidal; ties handled via the curve)."""
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(np.trapezoid(tpr, fpr))


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """Threshold chosen at a fixed specificity (reference operating points)."""

    target_specificity: float
    threshold: float
    sensitivity: float
    specificity: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sensitivity_at_specificity(
    labels: np.ndarray, scores: np.ndarray, target_specificity: float
) -> OperatingPoint:
    """Pick the ROC threshold with specificity >= target that maximizes
    sensitivity; report achieved sens/spec at that threshold.

    This is the reference's operating-point selection (BASELINE.json:8):
    on the ROC curve, specificity = 1 - fpr, so we take the largest fpr
    with 1 - fpr >= target (ties on the curve already resolved toward
    higher tpr by construction).
    """
    fpr, tpr, thresholds = roc_curve(labels, scores)
    spec = 1.0 - fpr
    feasible = np.where(spec >= target_specificity)[0]
    if feasible.size == 0:  # unreachable: the (0,0) point has spec 1.0
        feasible = np.array([0])
    best = feasible[np.argmax(tpr[feasible])]
    return OperatingPoint(
        target_specificity=float(target_specificity),
        threshold=float(thresholds[best]),
        sensitivity=float(tpr[best]),
        specificity=float(spec[best]),
    )


def confusion_at_threshold(
    labels: np.ndarray, scores: np.ndarray, threshold: float
) -> dict:
    labels = np.asarray(labels).ravel().astype(bool)
    pred = np.asarray(scores).ravel() >= threshold
    tp = int(np.sum(pred & labels))
    fp = int(np.sum(pred & ~labels))
    fn = int(np.sum(~pred & labels))
    tn = int(np.sum(~pred & ~labels))
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "sensitivity": tp / max(tp + fn, 1),
        "specificity": tn / max(tn + fp, 1),
        "precision": tp / max(tp + fp, 1),
        "accuracy": (tp + tn) / max(tp + fp + fn + tn, 1),
    }


def transferred_operating_points(
    tune_labels: np.ndarray,
    tune_scores: np.ndarray,
    eval_labels: np.ndarray,
    eval_scores: np.ndarray,
    operating_specificities: Sequence[float],
    bootstrap_samples: int = 0,
    bootstrap_seed: int = 0,
) -> list[dict]:
    """The paper's operating-point protocol (JAMA 2016 / the replication):
    thresholds are chosen at fixed specificity on a TUNING split, then
    applied unchanged to the held-out eval split — reporting achieved
    sensitivity/specificity plus the full confusion there. Selecting
    thresholds on the eval split itself (sensitivity_at_specificity
    directly) is optimistically biased; both forms appear in the report
    so the bias is visible. ``bootstrap_samples > 0`` adds 95% CIs on the
    achieved sensitivity/specificity (eval-split resampling at the FIXED
    transferred threshold — these rows are the protocol's headline
    numbers, so they carry the uncertainty too).
    """
    rows = []
    for s in operating_specificities:
        op = sensitivity_at_specificity(tune_labels, tune_scores, s)
        achieved = confusion_at_threshold(eval_labels, eval_scores, op.threshold)
        row = {
            "target_specificity": float(s),
            "threshold": op.threshold,
            **achieved,
        }
        if bootstrap_samples > 0:
            thr = op.threshold

            def sens_spec(l, sc):
                c = confusion_at_threshold(l, sc, thr)
                return {"sensitivity": c["sensitivity"],
                        "specificity": c["specificity"]}

            cis = bootstrap_ci(
                eval_labels, eval_scores, sens_spec,
                bootstrap_samples, bootstrap_seed,
            )
            row["sensitivity_ci95"] = list(cis["sensitivity"])
            row["specificity_ci95"] = list(cis["specificity"])
        rows.append(row)
    return rows


def bootstrap_ci(
    labels: np.ndarray,
    scores: np.ndarray,
    stat_fn,
    n_samples: int = 2000,
    seed: int = 0,
    alpha: float = 0.05,
):
    """Percentile-bootstrap CI for any statistic of (labels, scores) —
    the replication reported 95% CIs on AUC this way.

    ``stat_fn`` may return a float (returns ``(lo, hi)``) or a dict of
    floats (returns ``{key: (lo, hi)}``, all statistics computed from
    the SAME resamples — one pass instead of one per statistic).
    Resamples that lose one class (possible on small eval sets) are
    skipped; at least half of ``n_samples`` (min 20) must survive.
    """
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    rng = np.random.default_rng(seed)
    stats = []
    for _ in range(n_samples):
        idx = rng.integers(0, labels.size, labels.size)
        lab = labels[idx]
        if lab.min() == lab.max():  # one-class resample: statistic undefined
            continue
        stats.append(stat_fn(lab, scores[idx]))
    min_valid = max(20, n_samples // 2)
    if len(stats) < min_valid:
        raise ValueError(
            f"only {len(stats)}/{n_samples} bootstrap resamples were valid "
            f"(need >= {min_valid}) — eval set too small/imbalanced for a CI"
        )
    q = [alpha / 2, 1 - alpha / 2]
    if isinstance(stats[0], dict):
        return {
            k: tuple(float(v) for v in np.quantile([s[k] for s in stats], q))
            for k in stats[0]
        }
    lo, hi = np.quantile(stats, q)
    return float(lo), float(hi)


def brier_score(labels: np.ndarray, scores: np.ndarray) -> float:
    labels = np.asarray(labels, dtype=np.float64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    return float(np.mean((scores - labels) ** 2))


def expected_calibration_error(
    labels: np.ndarray, scores: np.ndarray, n_bins: int = 15
) -> float:
    """Equal-width-bin ECE: sum_b (n_b/N) * |acc_b - conf_b|. Reported
    next to Brier so miscalibration (which threshold transfer inherits)
    is visible; recalibrate externally from --save_probs if needed."""
    labels = np.asarray(labels, dtype=np.float64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    if labels.size == 0:
        raise ValueError("expected_calibration_error got empty input")
    bins = np.clip(
        (scores * n_bins).astype(np.int64), 0, n_bins - 1
    )
    ece = 0.0
    for b in range(n_bins):
        sel = bins == b
        n_b = int(sel.sum())
        if n_b == 0:
            continue
        ece += (n_b / labels.size) * abs(
            labels[sel].mean() - scores[sel].mean()
        )
    return float(ece)


def fit_temperature(
    labels: np.ndarray, probs: np.ndarray,
    lo: float = 0.05, hi: float = 20.0, iters: int = 80,
) -> float:
    """Temperature that minimizes binary NLL on a TUNING split (golden-
    section search over log T — NLL in T is unimodal for fixed logits).
    Probabilities are mapped back to logits first, so this composes with
    ensemble averaging. Apply with :func:`apply_temperature` to the EVAL
    split; never fit on the split being reported (same bias rule as
    threshold transfer).
    """
    labels = np.asarray(labels, dtype=np.float64).ravel()
    p = np.clip(np.asarray(probs, dtype=np.float64).ravel(), 1e-7, 1 - 1e-7)
    logits = np.log(p) - np.log1p(-p)

    def nll(log_t: float) -> float:
        z = logits / np.exp(log_t)
        # stable log(1+e^z): logaddexp(0, z)
        return float(np.mean(np.logaddexp(0.0, z) - labels * z))

    a, b = np.log(lo), np.log(hi)
    phi = (np.sqrt(5.0) - 1) / 2
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = nll(c), nll(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = nll(d)
    return float(np.exp((a + b) / 2))


def apply_temperature(probs: np.ndarray, temperature: float) -> np.ndarray:
    """sigmoid(logit(p) / T) elementwise."""
    p = np.clip(np.asarray(probs, dtype=np.float64), 1e-7, 1 - 1e-7)
    logits = np.log(p) - np.log1p(-p)
    return 1.0 / (1.0 + np.exp(-logits / temperature))


def ensemble_average(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    """Averaged per-model probabilities (reference's "averaged logits",
    BASELINE.json:10 — the replication averaged the models' sigmoid
    outputs linearly)."""
    if not prob_list:
        raise ValueError("empty ensemble")
    stacked = np.stack([np.asarray(p, dtype=np.float64) for p in prob_list])
    return np.mean(stacked, axis=0)


# ---------------------------------------------------------------------------
# 5-class ICDR severity metrics (BASELINE.json:9 "multi:softmax")
# ---------------------------------------------------------------------------


def multiclass_accuracy(labels: np.ndarray, probs: np.ndarray) -> float:
    pred = np.argmax(np.asarray(probs), axis=-1)
    return float(np.mean(pred == np.asarray(labels).ravel()))


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes: int) -> np.ndarray:
    labels = np.asarray(labels).ravel().astype(np.int64)
    preds = np.asarray(preds).ravel().astype(np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def quadratic_weighted_kappa(
    labels: np.ndarray, preds: np.ndarray, num_classes: int = 5
) -> float:
    """Quadratic-weighted Cohen's kappa — the standard ordinal agreement
    metric for ICDR grading (used by the Kaggle EyePACS competition)."""
    cm = confusion_matrix(labels, preds, num_classes).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    idx = np.arange(num_classes, dtype=np.float64)
    w = (idx[:, None] - idx[None, :]) ** 2 / (num_classes - 1) ** 2
    row = cm.sum(axis=1)
    col = cm.sum(axis=0)
    expected = np.outer(row, col) / n
    denom = np.sum(w * expected)
    if denom == 0:
        return 0.0
    return float(1.0 - np.sum(w * cm) / denom)


def referable_probs_from_multiclass(probs: np.ndarray) -> np.ndarray:
    """Collapse 5-class ICDR probabilities to P(referable DR) = P(grade>=2),
    so binary operating-point reporting works for the multi head too."""
    probs = np.asarray(probs, dtype=np.float64)
    return probs[..., 2:].sum(axis=-1)


def evaluation_report(
    labels: np.ndarray,
    probs: np.ndarray,
    operating_specificities: Sequence[float] = (0.87, 0.98),
    bootstrap_samples: int = 0,
    bootstrap_seed: int = 0,
) -> dict:
    """The reference's final eval report shape: AUC plus one row per
    operating point (SURVEY.md §3.2), identical format for every backend.

    ``bootstrap_samples > 0`` adds 95% percentile-bootstrap intervals
    (``auc_ci95``, per-point ``sensitivity_ci95``) — the replication
    paper's uncertainty protocol, absent from the reference code."""
    labels = np.asarray(labels).ravel()
    probs = np.asarray(probs)
    if probs.ndim == 2 and probs.shape[-1] == 2:
        raise ValueError(
            "2-column probabilities are ambiguous; pass P(positive) as a "
            "1-D array for the binary head (probs[:, 1])"
        )
    if probs.ndim == 2 and probs.shape[-1] > 2:  # 5-class ICDR head
        binary_labels = (labels >= 2).astype(np.float64)
        binary_probs = referable_probs_from_multiclass(probs)
        report = {
            "accuracy": multiclass_accuracy(labels, probs),
            "quadratic_weighted_kappa": quadratic_weighted_kappa(
                labels, np.argmax(probs, axis=-1), probs.shape[-1]
            ),
        }
    else:
        binary_labels = labels.astype(np.float64)
        binary_probs = probs.ravel()
        report = {}
    report["auc"] = roc_auc(binary_labels, binary_probs)
    report["brier"] = brier_score(binary_labels, binary_probs)
    report["ece"] = expected_calibration_error(binary_labels, binary_probs)
    report["n_examples"] = int(binary_labels.size)
    # Each row: the ROC-chosen point plus the full confusion at its
    # threshold (reference R2 reports confusion at the operating points).
    report["operating_points"] = []
    for s in operating_specificities:
        op = sensitivity_at_specificity(binary_labels, binary_probs, s)
        conf = confusion_at_threshold(binary_labels, binary_probs, op.threshold)
        report["operating_points"].append({**conf, **op.as_dict()})
    if bootstrap_samples > 0:
        report["auc_ci95"] = list(bootstrap_ci(
            binary_labels, binary_probs, roc_auc, bootstrap_samples,
            bootstrap_seed,
        ))
        for row in report["operating_points"]:
            thr = row["threshold"]
            row["sensitivity_ci95"] = list(bootstrap_ci(
                binary_labels, binary_probs,
                lambda l, s: confusion_at_threshold(l, s, thr)["sensitivity"],
                bootstrap_samples, bootstrap_seed,
            ))
    return report
