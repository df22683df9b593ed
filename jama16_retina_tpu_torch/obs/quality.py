"""Reference profiles, online drift detection and the golden-set canary
(counterpart of ``jama16_retina_tpu/obs/quality.py``).

  * The reference profile (``build_profile`` / ``save_profile`` /
    ``load_profile``): a versioned, sealed JSON artifact holding a
    split's score histogram over fixed bins of [0, 1], histograms of
    per-image input statistics, the positive base rate and the
    operating thresholds. ``evaluate_checkpoints(profile_out=)`` and
    ``obs.quality.profile_out`` at the end of a fit write it; from the
    same inputs it is byte-identical to the JAX package's.
  * ``QualityMonitor``: the engine's ``probs`` feeds it each request's
    scores and input statistics; every ``window_scores`` scores
    (tumbling windows) it publishes the debiased PSI against the
    profile and the positive rate as ``quality.*`` gauges.
  * ``GoldenCanary``: a pinned image set scored through the engine on a
    cadence (through the engine's members but not its ``probs``, so
    canary traffic never enters the drift windows) and compared exactly, or within ``atol``.

A disabled monitor (or registry) costs ``observe`` one branch.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time

import numpy as np

from jama16_retina_tpu_torch.integrity import artifact as artifact_lib
from jama16_retina_tpu_torch.obs import registry as registry_lib

_log = logging.getLogger(__name__)

PROFILE_VERSION = 1

# Per-image input statistics, dimensionless in [0, 1] over the uint8
# image scaled by 1/255: channel means, global std, gray brightness.
INPUT_STATS = ("mean_r", "mean_g", "mean_b", "std", "brightness")

# Floor of a bin's proportion in PSI and KL: an empty bin on one side
# must not give an infinite term.
_EPS = 1e-4


def bin_counts(values: np.ndarray, bins: int) -> np.ndarray:
    """Counts of ``values`` over ``bins`` uniform buckets of [0, 1],
    values outside clamped into the edge bins."""
    v = np.asarray(values, np.float64).ravel()
    idx = np.clip((v * bins).astype(np.int64), 0, bins - 1)
    return np.bincount(idx, minlength=bins).astype(np.int64)


def _proportions(counts: np.ndarray) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    total = c.sum()
    if total <= 0:
        return np.full(c.shape, 1.0 / c.size)
    return np.maximum(c / total, _EPS)


def psi(ref_counts: np.ndarray, cur_counts: np.ndarray) -> float:
    """Population Stability Index of two histograms of one binning:
    sum((cur - ref) * ln(cur / ref)) over bin proportions."""
    p = _proportions(ref_counts)
    q = _proportions(cur_counts)
    return float(np.sum((q - p) * np.log(q / p)))


def psi_debiased(ref_counts: np.ndarray, cur_counts: np.ndarray) -> float:
    """PSI less its small-sample expectation ``(bins - 1) * (1/n_cur +
    1/n_ref)``, clamped at 0: what the monitor publishes, so a threshold
    means drift above sampling noise at any window size."""
    ref = np.asarray(ref_counts, np.float64)
    cur = np.asarray(cur_counts, np.float64)
    bias = (ref.size - 1) * (
        1.0 / max(1.0, cur.sum()) + 1.0 / max(1.0, ref.sum()))
    return max(0.0, psi(ref, cur) - bias)


def kl_divergence(ref_counts: np.ndarray, cur_counts: np.ndarray) -> float:
    """KL(cur || ref) over bin proportions."""
    p = _proportions(ref_counts)
    q = _proportions(cur_counts)
    return float(np.sum(q * np.log(q / p)))


def input_stat_values(images: np.ndarray) -> dict:
    """INPUT_STATS of uint8 images [n, S, S, 3]: {stat: float64 [n]}."""
    imgs = np.asarray(images)
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected images [n, S, S, 3], got {imgs.shape}")
    x = imgs.astype(np.float32) / 255.0
    chan = x.mean(axis=(1, 2))
    gray = chan @ np.array([0.299, 0.587, 0.114], np.float32)
    return {
        "mean_r": chan[:, 0].astype(np.float64),
        "mean_g": chan[:, 1].astype(np.float64),
        "mean_b": chan[:, 2].astype(np.float64),
        "std": x.reshape(x.shape[0], -1).std(axis=1).astype(np.float64),
        "brightness": gray.astype(np.float64),
    }


def build_profile(scores: np.ndarray, labels: "np.ndarray | None" = None,
                  stat_values: "dict | None" = None,
                  thresholds: "list | tuple" = (), bins: int = 20,
                  meta: "dict | None" = None) -> dict:
    """The reference profile: ``scores`` are referable probabilities,
    ``labels`` binary labels for the base rate, ``stat_values`` an
    ``input_stat_values``-shaped dict, ``thresholds`` operating-point
    rows (each with at least ``threshold``)."""
    scores = np.asarray(scores, np.float64).ravel()
    profile = {
        "version": PROFILE_VERSION,
        "kind": "quality_profile",
        "bins": int(bins),
        "n_examples": int(scores.size),
        "score_hist": bin_counts(scores, bins).tolist(),
        "base_rate": (
            float(np.asarray(labels, np.float64).mean())
            if labels is not None and np.asarray(labels).size else None),
        "thresholds": [
            {k: (float(v) if isinstance(v, (int, float, np.floating))
                 else v)
             for k, v in dict(t).items()}
            for t in thresholds
        ],
        "input_stats": {k: bin_counts(v, bins).tolist()
                        for k, v in (stat_values or {}).items()},
    }
    if meta:
        profile["meta"] = dict(meta)
    return profile


def save_profile(path: str, profile: dict) -> str:
    """Sealed atomic write."""
    return artifact_lib.write_sealed_json(
        path, profile, schema="quality.profile", version=PROFILE_VERSION)


def load_profile(path: str) -> dict:
    with open(path) as f:
        profile = json.load(f)
    v = profile.get("version")
    if v != PROFILE_VERSION:
        raise ValueError(
            f"quality profile {path!r} has version {v!r}; this runtime "
            f"reads version {PROFILE_VERSION} — re-emit it with evaluate "
            "--profile_out")
    if profile.get("kind") != "quality_profile":
        raise ValueError(f"{path!r} is not a quality profile artifact")
    # After the version and kind checks, which keep their own errors.
    artifact_lib.verify_payload(profile, path, artifact="profile")
    return profile


def split_input_stats(data_dir: str, split: str, batch_size: int,
                      image_size: int) -> dict:
    """``input_stat_values`` over one epoch of an eval split, padding
    rows excluded."""
    from jama16_retina_tpu_torch.data import pipeline

    acc: dict = {k: [] for k in INPUT_STATS}
    for batch in pipeline.eval_batches(data_dir, split, batch_size,
                                       image_size):
        img = batch["image"][batch["mask"] > 0]
        if img.shape[0] == 0:
            continue
        stats = input_stat_values(img)
        for k in INPUT_STATS:
            acc[k].append(stats[k])
    return {k: np.concatenate(v) if v else np.zeros((0,), np.float64)
            for k, v in acc.items()}


def save_canary(path: str, images: np.ndarray,
                scores: "np.ndarray | None" = None) -> str:
    """The canary artifact: pinned uint8 images and, optionally, their
    pinned scores, as ``.npz`` (the suffix added when missing; the name
    written is returned) with a seal sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"images": np.asarray(images, np.uint8)}
    if scores is not None:
        payload["scores"] = np.asarray(scores, np.float64)
    out = path if path.endswith(".npz") else path + ".npz"
    buf = io.BytesIO()
    np.savez(buf, **payload)
    blob = buf.getvalue()
    artifact_lib.atomic_write_bytes(out, blob)
    artifact_lib.write_seal_sidecar(out, schema="quality.canary",
                                    version=PROFILE_VERSION, blob=blob)
    return out


def load_canary_file(path: str) -> tuple:
    """(images, scores or None) of a ``save_canary`` file, its sidecar
    (when it has one) verified first."""
    artifact_lib.verify_sidecar(path, artifact="canary")
    with np.load(path) as z:
        images = np.asarray(z["images"], np.uint8)
        scores = (np.asarray(z["scores"], np.float64)
                  if "scores" in z.files else None)
    return images, scores


class GoldenCanary:
    """A pinned image set whose scores must not move.

    ``check(score_fn)`` scores the images and compares them with the
    reference scores (pinned by the first check when none were given):
    exactly at ``atol=0``, else within ``atol``. Publishes
    ``quality.canary_ok`` (starts at 1), ``quality.canary_max_dev`` (-1
    on a shape mismatch or a failed scoring), ``quality.canary_runs`` and
    ``quality.canary_failures``.
    """

    def __init__(self, images: np.ndarray,
                 reference_scores: "np.ndarray | None" = None,
                 atol: float = 0.0, every_s: float = 300.0,
                 registry: "registry_lib.Registry | None" = None):
        self.images = np.asarray(images, np.uint8)
        if self.images.ndim != 4 or self.images.shape[0] == 0:
            raise ValueError(f"canary needs images [n>=1, S, S, 3], got "
                             f"{self.images.shape}")
        self.reference = (np.asarray(reference_scores, np.float64)
                          if reference_scores is not None else None)
        self.atol = float(atol)
        self.every_s = float(every_s)
        reg = (registry if registry is not None
               else registry_lib.default_registry())
        self._g_ok = reg.gauge(
            "quality.canary_ok",
            help="1 while the last canary run matched its pinned scores")
        self._g_dev = reg.gauge(
            "quality.canary_max_dev",
            help="max |score - pinned| of the last canary run (-1 = shape "
                 "mismatch or failed scoring)")
        self._c_runs = reg.counter("quality.canary_runs",
                                   help="canary scoring passes")
        self._c_failures = reg.counter(
            "quality.canary_failures",
            help="canary runs whose scores deviated from the pinned set")
        self._g_ok.set(1.0)
        self._last_run: "float | None" = None
        self._claim_lock = threading.Lock()

    def due(self, now: "float | None" = None) -> bool:
        if self.every_s <= 0:
            return False
        if self._last_run is None:
            return True
        now = time.monotonic() if now is None else now
        return (now - self._last_run) >= self.every_s

    def claim_due(self, now: "float | None" = None) -> bool:
        """due() and the cadence stamp in one step: of concurrent callers
        at a cadence boundary exactly one wins the run."""
        with self._claim_lock:
            if not self.due(now):
                return False
            self._last_run = time.monotonic() if now is None else now
            return True

    def check(self, score_fn, now: "float | None" = None) -> dict:
        """Score the pinned set through ``score_fn(images) -> [n]``:
        ``{'ok', 'pinned', 'max_abs_dev'}``. A ``score_fn`` that raises is
        a canary failure (and ``'error'`` in the result), not an error of
        the live request it rode."""
        with self._claim_lock:
            self._last_run = time.monotonic() if now is None else now
        self._c_runs.inc()
        try:
            scores = np.asarray(score_fn(self.images), np.float64).ravel()
        except Exception as e:  # noqa: BLE001 - any scoring failure
            _log.error("golden canary scoring failed: %s: %s",
                       type(e).__name__, e)
            self._g_ok.set(0.0)
            self._g_dev.set(-1.0)
            self._c_failures.inc()
            return {"ok": False, "pinned": False,
                    "max_abs_dev": float("inf"),
                    "error": f"{type(e).__name__}: {e}"}
        if self.reference is None:
            self.reference = scores
            self._g_ok.set(1.0)
            self._g_dev.set(0.0)
            return {"ok": True, "pinned": True, "max_abs_dev": 0.0}
        same = scores.shape == self.reference.shape
        dev = (float(np.max(np.abs(scores - self.reference))) if same
               else float("inf"))
        ok = same and (
            np.array_equal(scores, self.reference) if self.atol == 0.0
            else bool(np.all(np.abs(scores - self.reference) <= self.atol)))
        self._g_ok.set(1.0 if ok else 0.0)
        self._g_dev.set(-1.0 if dev == float("inf") else dev)
        if not ok:
            self._c_failures.inc()
        return {"ok": ok, "pinned": False, "max_abs_dev": dev}


class QualityMonitor:
    """Tumbling-window drift detection against a reference profile.

    ``observe(images, scores, stats=)`` bins a batch's scores and input
    statistics; when ``window_scores`` scores have gathered, the window
    closes and publishes ``quality.score_psi``, ``quality.score_kl``,
    ``quality.input_psi.<stat>``, ``quality.input_psi_max`` (against the
    profile, when loaded) and ``quality.positive_rate`` (the share at or
    above the profile's first operating threshold, else 0.5); it counts
    ``quality.windows`` and ``quality.scores``, and sets
    ``quality.profile_loaded`` to the profile's version (0 = none).
    Thread-safe.
    """

    def __init__(self, qcfg, registry: "registry_lib.Registry | None" = None,
                 profile: "dict | None" = None,
                 canary: "GoldenCanary | None" = None):
        self.enabled = bool(getattr(qcfg, "enabled", True))
        self._registry = (registry if registry is not None
                          else registry_lib.default_registry())
        self.canary = canary
        # The input-statistics pass of a batch given without ``stats``.
        self.stats_fn = input_stat_values
        if not self.enabled:
            self.profile = None
            return
        self.bins = int(getattr(qcfg, "score_bins", 20))
        self.window_scores = max(1, int(getattr(qcfg, "window_scores", 256)))
        self.profile = profile
        self._ref_scores = None
        self._ref_stats: dict = {}
        self.threshold = 0.5
        if profile is not None:
            if int(profile.get("bins", -1)) != self.bins:
                raise ValueError(
                    f"profile has {profile.get('bins')} bins but "
                    f"obs.quality.score_bins={self.bins}; histograms must "
                    "share binning to be comparable")
            self._ref_scores = np.asarray(profile["score_hist"], np.float64)
            self._ref_stats = {
                k: np.asarray(v, np.float64)
                for k, v in profile.get("input_stats", {}).items()
                if k in INPUT_STATS}
            thr = profile.get("thresholds") or []
            if thr and "threshold" in thr[0]:
                self.threshold = float(thr[0]["threshold"])
        reg = self._registry
        self._lock = threading.Lock()
        self._g_profile = reg.gauge(
            "quality.profile_loaded",
            help="version of the loaded reference profile (0 = none)")
        self._g_profile.set(float(profile["version"])
                            if profile is not None else 0.0)
        self._g_score_psi = reg.gauge(
            "quality.score_psi",
            help="debiased PSI of the window's scores vs the profile")
        self._g_score_kl = reg.gauge(
            "quality.score_kl",
            help="KL(window scores || profile) over the same window")
        self._g_pos_rate = reg.gauge(
            "quality.positive_rate",
            help="share of window scores at or above the profile's first "
                 "operating threshold")
        self._g_input_max = reg.gauge(
            "quality.input_psi_max",
            help="max input-statistic PSI over " + "/".join(INPUT_STATS))
        self._g_input = {
            k: reg.gauge(f"quality.input_psi.{k}",
                         help="debiased PSI of one input statistic vs the "
                              "profile")
            for k in INPUT_STATS}
        self._c_windows = reg.counter("quality.windows",
                                      help="closed drift windows")
        self._c_scores = reg.counter(
            "quality.scores",
            help="live scores observed (canary traffic excluded)")
        self._reset_window_locked()

    def _reset_window_locked(self) -> None:
        self._score_counts = np.zeros(self.bins, np.int64)
        self._stat_counts = {k: np.zeros(self.bins, np.int64)
                             for k in INPUT_STATS}
        self._stat_n = 0
        self._pos = 0
        self._n = 0

    def _publish_locked(self) -> None:
        if self._ref_scores is not None:
            self._g_score_psi.set(
                psi_debiased(self._ref_scores, self._score_counts))
            self._g_score_kl.set(
                kl_divergence(self._ref_scores, self._score_counts))
            worst = 0.0
            if self._stat_n:
                for k, ref in self._ref_stats.items():
                    v = psi_debiased(ref, self._stat_counts[k])
                    self._g_input[k].set(v)
                    worst = max(worst, v)
                self._g_input_max.set(worst)
            else:
                # A window without input statistics carries no input
                # drift: republish 0 so an old window's gauges cannot
                # stay latched.
                for g in self._g_input.values():
                    g.set(0.0)
                self._g_input_max.set(0.0)
        self._g_pos_rate.set(self._pos / max(1, self._n))
        self._c_windows.inc()
        self._reset_window_locked()

    def reads_input_stats(self) -> bool:
        """Whether ``observe`` bins input statistics: the monitor and its
        registry are on and the profile has reference histograms."""
        return (self.enabled and self._registry.enabled
                and bool(self._ref_stats))

    def observe(self, images: "np.ndarray | None", scores: np.ndarray,
                stats: "dict | None" = None) -> None:
        """One batch of live traffic: ``scores`` the ensemble-averaged
        probabilities ([n], or [n, C] reduced to referable), ``images``
        the uint8 rows (None: no input statistics). ``stats``, an
        INPUT_STATS dict already computed (the fused preprocess kernel's
        sums), replaces the per-pixel pass. Input statistics are binned
        only when the profile has reference histograms."""
        if not self.enabled or not self._registry.enabled:
            return
        s = np.asarray(scores, np.float64)
        if s.ndim == 2:
            from jama16_retina_tpu_torch.eval import metrics

            s = np.asarray(metrics.referable_probs_from_multiclass(s),
                           np.float64)
        s = s.ravel()
        if s.size == 0:
            return
        score_add = bin_counts(s, self.bins)
        pos_add = int((s >= self.threshold).sum())
        if stats is None:
            stats = (self.stats_fn(images)
                     if images is not None and self._ref_stats else None)
        elif not self._ref_stats:
            stats = None
        with self._lock:
            self._score_counts += score_add
            self._pos += pos_add
            self._n += s.size
            self._c_scores.inc(s.size)
            if stats is not None:
                for k in INPUT_STATS:
                    self._stat_counts[k] += bin_counts(stats[k], self.bins)
                self._stat_n += s.size
            if self._n >= self.window_scores:
                self._publish_locked()

    def canary_claim(self, now: "float | None" = None) -> bool:
        """The canary is due, and this caller has claimed its run."""
        return (self.enabled and self.canary is not None
                and self.canary.claim_due(now))

    def run_canary(self, score_fn,
                   now: "float | None" = None) -> "dict | None":
        """Score the pinned set now. ``score_fn`` must not pass through
        ``observe``, so canary traffic never enters the drift windows."""
        if not self.enabled or self.canary is None:
            return None
        return self.canary.check(score_fn, now=now)


def monitor_from_config(qcfg, registry=None) -> "QualityMonitor | None":
    """None when ``obs.quality`` is off; else a monitor with the profile
    and canary loaded from their paths (a wrong path raises here)."""
    if not getattr(qcfg, "enabled", False):
        return None
    profile = load_profile(qcfg.profile_path) if qcfg.profile_path else None
    canary = None
    if qcfg.canary_path:
        images, pinned = load_canary_file(qcfg.canary_path)
        canary = GoldenCanary(images, reference_scores=pinned,
                              atol=qcfg.canary_atol,
                              every_s=qcfg.canary_every_s,
                              registry=registry)
    return QualityMonitor(qcfg, registry=registry, profile=profile,
                          canary=canary)
