"""Distilled ensemble cascade (counterpart of
``jama16_retina_tpu/serve/cascade.py``).

A distilled student (one model trained against the ensemble's soft
scores, ``train.distill_from``) scores every row. Only rows whose
referable score lies within ``serve.cascade_band`` of any of
``serve.cascade_thresholds`` (empty means (0.5,)) are scored again by
the full k-member ensemble, whose scores replace the student's for
exactly those rows. Band 0 escalates only exact threshold hits; a band
covering [0, 1] escalates every row, and the cascade is the ensemble.

With ``serve.cascade_speculative`` the ensemble scores the whole request
on a one-worker thread while the student scores it, and the escalated
rows take those scores: an escalated row then waits for the slower of
the two, not both. The ensemble scores all n rows at the bucket of n,
where the serial form scores the escalated rows at the bucket of their
count; the rows are the same up to the convolution algorithm the card
picks for each batch shape (bitwise on the CPU). The discarded rows are
counted (``serve.cascade.speculated.wasted``).

``go_live`` refuses a cascade that would move the operating points
(``CascadeRejected``): the ``golden_canary`` gate holds the cascade's
scores on the pinned canary within ``lifecycle.gate_canary_max_dev``,
and the ``auc_floor`` gate holds its AUC on labelled rows, and the
sensitivity and specificity at every cascade threshold, within
``lifecycle.gate_auc_floor_delta`` of the full ensemble's.

``reload``, ``rollback`` and ``release_retained`` act on the ensemble:
a retrained ensemble is swapped under the cascade while the student
keeps serving.
"""

from __future__ import annotations

import logging

import numpy as np

from jama16_retina_tpu_torch.configs import ExperimentConfig
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.lifecycle.controller import GateVerdict
from jama16_retina_tpu_torch.obs import registry as obs_registry

_log = logging.getLogger(__name__)


class CascadeRejected(RuntimeError):
    """The cascade failed its go-live gate (golden-canary deviation or an
    operating-point AUC floor miss): retrain the student
    (``train.distill_from``), widen the band, or serve the plain
    ensemble."""


def _referable(scores: np.ndarray) -> np.ndarray:
    """Scores -> referable probability [n] for either head (the scalar
    the band and both gates compare)."""
    s = np.asarray(scores, np.float64)
    if s.ndim == 2:
        s = np.asarray(metrics.referable_probs_from_multiclass(s),
                       np.float64)
    return s.ravel()


class CascadeEngine:
    """Student-first scoring with band escalation to the full ensemble.

    ``student`` and ``ensemble`` are two ``ServingEngine``s (or anything
    with the engine's ``probs`` row contract, such as the router's
    ``EscalationPool``); the student is normally a one-member engine over
    the ``train.distill_from`` product.
    ``quality``: a monitor fed the merged scores; build both halves with
    ``obs.quality`` off when one is passed (``serve/assemble.py`` does).
    """

    def __init__(self, cfg: ExperimentConfig, student, ensemble,
                 registry: "obs_registry.Registry | None" = None,
                 quality=None):
        self.cfg = cfg
        sc = cfg.serve
        self.band = float(sc.cascade_band)
        if self.band < 0:
            raise ValueError(
                f"serve.cascade_band must be >= 0, got {self.band}")
        self.thresholds = tuple(
            float(t) for t in (sc.cascade_thresholds or (0.5,)))
        bad = [t for t in self.thresholds if not 0.0 <= t <= 1.0]
        if bad:
            raise ValueError(
                f"serve.cascade_thresholds must lie in [0, 1]: {bad}")
        self.student = student
        self.ensemble = ensemble
        self.registry = (registry if registry is not None
                         else getattr(ensemble, "registry",
                                      obs_registry.default_registry()))
        self._c_student_rows = self.registry.counter(
            "serve.cascade.student_rows",
            help="rows scored by the distilled student (every cascade row)")
        self._c_escalated_rows = self.registry.counter(
            "serve.cascade.escalated_rows",
            help="rows in the escalation band, scored by the full ensemble")
        self.speculative = bool(sc.cascade_speculative)
        self._c_speculated = self.registry.counter(
            "serve.cascade.speculated",
            help="rows scored by the ensemble beside the student "
                 "(serve.cascade_speculative)")
        self._c_speculated_wasted = self.registry.counter(
            "serve.cascade.speculated.wasted",
            help="speculated rows outside the band, whose ensemble score "
                 "was discarded")
        self._spec_pool = None
        self.quality = quality

    # -- escalation policy -------------------------------------------------

    def escalation_mask(self, referable: np.ndarray) -> np.ndarray:
        """True where a student referable score lies within ``band`` of
        any operating threshold."""
        r = np.asarray(referable, np.float64).ravel()
        mask = np.zeros(r.shape, bool)
        for thr in self.thresholds:
            mask |= np.abs(r - thr) <= self.band
        return mask

    # -- the serving surface -----------------------------------------------

    def _spec_submit(self, fn, *args):
        """``fn`` on the speculation thread, made on first use (one
        worker: speculative batches take turns, as the serial cascade's
        ensemble calls do)."""
        if self._spec_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._spec_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cascade-spec")
        return self._spec_pool.submit(fn, *args)

    def _probs_raw(self, images: np.ndarray) -> np.ndarray:
        """Scores with no quality hook: what the canary and the gates
        score through."""
        return self._probs_masked(images)[0]

    def _probs_masked(self, images: np.ndarray
                      ) -> "tuple[np.ndarray, np.ndarray]":
        """(merged scores, escalation mask)."""
        spec_fut = None
        if self.speculative and len(images):
            # An EscalationPool ensemble takes its speculative entry point,
            # so whole speculated batches do not count as escalations
            # there; the rows the band flips are credited back below.
            spec_fn = getattr(self.ensemble, "probs_speculative", None)
            spec_fut = self._spec_submit(
                spec_fn if spec_fn is not None else self.ensemble.probs,
                images)
        out = np.asarray(self.student.probs(images))
        n = int(out.shape[0])
        self._c_student_rows.inc(n)
        mask = self.escalation_mask(_referable(out))
        if spec_fut is not None:
            esc_all = np.asarray(spec_fut.result())
            self._c_speculated.inc(n)
            esc_n = int(mask.sum())
            self._c_speculated_wasted.inc(n - esc_n)
            note = getattr(self.ensemble, "note_escalated", None)
            if note is not None:
                note(esc_n)
            if mask.any():
                out = np.array(out)
                out[mask] = esc_all[mask]
                self._c_escalated_rows.inc(esc_n)
        elif mask.any():
            out = np.array(out)
            out[mask] = np.asarray(self.ensemble.probs(images[mask]))
            self._c_escalated_rows.inc(int(mask.sum()))
        return out, mask

    def probs(self, images: np.ndarray) -> np.ndarray:
        """Row i is row i's score: the student's, or the full ensemble's
        where the student landed in the band. The quality monitor sees
        the merged scores; the canary rides the whole cascade."""
        out = self._probs_masked(images)[0]
        q = self.quality
        if q is not None:
            q.observe(images, out)
            if q.canary_claim():
                q.run_canary(self._probs_raw)
        return out

    def make_batcher(self):
        """A ``MicroBatcher`` over the cascade under the ``serve``
        section's knobs, as ``ServingEngine.make_batcher``."""
        from jama16_retina_tpu_torch.serve.batcher import MicroBatcher

        sc, size = self.cfg.serve, self.cfg.model.image_size
        return MicroBatcher(
            self.probs, max_batch=sc.max_batch, max_wait_ms=sc.max_wait_ms,
            row_shape=(size, size, 3), row_dtype=np.uint8,
            registry=self.registry, shed_queue_depth=sc.shed_queue_depth,
            shed_in_flight=sc.shed_in_flight,
            default_deadline_ms=sc.default_deadline_ms)

    # -- generations: the ensemble's ---------------------------------------

    @property
    def generation(self) -> int:
        return self.ensemble.generation

    def reload(self, member_dirs=None, *, state_dicts=None) -> dict:
        return self.ensemble.reload(member_dirs, state_dicts=state_dicts)

    def rollback(self) -> dict:
        return self.ensemble.rollback()

    def release_retained(self) -> None:
        self.ensemble.release_retained()

    def close(self) -> None:
        """Stop the speculation thread (idempotent); the two engines stay
        their owner's."""
        pool, self._spec_pool = self._spec_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- the go-live gate ---------------------------------------------------

    def gate(self, images: "np.ndarray | None" = None,
             grades: "np.ndarray | None" = None) -> "list[GateVerdict]":
        """The ``golden_canary`` and ``auc_floor`` verdicts (see the
        module docstring); each is skipped, and says why, when it has no
        canary or no labelled rows of both classes to judge with."""
        return [self._gate_golden_canary(),
                self._gate_auc_floor(images, grades)]

    def _gate_golden_canary(self) -> GateVerdict:
        # The cascade's own monitor carries the pinned canary; a bare
        # cascade over a monitored ensemble falls back to that one's.
        q = (self.quality if self.quality is not None
             else getattr(self.ensemble, "quality", None))
        canary = q.canary if q is not None else None
        if canary is None or canary.reference is None:
            return GateVerdict(name="golden_canary", passed=True,
                               skipped=True,
                               detail="no canary artifact configured/pinned")
        scores = _referable(self._probs_raw(canary.images))
        ref = _referable(canary.reference)
        if scores.shape != ref.shape:
            return GateVerdict(
                name="golden_canary", passed=False,
                detail=f"score shape {scores.shape} vs pinned {ref.shape}")
        dev = float(np.max(np.abs(scores - ref)))
        thr = float(self.cfg.lifecycle.gate_canary_max_dev)
        return GateVerdict(name="golden_canary", passed=dev <= thr,
                           value=dev, threshold=thr)

    def _gate_auc_floor(self, images, grades) -> GateVerdict:
        if images is None or grades is None:
            return GateVerdict(name="auc_floor", passed=True, skipped=True,
                               detail="no labeled rows provided to score")
        labels = (np.asarray(grades) >= 2).astype(np.float64)
        if not (0.0 < labels.mean() < 1.0):
            return GateVerdict(
                name="auc_floor", passed=True, skipped=True,
                detail="gate rows are single-class; AUC undefined")
        casc = _referable(self._probs_raw(images))
        full = _referable(self.ensemble.probs(images))
        auc_casc = metrics.roc_auc(labels, casc)
        auc_full = metrics.roc_auc(labels, full)
        delta = float(self.cfg.lifecycle.gate_auc_floor_delta)
        # AUC alone can hide a swap exactly at a screening threshold: the
        # decisions there must track the ensemble's within the delta too.
        op_ok, op_detail = True, []
        for thr in self.thresholds:
            cm_c = metrics.confusion_at_threshold(labels, casc, thr)
            cm_f = metrics.confusion_at_threshold(labels, full, thr)
            op_ok &= (cm_c["sensitivity"] >= cm_f["sensitivity"] - delta
                      and cm_c["specificity"] >= cm_f["specificity"] - delta)
            op_detail.append(
                f"thr={thr:g}: sens {cm_c['sensitivity']:.4f} vs "
                f"{cm_f['sensitivity']:.4f}, spec "
                f"{cm_c['specificity']:.4f} vs {cm_f['specificity']:.4f}")
        return GateVerdict(
            name="auc_floor",
            passed=bool(auc_casc >= auc_full - delta) and bool(op_ok),
            value=float(auc_casc), threshold=float(auc_full - delta),
            detail=f"full_auc={auc_full:.6f}; " + "; ".join(op_detail))

    def go_live(self, images: "np.ndarray | None" = None,
                grades: "np.ndarray | None" = None) -> "list[GateVerdict]":
        """Run the gates; raise ``CascadeRejected`` naming every failed
        verdict, else return the verdicts."""
        verdicts = self.gate(images, grades)
        failed = [v for v in verdicts if not v.passed]
        if failed:
            raise CascadeRejected(
                "cascade refused at go-live: " + "; ".join(
                    f"{v.name} (value={v.value}, threshold={v.threshold}, "
                    f"{v.detail})" for v in failed))
        _log.info("cascade live: band %.4g around thresholds %s (%s)",
                  self.band, self.thresholds,
                  ", ".join(f"{v.name}={'skip' if v.skipped else 'pass'}"
                            for v in verdicts))
        return verdicts
