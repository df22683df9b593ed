"""Train and evaluate entry functions of the port (counterpart of
``jama16_retina_tpu/trainer.py``).

``fit`` is the reference's single-model loop: the train stream of a
TFRecord ``train`` split (``data/pipeline.train_batches``; under
``data.loader=hbm`` the split resident on the card,
``data/hbm_pipeline.train_batches``; under ``tiered`` or ``rawshard`` the
rows the budget admits resident and the rest streamed,
``data/tiered_pipeline.py`` and ``data/rawshard.py``; under ``grain`` the
reference's grain order and iterator, ``data/grain_pipeline.py``) through
``train_lib.train_step``; every ``train.eval_every`` steps and at the last
step, the val AUC of the eval params, best/``min_delta``/patience
tracking and early stopping, and a checkpoint (``utils/checkpoint``:
``best/`` by val AUC, ``latest/`` for resume); ``train.resume`` continues
exactly where the run stopped (under ``grain`` with
``data.grain_workers``, from the iterator state each save persists as
``grain_state/<step>.json``). ``<workdir>/metrics.jsonl`` carries the
reference's records (``config``, ``train``, ``eval``, ``early_stop``,
``resume``) with its keys, and ``run_meta.json`` pins the seed.
``fit_ensemble`` trains k seeded members one after another;
``evaluate_checkpoints`` scores member checkpoints (averaged in float64)
on a split and reports AUC and the operating points, as the reference's
evaluate does.

With ``train.distill_from`` both fits distill: the teacher's members
are restored once onto the fit's device, each batch's clean uint8 images
are scored through them in eval mode (the plain normalize, as the
reference's teacher normalizes), and their float32 average rides the
batch under ``"soft"``, which ``train_lib.loss_fn`` trains against.

Both fits wire the ``obs`` planes as the reference's loops do: the
process registry and tracer are run-scoped at the start
(``_obs_begin_run``), the ``StallClock`` feeds the ``train`` records'
``*_sec`` fields and the ``trainer.*`` histograms and timeline, a
``Snapshotter`` writes ``telemetry`` and ``heartbeat`` records and
``telemetry.prom`` into the run's workdir with the alert rules the config
implies, and a ``FlightRecorder`` watches each step's time and loss and
dumps a blackbox on an exception or a signal (SIGTERM becomes a
``SystemExit``, so it takes the preemption save). ``train.profile_steps``
opens a ``torch.profiler`` window (``_ProfilerWindow``),
``train.tensorboard`` mirrors the records into ``<workdir>/tb`` and
``train.debug`` runs each step under autograd's anomaly mode.

``fit_synthetic`` is the in-memory form: ``train.steps`` steps on rendered
fundus images held on the device, the eval params written as a member dir
(``<workdir>/params.npz``). It times the step without the input stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time

import numpy as np
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch import train_lib
from jama16_retina_tpu_torch.data import (augment, grain_pipeline,
                                          hbm_pipeline, pipeline, rawshard,
                                          synthetic, tfrecord,
                                          tiered_pipeline)
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.models import convert, init
from jama16_retina_tpu_torch.obs import alerts as obs_alerts
from jama16_retina_tpu_torch.obs import export as obs_export
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import flightrec as obs_flightrec
from jama16_retina_tpu_torch.obs import quality as quality_lib
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace
from jama16_retina_tpu_torch.obs.spans import StallClock
from jama16_retina_tpu_torch.parallel import mesh as mesh_lib
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import RunLog, read_jsonl

_log = logging.getLogger(__name__)

METRICS_FILE = "metrics.jsonl"
# make_dataset seed of the train split (train.py --synthetic writes its
# train split with seed 1).
TRAIN_SPLIT_SEED = 1


def batch_indices(n: int, batch_size: int, steps: int,
                  seed: int) -> np.ndarray:
    """[steps, batch_size] example indices: consecutive batches of one
    seeded permutation of ``range(n)`` per epoch, epochs concatenated."""
    need = steps * batch_size
    epochs = -(-need // n)
    order = np.concatenate([
        np.random.default_rng([seed, e]).permutation(n)
        for e in range(epochs)])
    return order[:need].reshape(steps, batch_size)


def _distill_teacher(cfg: configs.ExperimentConfig, dev: torch.device):
    """The teacher of ``train.distill_from`` (the reference's
    ``_distill_stream``): every member under it restored once onto
    ``dev`` as an fp32 engine with no monitor. Returns uint8 images
    [B, S, S, 3] on ``dev`` -> float32 soft targets [B] (or [B, C]), the
    members' eval-mode probabilities of the plain-normalized images
    averaged in float64 (``metrics.ensemble_average``)."""
    dirs = ckpt_lib.discover_member_dirs(cfg.train.distill_from)
    teacher_cfg = cfg.replace(
        serve=configs.ServeConfig(),
        obs=dataclasses.replace(cfg.obs, enabled=False))
    engine = ServingEngine(
        teacher_cfg, state_dicts=[restore_for_eval(cfg, d) for d in dirs],
        device=dev, registry=obs_registry.Registry(), faults=False)
    _log.info("distilling from %d teacher member(s) under %s", len(dirs),
              cfg.train.distill_from)

    def soft(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            member = engine.forward_normalized(
                augment.normalize(images).permute(0, 3, 1, 2))
        return member.double().mean(dim=0).float()

    return soft


def fit_synthetic(cfg: configs.ExperimentConfig, workdir: str,
                  n_synthetic: int,
                  device: "str | torch.device | None" = None) -> dict:
    """Train on ``n_synthetic`` rendered fundus images held on the device;
    returns the run's results (steps, last loss, member dir, wall time,
    images per second, device). One process: refused under a launch of
    several ranks."""
    dev = device_lib.resolve(device)
    _refuse_ranks("fit_synthetic (the in-memory fit)")
    configs.validate_train_knobs(cfg.train)
    configs.check_supported(cfg, training=True)
    if n_synthetic < 1:
        raise ValueError(f"need at least one synthetic image, got "
                         f"{n_synthetic}")
    tc = cfg.train
    images, grades = synthetic.make_dataset(
        n_synthetic, synthetic.SynthConfig(image_size=cfg.model.image_size),
        seed=TRAIN_SPLIT_SEED)
    images = torch.from_numpy(images).to(dev)
    grades = torch.from_numpy(grades).to(dev)
    order = torch.from_numpy(batch_indices(
        n_synthetic, cfg.data.batch_size, tc.steps, tc.seed)).to(dev)
    model = init.init_flax_default(models.build(cfg.model), tc.seed)
    state = train_lib.create_state(cfg, model, dev)
    if tc.init_from:
        _warm_start_state(cfg, state, tc.init_from)
    teacher = _distill_teacher(cfg, dev) if tc.distill_from else None

    os.makedirs(workdir, exist_ok=True)
    losses = {}
    t0 = time.perf_counter()
    with open(os.path.join(workdir, METRICS_FILE), "a") as log:
        for i in range(tc.steps):
            idx = order[i]
            batch = {"image": images[idx], "grade": grades[idx]}
            if teacher is not None:
                batch["soft"] = teacher(batch["image"])
            loss = train_lib.train_step(state, batch, cfg)
            if (i + 1) % tc.log_every == 0:
                losses[i + 1] = float(loss)
                log.write(json.dumps({"kind": "train",
                                      "t": round(time.time(), 3),
                                      "step": i + 1,
                                      "loss": losses[i + 1]}) + "\n")
                log.flush()
        last = float(loss) if tc.steps else float("nan")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    ckpt_lib.save_member(workdir,
                         convert.torch_to_flax(train_lib.eval_params(state)))
    return {
        "steps": state.step,
        "final_loss": last,
        "logged_losses": losses,
        "member_dir": workdir,
        "train_sec": seconds,
        "images_per_sec": tc.steps * cfg.data.batch_size / seconds,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def _binary_eval_labels(grades: np.ndarray, head: str) -> np.ndarray:
    """evaluation_report's labels: grade >= 2 for the binary head, the raw
    grades for the 5-class head."""
    return (grades >= 2).astype(np.float64) if head == "binary" else grades


def _referable(probs: np.ndarray, head: str) -> np.ndarray:
    """P(referable DR) of a head's probabilities: themselves for the
    binary head, P(grade >= 2) for the 5-class head."""
    return (probs if head == "binary"
            else metrics.referable_probs_from_multiclass(probs))


def _cache_upload(images: np.ndarray, dev: torch.device) -> tuple:
    """An eval batch's images on the device, and on the card the event
    recorded after the copy on the stream that made it (None on the
    CPU)."""
    t = torch.from_numpy(images).to(dev)
    if dev.type != "cuda":
        return t, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return t, event


def _cache_ready(images: torch.Tensor, event, dev: torch.device
                 ) -> torch.Tensor:
    """A cached batch made ready for the current stream: the stream waits
    on the copy's event (the cache may have been filled by another
    thread's stream: an overlapped eval), and the allocator is told the
    stream reads it."""
    if event is not None:
        current = torch.cuda.current_stream(dev)
        current.wait_event(event)
        images.record_stream(current)
    return images


def predict_split(cfg: configs.ExperimentConfig, member_probs_fn,
                  data_dir: str, split: str, cache: "list | None" = None,
                  device: "str | torch.device | None" = None,
                  mesh: "mesh_lib.Mesh | None" = None
                  ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """The eval stream of ``split`` (no augmentation) through
    ``member_probs_fn(images) -> [k, B]`` (or [k, B, C]) probabilities,
    padding rows trimmed by the batches' mask -> (grades [n], probs [k, n]
    or [k, n, C], names [n]; names are the records' ``image/name``
    bytes).

    ``cache`` (from ``_eval_cache_for``): one list across repeated evals
    of a split keeps its batches on ``device`` between them. The first
    call fills it with each batch's images, uploaded once, and its kept
    grades, names and mask; later calls score those tensors and skip the
    re-read and re-upload. The probabilities are the streamed ones: the
    same rows go through the same forward.

    ``eval.sharded`` reads the split through
    ``pipeline.eval_batches_sharded`` (each rank decodes every P-th
    record; the grades and names come in the assembled order). Under a
    data mesh of more than one rank each batch's ``images`` are this
    rank's block, and ``member_probs_fn`` returns the whole batch's
    probabilities on every rank (``train_lib.make_eval_step``)."""
    dev = None if cache is None else device_lib.resolve(device)
    procs = ({} if mesh is None else
             {"process_index": mesh.rank, "process_count": mesh.size})
    read = (pipeline.eval_batches_sharded if cfg.eval.sharded
            else pipeline.eval_batches)

    def batches():
        """(images, kept grades, kept names, keep) per batch: from the
        cache, or read (and, with a cache, uploaded and kept once the
        whole split has been read)."""
        if cache:
            for images, event, grades, names, keep in cache:
                yield _cache_ready(images, event, dev), grades, names, keep
            return
        filled = []
        for batch in read(data_dir, split, cfg.eval.batch_size,
                          cfg.model.image_size, **procs):
            keep = batch["mask"] > 0
            row = (batch["image"], batch["grade"][keep], batch["name"][keep],
                   keep)
            if cache is not None:
                images, event = _cache_upload(batch["image"], dev)
                filled.append((images, event, *row[1:]))
                row = (_cache_ready(images, event, dev), *row[1:])
            yield row
        if cache is not None:
            cache.extend(filled)

    grades_all, probs_all, names_all = [], [], []
    for images, grades, names, keep in batches():
        probs = np.asarray(member_probs_fn(images))
        grades_all.append(grades)
        probs_all.append(probs[:, keep])
        names_all.append(names)
    return (np.concatenate(grades_all), np.concatenate(probs_all, axis=1),
            np.concatenate(names_all))


def _eval_cache_bytes(cfg: configs.ExperimentConfig, data_dir: str,
                      split: str) -> int:
    """Device bytes an eval cache of ``split`` holds: batches are padded
    to ``eval.batch_size``, so ceil(n / B) * B rows."""
    n = tfrecord.count_records(tfrecord.list_split(data_dir, split))
    b = cfg.eval.batch_size
    return -(-n // b) * b * cfg.model.image_size ** 2 * 3


def _eval_cache_for(cfg: configs.ExperimentConfig, data_dir: str,
                    split: str, reserved_bytes: int = 0,
                    device: "str | torch.device | None" = None
                    ) -> "list | None":
    """A device-resident eval-batch cache (a list to share across evals),
    or None: only under the loaders that keep train rows on the card
    (``hbm``, ``tiered``, ``rawshard``), and only while all caches together
    (``reserved_bytes`` holds those already admitted) stay within 10 % of
    the budget (``hbm_pipeline.hbm_budget_bytes``); an oversized split is
    logged and streamed."""
    if cfg.data.loader not in ("hbm", "tiered", "rawshard"):
        return None
    split_bytes = _eval_cache_bytes(cfg, data_dir, split)
    budget = hbm_pipeline.hbm_budget_bytes(
        budget_base_bytes=cfg.data.hbm_budget_bytes, device=device)
    if reserved_bytes + split_bytes <= 0.1 * budget:
        return []
    _log.warning(
        "%s split (%.1f MB + %.1f MB already cached) exceeds 10%% of the "
        "HBM budget; evals stream from host instead of caching "
        "device-resident", split, split_bytes / 1e6, reserved_bytes / 1e6)
    return None


def _emit_quality_profile(cfg: configs.ExperimentConfig, data_dir: str,
                          predict_fn, log: RunLog, write: bool = True
                          ) -> None:
    """The end-of-fit reference profile at ``obs.quality.profile_out``
    (the reference's ``_emit_quality_profile``): ``predict_fn() ->
    (grades, probs)`` scores the val split with the final state, and the
    profile holds its score histogram, input-statistic histograms, base
    rate and operating thresholds (none when val has one class). Every
    rank of a mesh predicts (the eval's collectives need them all); only
    the one that ``write``s builds and saves the profile."""
    path = cfg.obs.quality.profile_out
    grades, probs = predict_fn()
    if not write:
        return
    bin_labels = (grades >= 2).astype(np.float64)
    scores = np.asarray(_referable(probs, cfg.model.head), np.float64)
    thresholds: list = []
    if 0.0 < bin_labels.mean() < 1.0:
        thresholds = [
            metrics.sensitivity_at_specificity(bin_labels, scores,
                                               s).as_dict()
            for s in cfg.eval.operating_specificities]
    stats = quality_lib.split_input_stats(
        data_dir, "val", cfg.eval.batch_size, cfg.model.image_size)
    profile = quality_lib.build_profile(
        scores, labels=bin_labels, stat_values=stats, thresholds=thresholds,
        bins=cfg.obs.quality.score_bins,
        meta={"config": cfg.name, "split": "val",
              "source": "trainer_end_of_fit"})
    quality_lib.save_profile(path, profile)
    log.write("quality_profile", path=path, n_examples=profile["n_examples"])


def _best_tracking_update(aucs, best_auc, best_step, since_best, step: int,
                          min_delta: float):
    """The best/min_delta/patience rule, vectorized over any number of
    models: an AUC above the best by more than ``min_delta`` becomes the
    best and resets patience; any other AUC adds one to it."""
    improved = np.asarray(aucs) > np.asarray(best_auc) + min_delta
    return (
        np.where(improved, aucs, best_auc),
        np.where(improved, step, best_step),
        np.where(improved, 0, np.asarray(since_best) + 1),
    )


def _check_ema_compat(ckpt: ckpt_lib.Checkpointer,
                      cfg: configs.ExperimentConfig, where: str,
                      step: "int | None" = None) -> None:
    """Resume must continue the same optimization: a checkpoint trained
    with the EMA shadow on (off) under a config with it off (on) raises
    (None = metadata unreadable: the guard is skipped)."""
    has_ema = ckpt.saved_with_ema(step)
    if has_ema is not None and has_ema != (cfg.train.ema_decay > 0):
        raise ValueError(
            f"checkpoint in {where} was trained with ema "
            f"{'on' if has_ema else 'off'} but this run sets "
            f"train.ema_decay={cfg.train.ema_decay} — resume with a "
            "matching config")


def _reconstruct_best_tracking(workdir: str, start_step: int,
                               cfg: configs.ExperimentConfig,
                               ckpt: ckpt_lib.Checkpointer):
    """(best_auc, best_step, since_best) of one model as of
    ``start_step``, for resume (``_reconstruct_member_tracking`` with one
    member)."""
    best_auc, best_step, since_best = _reconstruct_member_tracking(
        workdir, start_step, cfg, [ckpt])
    return float(best_auc[0]), int(best_step[0]), int(since_best[0])


def _reconstruct_member_tracking(workdir: str, start_step: int,
                                 cfg: configs.ExperimentConfig, ckpts: list):
    """Per-member (best_auc, best_step, since_best) arrays as of
    ``start_step``, for resume: the run's own eval history
    (``metrics.jsonl``: ``val_auc_per_member`` of k members, or
    ``val_auc`` of one; the first eval record per step at step <=
    start_step) replayed through ``_best_tracking_update``, so a resumed
    run stops exactly when an uninterrupted one would. Without a history,
    each checkpoint's best (step, val AUC), with patience from the eval
    cadence."""
    k = len(ckpts)
    best_auc = np.full((k,), -np.inf)
    best_step = np.zeros((k,), np.int64)
    since_best = np.zeros((k,), np.int64)
    path = os.path.join(workdir, METRICS_FILE)
    kept: dict = {}
    if os.path.exists(path):
        for r in read_jsonl(path):
            if r.get("kind") != "eval" or r.get("step", 0) > start_step:
                continue
            if len(r.get("val_auc_per_member", ())) == k:
                aucs = r["val_auc_per_member"]
            elif "val_auc" in r and k == 1:
                aucs = [r["val_auc"]]
            else:
                continue
            s = r["step"]
            if s not in kept:
                kept[s] = aucs
            elif not np.allclose(kept[s], aucs, atol=1e-9, equal_nan=True):
                _log.warning(
                    "metrics.jsonl holds disagreeing duplicate eval records "
                    "at step %d (%s vs %s); replaying the first — best/"
                    "patience reconstruction may not match the restored "
                    "state", s, kept[s], aucs)
    if kept:
        for step, aucs in kept.items():
            best_auc, best_step, since_best = _best_tracking_update(
                aucs, best_auc, best_step, since_best, step,
                cfg.train.min_delta)
        return best_auc, best_step, since_best
    for m, ckpt in enumerate(ckpts):
        info = ckpt.best_info()
        if info is not None:
            best_step[m], best_auc[m] = info
            since_best[m] = max(
                0, (start_step - info[0]) // cfg.train.eval_every)
    return best_auc, best_step, since_best


def _save_due(cfg: configs.ExperimentConfig, step: int) -> bool:
    """Is this eval's checkpoint due under ``train.save_every_evals``? The
    phase comes from the step ordinal (step // eval_every), so resume
    keeps the cadence. The last step is always due, and so is the first
    eval (ordinal 1) under ``train.save_first_eval``."""
    if step >= cfg.train.steps:
        return True
    n = max(1, cfg.train.save_every_evals)
    ordinal = step // cfg.train.eval_every
    if cfg.train.save_first_eval and ordinal == 1:
        return True
    return ordinal % n == 0


def _eval_and_track(cfg: configs.ExperimentConfig, log: RunLog, step: int,
                    predict_fn, save_fn, best_auc: float, best_step: int,
                    since_best: int, save_due: bool,
                    curve_gate: "_DtypeCurveGate | None" = None):
    """One eval interval: val predict -> referable-DR AUC -> best and
    ``min_delta`` tracking -> early-stop decision -> checkpoint through
    ``save_fn(step, val_auc)`` when ``save_due``. The eval record is
    written before the save; a stopping eval always saves. ``curve_gate``
    is checked after the eval record (the refused trajectory stays in the
    log) and before any save (a drifted state never becomes a resume
    point). Returns (best_auc, best_step, since_best, stop)."""
    grades, probs = predict_fn()
    auc = metrics.roc_auc((grades >= 2).astype(np.float64),
                          _referable(probs, cfg.model.head))
    b_auc, b_step, since = _best_tracking_update(
        auc, best_auc, best_step, since_best, step, cfg.train.min_delta)
    best_auc, best_step, since_best = float(b_auc), int(b_step), int(since)
    # val_auc at full precision: resume replays it (best_auc is display).
    log.write("eval", step=step, val_auc=float(auc),
              best_auc=round(best_auc, 5), since_best=since_best)
    if curve_gate is not None:
        curve_gate.check(step, float(auc))
    stop = since_best >= cfg.train.early_stop_patience
    if save_due or stop:
        save_fn(step, float(auc))
    if stop:
        log.write("early_stop", step=step, best_step=best_step)
    return best_auc, best_step, since_best, stop


def _load_curve_ref(path: str, knob: str) -> dict:
    """step -> pinned val AUC of a ``metrics.jsonl`` curve (the first
    eval record per step); missing or empty files raise, naming the
    knob."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{knob} {path!r} does not exist: pin a reference run's "
            "metrics.jsonl (or unset the knob to run ungated)")
    ref: dict = {}
    for r in read_jsonl(path):
        if r.get("kind") != "eval" or r.get("step") is None:
            continue
        auc = r.get("ensemble_val_auc", r.get("val_auc"))
        if auc is not None and int(r["step"]) not in ref:
            ref[int(r["step"])] = float(auc)
    if not ref:
        raise ValueError(f"{knob} {path!r} holds no eval records: point it "
                         "at the reference run's metrics.jsonl")
    return ref


class _DtypeCurveGate:
    """The reference's golden-curve gate, with its two arms:

    - dtype: a ``train.dtype=bf16`` run with ``train.dtype_curve_ref``
      must keep each eval's val AUC within ``train.dtype_curve_tol`` of
      the pinned fp32 curve at the same step, or ``check`` raises
      ``train_lib.DtypeCurveRejected``;
    - recipe: a large-batch recipe run (``train.optimizer=lamb`` or
      ``train.lr_scale_ref_batch`` > 0) with ``train.recipe_curve_ref``
      must keep within ``train.recipe_curve_tol`` of the pinned baseline
      curve, or ``check`` raises ``train_lib.RecipeCurveRejected``.

    Both arms can gate one run (a bf16 LAMB run checks both curves at
    every eval); fp32 and baseline runs never gate; a bf16 or recipe run
    without its ref logs that it runs ungated."""

    def __init__(self, cfg: configs.ExperimentConfig):
        tc = cfg.train
        # [(step -> auc, tol, exception, what drifted, the remedy)]
        self._arms: list = []
        if tc.dtype != "fp32":
            if tc.dtype_curve_ref:
                self._arms.append((
                    _load_curve_ref(tc.dtype_curve_ref,
                                    "train.dtype_curve_ref"),
                    tc.dtype_curve_tol, train_lib.DtypeCurveRejected,
                    f"train.dtype={tc.dtype} drifted from the pinned fp32 "
                    "golden curve",
                    "the cheap numerics mode is refused: retrain in fp32 "
                    "or widen train.dtype_curve_tol deliberately"))
            else:
                _log.warning(
                    "train.dtype=%s runs UNGATED: no train.dtype_curve_ref "
                    "golden curve is pinned; eval-AUC parity with fp32 is "
                    "not being checked", tc.dtype)
        if tc.optimizer == "lamb" or tc.lr_scale_ref_batch > 0:
            if tc.recipe_curve_ref:
                self._arms.append((
                    _load_curve_ref(tc.recipe_curve_ref,
                                    "train.recipe_curve_ref"),
                    tc.recipe_curve_tol, train_lib.RecipeCurveRejected,
                    f"the {tc.optimizer} large-batch recipe drifted from the "
                    "pinned baseline golden curve",
                    "the recipe is refused: rebaseline or widen "
                    "train.recipe_curve_tol deliberately"))
            else:
                _log.warning(
                    "large-batch recipe (optimizer=%s, lr_scale_ref_batch="
                    "%d) runs UNGATED: no train.recipe_curve_ref golden curve "
                    "is pinned; eval-AUC parity with the baseline recipe is "
                    "not being checked", tc.optimizer, tc.lr_scale_ref_batch)

    def check(self, step: int, auc: float) -> None:
        for ref_map, tol, exc, what, remedy in self._arms:
            ref = ref_map.get(int(step))
            if ref is None or abs(float(auc) - ref) <= tol:
                continue
            raise exc(
                f"{what} at step {step}: val AUC {float(auc):.5f} vs pinned "
                f"{ref:.5f} (|delta|={abs(float(auc) - ref):.5f} > "
                f"tol={tol}); {remedy}")


class _BgJob:
    """One background eval job (``train.eval_overlap``): ``fn`` runs on a
    daemon thread; ``result()`` joins it and re-raises its exception in
    the caller, so an early stop or a ``DtypeCurveRejected`` still stops
    the run, at the next collection point."""

    def __init__(self, fn):
        self._fn = fn
        self._result = None
        self._err: "BaseException | None" = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="eval-overlap")
        self._thread.start()

    def _run(self) -> None:
        try:
            self._result = self._fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in result()
            self._err = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._result


def _preempt_save(log: RunLog, step: int, save_fn,
                  grain_tee: "_GrainStateTee | None" = None,
                  workdir: str = "") -> None:
    """The preemption save: ``save_fn(step)`` writes ``latest/`` at the
    last completed step (returning whether it wrote), and the worker-mode
    grain state for that step, then a ``preempt_save`` record. A failing
    save is logged and does not mask the exit that is already under
    way."""
    try:
        saved = save_fn(step)
        _persist_grain_state(grain_tee, workdir, step)
        log.write("preempt_save", step=step, saved=bool(saved))
        _log.warning("preemption: saved resume checkpoint at step %d "
                     "(train.resume=true continues here)", step)
    except Exception as e:  # noqa: BLE001 - the exit path must proceed
        _log.error("preemption save at step %d failed: %s: %s; resume will "
                   "fall back to the last eval-time checkpoint", step,
                   type(e).__name__, e)


def _warm_start_state(cfg: configs.ExperimentConfig,
                      state: train_lib.TrainState,
                      init_from: str) -> train_lib.TrainState:
    """Seed a fresh step-0 ``state`` in place from the donor under
    ``init_from`` (a fit workdir's best step, or a member dir): its params
    and batch statistics, and, when this run carries an EMA shadow, the
    donor's shadow (its params when it carried none). Moments, counts
    and schedule stay fresh. An architecture mismatch raises."""
    donor, donor_ema = ckpt_lib.load_donor(init_from)
    model = state.model
    with torch.no_grad():
        model.load_state_dict(convert.flax_to_torch(donor, model))
        if state.ema is not None:
            ema = convert.flax_to_torch({**donor, **(donor_ema or {})},
                                        model)
            for k in state.ema:
                state.ema[k].copy_(ema[k])
    return state


def _stream_context(dev: torch.device):
    """A side stream for a background job on the card (its kernels then
    interleave with the step's instead of queueing behind them); nothing
    on the CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(dev))


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

class _ThroughputClock:
    """Images/s per log window (``images_per_sec_window``) and over all
    train time so far (``images_per_sec_avg``). The clocks restart after
    the first step (the warm-up: kernel builds, cuDNN plans) and after
    every eval pause, so neither folds them in."""

    def __init__(self, batch_size: int):
        now = time.time()
        self._batch = batch_size
        self._first_done = False
        self._t_window = now
        self._imgs_window = 0
        self._t_resume = now
        self._train_time = 0.0
        self._imgs_avg = 0

    def after_step(self) -> None:
        if not self._first_done:
            self._first_done = True
            now = time.time()
            self._t_window = now
            self._t_resume = now
            return
        self._imgs_window += self._batch
        self._imgs_avg += self._batch

    def pause(self) -> None:
        self._train_time += time.time() - self._t_resume

    def resume(self) -> None:
        now = time.time()
        self._t_resume = now
        self._t_window = now
        self._imgs_window = 0

    def fields(self) -> dict:
        now = time.time()
        out = {"images_per_sec_window": round(
            self._imgs_window / max(now - self._t_window, 1e-9), 2)}
        train_time = self._train_time + (now - self._t_resume)
        if self._imgs_avg > 0:
            out["images_per_sec_avg"] = round(
                self._imgs_avg / max(train_time, 1e-9), 2)
        self._t_window = now
        self._imgs_window = 0
        return out


def _obs_begin_run(cfg: configs.ExperimentConfig) -> obs_registry.Registry:
    """Run-scope the process registry and tracer (the reference's
    ``_obs_begin_run``): this run's ``obs.enabled`` and trace knobs, every
    metric zeroed in place and every ring cleared, before the stream
    registers its metrics, so members fit one after another in one
    process do not carry each other's counts or events. Then the fault
    plan is armed (``faultinject.arm_from_env_or_config``): the
    ``JAMA16_FAULTS`` variable wins, then ``obs.fault_plan``; with
    neither, a plan armed by the caller stays armed. It runs before the
    resume restore, so the restore's seam and retry counts belong to the
    run."""
    reg = obs_registry.default_registry()
    reg.enabled = cfg.obs.enabled
    reg.reset()
    obs_trace.default_tracer().configure(
        enabled=cfg.obs.enabled and cfg.obs.trace_enabled,
        buffer_events=cfg.obs.trace_buffer_events)
    faultinject.arm_from_env_or_config(cfg.obs.fault_plan)
    return reg


def _load_restored(state: train_lib.TrainState, ckpt: ckpt_lib.Checkpointer,
                   step: int) -> train_lib.TrainState:
    """``load_state_flat`` of ``ckpt``'s step ``step``: a saved state
    missing a leaf, or holding one of another shape, raises
    ``CheckpointError`` naming the directory and the step."""
    flat = ckpt.restore(step)
    try:
        return train_lib.load_state_flat(state, flat)
    except (KeyError, RuntimeError) as e:
        raise ckpt.unreadable(step, e) from e


def _telemetry_for(cfg: configs.ExperimentConfig, log: RunLog, workdir: str,
                   flight=None):
    """(registry, StallClock, Snapshotter or None) of one train loop. The
    stall clock feeds the ``trainer.*`` histograms only when obs is on;
    the snapshotter writes into the run's own RunLog, with the alert rules
    the config implies wired to the run's flight recorder."""
    reg = obs_registry.default_registry()
    stalls = StallClock(reg if cfg.obs.enabled else None)
    snap = None
    if cfg.obs.enabled:
        rules = (obs_alerts.quality_rules(cfg.obs.quality)
                 + obs_alerts.reliability_rules(cfg))
        alerts = (obs_alerts.AlertManager(rules, registry=reg, flight=flight)
                  if rules else None)
        snap = obs_export.Snapshotter(reg, workdir, runlog=log,
                                      every_s=cfg.obs.flush_every_s,
                                      alerts=alerts)
    return reg, stalls, snap


def _flight_for(cfg: configs.ExperimentConfig, workdir: str,
                profiler: "_ProfilerWindow | None" = None):
    """The run's FlightRecorder, or None when obs is off: dumps carry this
    run's config, and the anomaly capture goes through the run's
    ``_ProfilerWindow``."""
    if not cfg.obs.enabled:
        return None
    slow = cfg.obs.slow_step_factor
    return obs_flightrec.FlightRecorder(
        workdir, config=dataclasses.asdict(cfg),
        registry=obs_registry.default_registry(),
        tracer=obs_trace.default_tracer(),
        blackbox_events=cfg.obs.blackbox_events,
        slow_step_factor=(slow if slow > 0 else float("inf")),
        profile_hook=(profiler.arm if profiler is not None else None),
        blackbox_keep=cfg.obs.blackbox_keep,
        diagnosis=cfg.obs.diagnosis_enabled,
        diagnosis_top_k=cfg.obs.diagnosis_top_k)


def _start_trace(dev: torch.device):
    """A running ``torch.profiler`` session (host and, on the card, CUDA
    activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_trace(prof, path: str, dev: torch.device) -> None:
    """Synchronize the device (the reference's ``block_until_ready``), stop
    the session and write its Chrome trace to ``path``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


class _ProfilerWindow:
    """The ``torch.profiler`` capture window of both train loops (the
    reference's ``_ProfilerWindow``), opened two ways:

      * ``train.profile_steps`` > 0: planned at construction, starting 10
        steps in when the run is long enough, clamped inside a short run,
        a ``profile_skipped`` record when none fits;
      * ``arm(n)``: a capture of n steps from the next step, the flight
        recorder's hook on a NaN or slow step; refused while a capture is
        open or another is pending.

    A capture lands in ``<workdir>/profile/steps_<a>-<b>.pt.trace.json``
    (Chrome trace) with a ``profile`` record; ``finalize`` closes one left
    open (``steps: "truncated"``), so no session leaks into the next fit.
    Do not open one inside another ``torch.profiler`` session."""

    def __init__(self, cfg: configs.ExperimentConfig, log: RunLog,
                 workdir: str, start_step: int,
                 dev: "str | torch.device"):
        self._dir = os.path.join(workdir, "profile")
        self._steps = cfg.train.profile_steps
        self._log = log
        self._dev = torch.device(dev)
        self._start, self._stop = -1, -1
        self._prof = None
        self._opened_at = -1
        self._seen = start_step  # the newest step begun
        self._fixed_done = False
        self._arm = 0
        self._n_capture = 0
        self._trigger: "str | None" = None
        if self._steps > 0:
            remaining = cfg.train.steps - start_step
            if remaining < self._steps:
                log.write("profile_skipped", reason=(
                    f"only {remaining} steps remain, profile_steps="
                    f"{self._steps} does not fit"))
            else:
                self._start = min(start_step + 10,
                                  cfg.train.steps - self._steps)
                self._stop = self._start + self._steps

    @property
    def _tracing(self) -> bool:
        return self._prof is not None

    def arm(self, steps: int = 5) -> bool:
        if self._tracing or self._arm > 0:
            return False
        self._arm = max(1, int(steps))
        return True

    def _open(self, step_i: int, n: int, trigger: "str | None") -> None:
        self._prof = _start_trace(self._dev)
        self._opened_at = step_i
        self._stop = step_i + n
        self._n_capture = n
        self._trigger = trigger

    def _close(self, last_step: int) -> None:
        prof, self._prof = self._prof, None
        _stop_trace(prof, os.path.join(
            self._dir, f"steps_{self._opened_at}-{last_step}.pt.trace.json"),
            self._dev)

    def before_step(self, step_i: int) -> None:
        self._seen = step_i
        # The planned window opens at the first free step boundary at or
        # after its start: an anomaly capture open then defers it.
        if (self._start >= 0 and step_i >= self._start
                and not self._fixed_done and not self._tracing):
            self._fixed_done = True
            self._open(step_i, self._steps, None)
        elif self._arm > 0 and not self._tracing:
            n, self._arm = self._arm, 0
            self._open(step_i, n, "anomaly")

    def after_step(self, step_i: int) -> None:
        if self._tracing and step_i + 1 >= self._stop:
            self._close(step_i)
            extra = {"trigger": self._trigger} if self._trigger else {}
            self._log.write("profile", dir=self._dir, steps=self._n_capture,
                            **extra)

    def finalize(self) -> None:
        if self._tracing:
            self._close(self._seen)
            self._log.write("profile", dir=self._dir, steps="truncated")


def _debug_step(step_fn, step: int):
    """One step under ``train.debug``, the counterpart of the reference's
    ``jax_debug_nans``: the step runs under autograd's anomaly mode with
    its NaN check, the prior mode restored after; a NaN in the backward,
    or a non-finite loss from the forward, raises ``FloatingPointError``
    naming the step. The loss check reads the loss, so a debug step
    synchronizes the device."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        loss = step_fn()
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        raise FloatingPointError(
            f"train.debug: invalid value (nan) in the backward of step "
            f"{step}: {e}") from e
    finally:
        torch.autograd.set_detect_anomaly(*prev)
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(
            f"train.debug: invalid value in the loss of step {step}: "
            f"{loss.detach().cpu().tolist()}")
    return loss


def _load_or_write_run_meta(workdir: str, seed: int, cfg_name: str,
                            resume: bool) -> int:
    """The seed of the run: on resume the one ``run_meta.json`` pinned
    (the stream and every step's draws are functions of it); otherwise the
    requested one, written to ``run_meta.json``."""
    path = os.path.join(workdir, "run_meta.json")
    if resume and os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
        if int(meta.get("seed", seed)) != seed:
            _log.warning("resuming with run_meta seed %s (seed %s ignored "
                         "for stream continuity)", meta["seed"], seed)
        return int(meta.get("seed", seed))
    os.makedirs(workdir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"seed": seed, "config": cfg_name}, f)
    os.replace(tmp, path)
    return seed


class _GrainStateTee:
    """The grain iterator's state after every batch it produces, by
    batch ordinal. The prefetcher pulls the stream ahead of the step, so
    the iterator's own state at a save describes a later position; a
    checkpoint persists the state as of its step's batch. A ring of
    ``keep`` (at least 16) states, deeper than the prefetch lead."""

    def __init__(self, it, start_ordinal: int, keep: int = 16):
        self._it = it
        self._n = start_ordinal
        self._keep = max(16, keep)
        self._states: "dict[int, bytes]" = {}

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self._n += 1
        self._states[self._n] = self._it.get_state()
        self._states.pop(self._n - self._keep, None)
        return batch

    def state_after(self, ordinal: int) -> "bytes | None":
        return self._states.get(ordinal)

    def close(self) -> None:
        self._it.close()


def _grain_state_path(workdir: str, step: int) -> str:
    return os.path.join(workdir, "grain_state", f"{step}.json")


def _prune_grain_state(workdir: str, kept_steps: set,
                       protect_above: "int | None" = None) -> None:
    """Remove the grain states of steps whose checkpoints are gone.
    Steps above ``protect_above`` stay even when ``kept_steps`` lacks
    them (an async save may not be listed yet); None only where the newer
    states are the ones being purged (the torn-save rollback)."""
    d = os.path.join(workdir, "grain_state")
    if not os.path.isdir(d):
        return
    for name in os.listdir(d):
        stem, ext = os.path.splitext(name)
        if ext != ".json" or not stem.isdigit():
            continue
        s = int(stem)
        if s in kept_steps or (protect_above is not None
                               and s > protect_above):
            continue
        try:
            os.remove(os.path.join(d, name))
        except OSError:
            pass


def _persist_grain_state(tee: "_GrainStateTee | None", workdir: str,
                         step: int, kept_steps: "set | None" = None) -> None:
    """Write the worker-mode grain state for ``step`` beside its
    checkpoint (``grain_state/<step>.json``), then prune the states of
    steps retention has dropped (``kept_steps``: the checkpointer's live
    steps; ``step`` and anything newer than the newest listed step
    stay)."""
    if tee is None:
        return
    state = tee.state_after(step)
    if state is None:
        # Legitimate only at a resumed run's first save (no batch taken
        # yet); otherwise the ring was outrun.
        if step > tee._n - tee._keep:
            return
        _log.warning("grain state for step %d was evicted from the tee "
                     "ring (produced up to %d, keep=%d); this checkpoint "
                     "will not be worker-mode resumable", step, tee._n,
                     tee._keep)
        return
    os.makedirs(os.path.join(workdir, "grain_state"), exist_ok=True)
    path = _grain_state_path(workdir, step)
    with open(path + ".tmp", "wb") as f:
        f.write(state)
    os.replace(path + ".tmp", path)
    if kept_steps is not None:
        kept = set(kept_steps)
        _prune_grain_state(workdir, kept | {step},
                           protect_above=max(kept) if kept else -1)


def _load_grain_state(cfg: configs.ExperimentConfig, workdir: str,
                      start_step: int) -> "bytes | None":
    """The persisted worker-mode grain state of a resume, or None (then
    ``grain_pipeline.train_batches`` raises its ``NotImplementedError``
    for a worker-mode skip)."""
    if (cfg.data.loader != "grain" or cfg.data.grain_workers <= 0
            or start_step == 0):
        return None
    path = _grain_state_path(workdir, start_step)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _train_stream(cfg: configs.ExperimentConfig, data_dir: str, seed: int,
                  skip_batches: int, dev: torch.device, knobs=None,
                  grain_state: "bytes | None" = None,
                  mesh: "mesh_lib.Mesh | None" = None):
    """(stream, grain tee or None): the train batches of ``data.loader``
    on ``dev``, from batch ``skip_batches`` on (the reference's
    ``_train_stream``). ``tfdata``: the TFRecord stream read by
    ``data.readers`` processes and staged ``data.prefetch_batches`` ahead
    by ``pipeline.DevicePrefetch``. ``grain``: the grain loader's host
    batches (``grain_pipeline.train_batches``, ``data.grain_workers``
    worker processes, restored from ``grain_state`` or derived at
    ``skip_batches``), staged by ``DevicePrefetch`` as ``tfdata``'s are;
    with workers, through a ``_GrainStateTee`` whose states the saves
    persist. ``data.readers`` does nothing under grain.
    ``hbm``: batches gathered on the card from the resident split
    (``hbm_pipeline.train_batches``), on the consumer's current stream,
    the step's: they never pass the prefetcher's pinned host buffers.
    ``tiered`` / ``rawshard``: batches combined on the card from the
    resident rows and the streamed ones (``tiered_pipeline``,
    ``rawshard``), the streamed rows decoded on the step's thread and
    uploaded behind it, ``data.stage_depth`` batches ahead; as ``hbm``'s
    they skip the prefetcher (the reference also queues
    ``data.prefetch_batches`` of them: ROADMAP Queue C). ``data.readers``
    does nothing under these three loaders. ``knobs`` (``data.autotune``):
    the live decode workers and stage depth the tiered and rawshard
    loaders poll, and the prefetch depth the prefetcher polls. The stream has ``close()``.
    ``configs.check_supported`` has refused every other loader. Under a
    data mesh of more than one rank (``tfdata`` only,
    ``check_mesh_knobs``), the rank's block of each global batch,
    staged to the rank's device."""
    loader, size = cfg.data.loader, cfg.model.image_size
    if loader == "hbm":
        return hbm_pipeline.train_batches(
            data_dir, "train", cfg.data, size, seed=seed,
            skip_batches=skip_batches, device=dev), None
    if loader in ("tiered", "rawshard"):
        lib = tiered_pipeline if loader == "tiered" else rawshard
        return lib.train_batches(
            data_dir, "train", cfg.data, size, seed=seed,
            skip_batches=skip_batches, knobs=knobs, device=dev), None
    depth = cfg.data.prefetch_batches
    if loader == "grain":
        batches = tee = grain_pipeline.train_batches(
            data_dir, "train", cfg.data, size, seed=seed,
            skip_batches=skip_batches, worker_count=cfg.data.grain_workers,
            initial_state=grain_state)
        if cfg.data.grain_workers > 0:
            # Worker-mode positions have no (seed, step) closed form: each
            # checkpoint persists the state of its own step.
            batches = tee = _GrainStateTee(batches, skip_batches,
                                           keep=depth + 4)
        else:
            tee = None
        return pipeline.DevicePrefetch(batches, dev, depth,
                                       knobs=knobs), tee
    procs = ({} if mesh is None else
             {"process_index": mesh.rank, "process_count": mesh.size})
    # The prefetcher's thread runs whenever knobs are given (their depth
    # is at least 1), and then copies through its own pinned buffers.
    return pipeline.DevicePrefetch(pipeline.train_batches(
        data_dir, "train", cfg.data, size, seed=seed,
        skip_batches=skip_batches,
        pin_memory=dev.type == "cuda" and depth == 0 and knobs is None,
        readers=cfg.data.readers, **procs), dev, depth, knobs=knobs), None


def _autotune_for(cfg: configs.ExperimentConfig, dev: torch.device):
    """(knobs, tuner) when ``data.autotune`` is on, else (None, None).
    Built after ``_obs_begin_run`` (the tuner's metrics belong to the
    run) and before the stream (the loaders take the knobs at
    construction)."""
    if not cfg.data.autotune:
        return None, None
    from jama16_retina_tpu_torch.data import autotune as autotune_lib

    return autotune_lib.for_config(cfg, device=dev)


class _RankLog:
    """The run log of a rank other than 0 under a data mesh: records are
    made and logged at debug level, and nothing is written (rank 0 alone
    writes the run's files, as the reference's process 0 does)."""

    def write(self, kind: str, **fields) -> dict:
        _log.debug("%s %s", kind, fields)
        return {"kind": kind, "t": round(time.time(), 3), **fields}

    def close(self) -> None:
        pass


def check_mesh_knobs(cfg: configs.ExperimentConfig,
                     mesh: "mesh_lib.Mesh") -> None:
    """Refuse what one fit over more than one rank cannot honour: the
    background saves and evals (the reference's refusal: their state
    reads cannot join the ranks' collectives), and the forms of ROADMAP
    Queue A item 8, part 2."""
    if mesh.size <= 1:
        return
    tc = cfg.train
    if tc.async_save or tc.eval_overlap:
        raise ValueError(
            "train.async_save/train.eval_overlap run their state gathers on "
            "background threads and cannot participate in multi-host "
            "collectives — unset them on multi-process runs")
    for knob, on in (
            (f"train.accum_steps={tc.accum_steps}", tc.accum_steps > 1),
            (f"train.distill_from={tc.distill_from!r}", bool(tc.distill_from)),
            (f"data.loader={cfg.data.loader!r}", cfg.data.loader != "tfdata")):
        if on:
            raise NotImplementedError(
                f"{knob} across {mesh.size} ranks is not ported yet; see "
                f"ROADMAP.md {configs.MESH_PART_2}")


def _refuse_ranks(what: str) -> None:
    """``what`` runs one process: under a launch of several ranks each
    would train alone, so it is refused."""
    n = mesh_lib.process_count()
    if n > 1:
        raise NotImplementedError(
            f"{what} across {n} ranks is not ported yet; see ROADMAP.md "
            f"{configs.MESH_PART_2}")


def fit(cfg: configs.ExperimentConfig, data_dir: str, workdir: str,
        seed: "int | None" = None,
        device: "str | torch.device | None" = None) -> dict:
    """Train one model on ``<data_dir>/train-*.tfrecord`` with evals on
    ``val``; returns ``{'best_auc', 'best_step', 'stopped_early'}``
    (``best_auc`` None when no eval ran).

    The train stream is ``data.loader``'s (``_train_stream``): the
    TFRecord stream staged ``data.prefetch_batches`` ahead on the device,
    read by ``data.readers`` processes; the grain loader's batches, staged
    the same way (``grain``; with workers each save also writes the
    iterator state of its step, ``grain_state/<step>.json``, which a
    resume restores); the card-resident split (``hbm``); or the resident
    and streamed tiers (``tiered``, ``rawshard``). Under the last three the val batches also stay on the
    card between evals (``_eval_cache_for``), and ``data.autotune`` tunes
    the stream's timing knobs at every log boundary (``_autotune_for``).
    ``train.init_from`` warm-starts a fresh run from a donor
    (a resume that finds a checkpoint wins). ``train.async_save`` hands
    each save, from a device snapshot of the state, to one background
    writer; ``train.eval_overlap`` (which implies it) runs the whole eval
    block on a background thread from such a snapshot while training
    goes on, one eval in flight at a time, collected at the next step.
    A ``SystemExit``/``KeyboardInterrupt`` after at least one step saves
    ``latest/`` at the last completed step (``preempt_save``) and
    re-raises; one that lands inside a step, which updates the state in
    place, saves nothing (``saved=false``).

    Under a launch of several ranks (``parallel.num_devices``, the data
    mesh of ``parallel/mesh.py``), each rank trains one replica on its
    device from its block of every global batch: the state is made from
    the seed and broadcast from rank 0, the model's BatchNorms take the
    global batch's moments, and the gradients are averaged over the
    ranks each step (``train_lib.train_step``). Evals run on every rank,
    each scoring its rows (``eval.sharded``: decoding only its records),
    so every rank computes the same AUC and stops alike. Rank 0 alone
    writes the run's files (the log, checkpoints, TensorBoard, the obs
    planes' records), and the ranks meet after each save; a resume
    restores the same ``latest/`` on every rank. The knobs of
    ``check_mesh_knobs`` are refused."""
    mesh = mesh_lib.make_mesh(cfg.parallel.num_devices,
                              cfg.parallel.data_axis, device)
    configs.validate_train_knobs(cfg.train)
    configs.check_supported(cfg, training=True)
    check_mesh_knobs(cfg, mesh)
    multi = mesh.size > 1
    dev = mesh.device
    lead = mesh.rank == 0
    tc = cfg.train
    seed = tc.seed if seed is None else seed
    if lead:
        seed = _load_or_write_run_meta(workdir, seed, cfg.name, tc.resume)
    if multi:
        seed = int(mesh.broadcast_(torch.tensor(seed, device=dev)))
    # The step's augment and dropout draws are seeded by train.seed. The
    # large-batch rule scales the learning rate once, here, so a resume
    # derives the same rate.
    cfg = train_lib.resolve_large_batch(
        cfg.replace(train=dataclasses.replace(tc, seed=seed)), mesh)
    tc = cfg.train
    # What rank 0 alone writes: the log and the obs planes' records.
    quiet = cfg if lead else cfg.replace(
        obs=dataclasses.replace(cfg.obs, enabled=False),
        train=dataclasses.replace(tc, profile_steps=0))
    log = (RunLog(workdir, METRICS_FILE, tensorboard=tc.tensorboard,
                  fresh=not tc.resume) if lead else _RankLog())
    log.write("config", name=cfg.name, seed=seed, n_devices=mesh.size)
    curve_gate = _DtypeCurveGate(cfg)
    step_kw = {"mesh": mesh} if multi else {}

    state = train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model, mesh), seed),
        dev)
    mesh_lib.replicated(state, mesh)
    ckpt = ckpt_lib.Checkpointer(os.path.abspath(workdir),
                                 max_to_keep=tc.max_to_keep)
    start_step = 0
    best_auc, best_step, since_best = -np.inf, 0, 0
    _obs_begin_run(cfg)  # before the restore and the stream's metrics
    if tc.resume and ckpt.latest_step is not None:
        _check_ema_compat(ckpt, cfg, workdir, ckpt.latest_step)
        _load_restored(state, ckpt, ckpt.latest_step)
        start_step = state.step
        best_auc, best_step, since_best = _reconstruct_best_tracking(
            workdir, start_step, cfg, ckpt)
        log.write("resume", step=start_step,
                  best_auc=(round(best_auc, 5) if np.isfinite(best_auc)
                            else None),
                  since_best=since_best)
    elif tc.init_from:
        # A resumed run continues itself; the donor only seeds step 0.
        _warm_start_state(cfg, state, tc.init_from)
        log.write("warm_start", init_from=tc.init_from)

    teacher = None
    if tc.distill_from:
        # The soft targets are a pure function of the batch, so a resumed
        # run distills exactly as the uninterrupted one.
        teacher = _distill_teacher(cfg, dev)
        log.write("distill", distill_from=tc.distill_from)

    overlap = tc.eval_overlap
    saver = ckpt_lib.AsyncSaver() if (tc.async_save or overlap) else None
    # The ingest autotuner's live knobs (data.autotune), adjusted at every
    # log boundary from the window's stall attribution.
    knobs, tuner = _autotune_for(cfg, dev)
    # One batch per completed step: a resumed stream continues exactly
    # where the interrupted one stopped.
    stream, grain_tee = _train_stream(
        cfg, data_dir, seed, start_step, dev, knobs,
        grain_state=_load_grain_state(cfg, workdir, start_step),
        mesh=mesh if multi else None)
    # The val batches stay on the card between evals under the loaders
    # that keep train rows there (budget-gated; None streams every eval).
    val_cache = _eval_cache_for(cfg, data_dir, "val", device=dev)
    profiler = _ProfilerWindow(quiet, log, workdir, start_step, dev)
    flight = _flight_for(quiet, workdir, profiler)
    _, stalls, snap = _telemetry_for(quiet, log, workdir, flight=flight)
    clock = _ThroughputClock(cfg.data.batch_size)
    stopped_early = False
    save_stall = [0.0]
    last_step = start_step
    in_step = False
    eval_job: "_BgJob | None" = None
    # Set on preemption: a late eval-time save must not roll latest/
    # back behind the emergency save.
    preempted = threading.Event()

    def save_fn(step_now: int, auc: float) -> None:
        """The eval-time save of the live state: written here, or (with
        a saver) a device snapshot handed to the writer."""
        t0 = time.perf_counter()
        if saver is not None:
            snap = train_lib.snapshot(state)

            def job():
                snap.wait()
                ckpt.save(step_now, train_lib.state_to_flat(snap.state),
                          {"val_auc": auc})
                _persist_grain_state(grain_tee, workdir, step_now,
                                     kept_steps=ckpt.all_steps())

            saver.submit(job)
        else:
            if lead:
                ckpt.save(step_now, train_lib.state_to_flat(state),
                          {"val_auc": auc})
                _persist_grain_state(grain_tee, workdir, step_now,
                                     kept_steps=ckpt.all_steps())
            # No rank reads the run's files before rank 0 has written.
            mesh.barrier()
        dt = time.perf_counter() - t0
        stalls.add("save", dt)
        save_stall[0] += dt

    def predict_val(eval_state: train_lib.TrainState):
        eval_step = train_lib.make_eval_step(
            cfg, eval_state, dev, mesh=mesh if multi else None)
        grades, probs, _ = predict_split(
            cfg, lambda images: eval_step(images)[None], data_dir, "val",
            cache=val_cache, device=dev, mesh=mesh if multi else None)
        return grades, probs[0]

    def submit_eval(step_now: int) -> _BgJob:
        """The whole eval block on a background thread, over a snapshot
        of the state taken now; its save goes to the saver."""
        snap = train_lib.snapshot(state)
        tracked = (best_auc, best_step, since_best)

        def overlap_save(step_at: int, auc: float) -> None:
            def job():
                # Checked on the writer too: the latch is always set
                # before the emergency save is queued.
                if not preempted.is_set():
                    ckpt.save(step_at, train_lib.state_to_flat(snap.state),
                              {"val_auc": auc})
                    _persist_grain_state(grain_tee, workdir, step_at,
                                         kept_steps=ckpt.all_steps())

            if not preempted.is_set():
                saver.submit(job)

        def job():
            snap.wait()
            # Grad mode is per thread: this one records no graph either.
            with _stream_context(dev), torch.no_grad():
                return _eval_and_track(
                    cfg, log, step_now, lambda: predict_val(snap.state),
                    overlap_save, *tracked,
                    save_due=_save_due(cfg, step_now),
                    curve_gate=curve_gate)

        return _BgJob(job)

    def preempt_save_latest(step_now: int) -> bool:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if not lead:
            return False
        if saver is None:
            return ckpt.save_latest(step_now,
                                    train_lib.state_to_flat(state))
        out = {}

        def job():
            out["saved"] = ckpt.save_latest(
                step_now, train_lib.state_to_flat(state))

        saver.submit(job)
        saver.drain()
        return out["saved"]

    try:
        if flight is not None:
            flight.install_signal_handlers()
        try:
            for step_i in range(start_step, tc.steps):
                t_step = time.perf_counter()
                faultinject.check("trainer.step")
                profiler.before_step(step_i)
                with stalls.measure("input"):
                    batch = next(stream)
                    if teacher is not None:
                        batch = {**batch, "soft": teacher(batch["image"])}
                # The step updates the state in place, leaf by leaf: an
                # interrupt inside it leaves no step's state to save.
                in_step = True
                with stalls.measure("dispatch"):
                    if tc.debug:
                        loss = _debug_step(lambda: train_lib.train_step(
                            state, batch, cfg, **step_kw), step_i + 1)
                    else:
                        loss = train_lib.train_step(state, batch, cfg,
                                                    **step_kw)
                last_step = step_i + 1
                in_step = False
                clock.after_step()
                if snap is not None:
                    snap.progress(step_i + 1)
                # The step's time stops before a closing capture, whose
                # device sync is a pause, not a slow step.
                dt_step = time.perf_counter() - t_step
                profiler.after_step(step_i)
                if flight is not None:
                    flight.progress(step_i + 1)
                    flight.note_step_time(dt_step, step=step_i + 1)
                if (step_i + 1) % tc.log_every == 0:
                    loss = float(loss)
                    if flight is not None:
                        # On the loss the record reads anyway: no sync of
                        # its own.
                        flight.note_loss(loss, step=step_i + 1)
                    stall_fields = stalls.fields()
                    log.write("train", step=step_i + 1, loss=loss,
                              **clock.fields(), **stall_fields)
                    if tuner is not None:
                        # One tuner window per log window.
                        tuner.observe(stall_fields["window_sec"],
                                      stall_fields["input_wait_sec"])
                    if snap is not None:
                        snap.maybe_flush()
                # A finished overlapped eval is collected the step after
                # it lands: its early stop or curve refusal fires at most
                # one step late.
                if eval_job is not None and eval_job.done():
                    best_auc, best_step, since_best, stop = eval_job.result()
                    eval_job = None
                    if stop:
                        stopped_early = True
                        break
                if not ((step_i + 1) % tc.eval_every == 0
                        or step_i + 1 == tc.steps):
                    continue
                if overlap:
                    if eval_job is not None:
                        # One eval in flight: the previous one's best
                        # tracking chains into this one.
                        clock.pause()
                        with stalls.measure("pause"):
                            best_auc, best_step, since_best, stop = (
                                eval_job.result())
                        eval_job = None
                        clock.resume()
                        if stop:
                            stopped_early = True
                            break
                    with stalls.measure("pause"):
                        eval_job = submit_eval(step_i + 1)
                    continue
                clock.pause()
                t_pause = time.perf_counter()
                save_stall[0] = 0.0
                best_auc, best_step, since_best, stop = _eval_and_track(
                    cfg, log, step_i + 1, lambda: predict_val(state),
                    save_fn, best_auc, best_step, since_best,
                    save_due=_save_due(cfg, step_i + 1),
                    curve_gate=curve_gate)
                stalls.add("pause", max(
                    0.0, time.perf_counter() - t_pause - save_stall[0]))
                clock.resume()
                if stop:
                    stopped_early = True
                    break
        except BaseException as e:
            # The blackbox first. SIGINT, and SIGTERM through the flight
            # recorder's handlers, arrive as KeyboardInterrupt/SystemExit:
            # the host is wanted back, and a last resume point is worth a
            # save.
            if flight is not None:
                flight.record_exception(e)
            if (isinstance(e, (SystemExit, KeyboardInterrupt))
                    and last_step > start_step):
                # Do not wait for an overlapped eval; settle the queued
                # saves, then save latest/ behind them.
                preempted.set()
                if saver is not None:
                    try:
                        saver.drain()
                    except Exception as err:  # noqa: BLE001 - exit path
                        _log.error("a queued save failed before the "
                                   "preemption save: %s", err)
                if in_step:
                    # Part of step last_step + 1 is in the state: latest/
                    # keeps its last clean save.
                    log.write("preempt_save", step=last_step, saved=False)
                    _log.warning("preemption inside step %d: the state is "
                                 "part-updated, latest/ is left as it was",
                                 last_step + 1)
                else:
                    _preempt_save(log, last_step, preempt_save_latest,
                                  grain_tee, workdir)
            raise
        finally:
            # No capture or signal handler outlives the loop.
            profiler.finalize()
            if flight is not None:
                flight.uninstall_signal_handlers()
        # The tail: an overlapped last eval and the queued saves land
        # before the run returns; their failures surface here.
        if eval_job is not None:
            best_auc, best_step, since_best, stop = eval_job.result()
            eval_job = None
            stopped_early = stopped_early or stop
        if saver is not None:
            saver.close()
        if cfg.obs.quality.profile_out:
            _emit_quality_profile(cfg, data_dir, lambda: predict_val(state),
                                  log, write=lead)
        if snap is not None:
            snap.close()  # the final telemetry and heartbeat
    finally:
        stream.close()
        if saver is not None:
            try:
                saver.close()
            except Exception as err:  # noqa: BLE001 - another is raising
                _log.error("a queued save failed while the run was "
                           "stopping: %s", err)
        log.close()
    return {
        "best_auc": float(best_auc) if np.isfinite(best_auc) else None,
        "best_step": int(best_step),
        "stopped_early": stopped_early,
    }


def fit_ensemble(cfg: configs.ExperimentConfig, data_dir: str, workdir: str,
                 device: "str | torch.device | None" = None) -> "list[dict]":
    """Train ``train.ensemble_size`` members, member m with seed
    ``train.seed + m`` in ``<workdir>/member_NN``.

    ``train.ensemble_parallel`` with ``train.ensemble_parallel_force``
    routes to ``fit_ensemble_parallel`` (one stacked step for all
    members). Without the force, the reference's one-device rule holds:
    a run on one device trains the members in turn, with the reason
    logged (the port always runs on one device).

    In turn, each member goes through ``fit`` with the run knobs as set
    (every member warm-starts from ``train.init_from``, and each is held
    to the curve refs), as the reference's sequential ``fit_ensemble``
    does; with ``obs.quality.profile_out`` each member writes its profile
    there in turn, so the last member's stays, as in the reference."""
    tc = cfg.train
    if tc.ensemble_parallel:
        if tc.ensemble_parallel_force:
            return fit_ensemble_parallel(cfg, data_dir, workdir, device)
        _log.warning(
            "train.ensemble_parallel disabled: one device, and the "
            "reference's rule trains members in turn on one device (its "
            "stacked step measured slower than members in turn on one TPU "
            "chip); training the %d members one after another. Set "
            "train.ensemble_parallel_force=true to train them stacked.",
            tc.ensemble_size)
    member_cfg = cfg.replace(
        train=dataclasses.replace(tc, ensemble_size=1))
    results = []
    for member in range(tc.ensemble_size):
        mdir = ckpt_lib.member_dir(workdir, member)
        res = fit(member_cfg, data_dir, mdir, seed=tc.seed + member,
                  device=device)
        results.append({"member": member, "workdir": mdir, **res})
    return results


def _predict_split_members(cfg: configs.ExperimentConfig,
                           state: train_lib.EnsembleState, data_dir: str,
                           split: str, device: torch.device,
                           cache: "list | None" = None
                           ) -> "tuple[np.ndarray, np.ndarray]":
    """``predict_split`` of a stacked state: one vmapped forward scores
    all k members per batch -> (grades [n], probs [k, n] or [k, n, C]);
    ``cache`` as in ``predict_split``."""
    step = train_lib.make_ensemble_eval_step(cfg, state, device)
    grades, probs, _ = predict_split(cfg, step, data_dir, split,
                                     cache=cache, device=device)
    return grades, probs


MEMBER_PARALLEL_MARKER = ".member_parallel"


def _restore_members(cfg: configs.ExperimentConfig, workdir: str,
                     ckpts: list, was_member_parallel: bool) -> "int | None":
    """The step every member restores from on resume (None: no
    checkpoint yet). Members checkpoint in lock-step, so an intact
    workdir has all at one step; after a save torn by a crash between
    the members' saves, every member rolls back to the newest step all
    of them still hold, and the newer checkpoints are deleted. Members at
    different steps in a workdir this driver did not write (a sequential
    ensemble's) raise instead."""
    latest = [c.latest_step for c in ckpts]
    if all(s is None for s in latest):
        return None
    if None not in latest and len(set(latest)) == 1:
        step0 = latest[0]
    else:
        if not was_member_parallel:
            raise ValueError(
                f"member checkpoints are at different steps {latest} and "
                "this is not a member-parallel workdir: resume the "
                "sequential ensemble with train.ensemble_parallel=false (if "
                "a member-parallel run did write it, create the "
                f"{MEMBER_PARALLEL_MARKER} file in the workdir to enable the "
                "torn-save rollback)")
        common = set.intersection(*[c.all_steps() for c in ckpts])
        if not common:
            raise ValueError(
                f"member checkpoints are at different steps {latest} and "
                "share no restorable step: a save was torn by a crash and "
                "retention has dropped the last common step")
        step0 = max(common)
        _log.warning("member latest checkpoints disagree (%s), likely a "
                     "save torn by a crash; rolling back to the newest "
                     "common step %d", latest, step0)
        for c in ckpts:
            c.delete_newer_than(step0)
        # The rolled-back steps' grain states belong to the abandoned
        # timeline too.
        _prune_grain_state(workdir, {
            s for s in set.union(*[c.all_steps() for c in ckpts])
            if s <= step0})
    for m, c in enumerate(ckpts):
        _check_ema_compat(c, cfg, ckpt_lib.member_dir(workdir, m), step0)
    return step0


def fit_ensemble_parallel(cfg: configs.ExperimentConfig, data_dir: str,
                          workdir: str,
                          device: "str | torch.device | None" = None
                          ) -> "list[dict]":
    """Member-parallel ensemble training: all k members advance in one
    stacked step (``train_lib.ensemble_train_step``) per batch.

    Member m keeps the sequential driver's seed (``train.seed + m``) for
    its init, augment and dropout; all members share the ``train.seed``
    batch stream. Checkpoints land in the sequential driver's
    ``member_NN/{best,latest}`` layout, best by each member's own val
    AUC, so ``evaluate`` and ``predict`` cannot tell which driver trained
    the members; each member's ``run_meta.json`` pins its seed, and a
    workdir whose members pin other seeds is refused. Every eval logs
    ``val_auc_per_member`` and ``ensemble_val_auc``; the curve gate reads
    the ensemble AUC; early stopping fires when every member has
    exhausted its patience. ``train.save_every_evals``,
    ``train.async_save`` and ``train.eval_overlap`` act as in ``fit``.
    ``train.resume`` restores every member in lock-step (after a torn
    save, at the newest step all members hold) and continues the exact
    stream; ``train.init_from`` is refused (it would seed every member
    alike). A ``SystemExit``/``KeyboardInterrupt`` between steps saves
    every member's ``latest/`` at the last completed step."""
    dev = device_lib.resolve(device)
    _refuse_ranks("the stacked ensemble (train.ensemble_parallel)")
    tc = cfg.train
    k = tc.ensemble_size
    if tc.distill_from:
        # The reference's stacked step takes no soft targets, and its
        # fit_ensemble_parallel never reads distill_from.
        raise ValueError(
            "train.distill_from is not read by the member-parallel step: "
            "it would train every member on the hard labels. Distill the "
            "members in turn (train.ensemble_parallel=false)")
    if tc.init_from:
        raise ValueError(
            "train.init_from warm-starts one member from one checkpoint "
            "dir; the member-parallel driver would seed every stacked member "
            "identically (diversity collapse). Fine-tune members through "
            "sequential fit() calls")
    configs.validate_train_knobs(tc)
    configs.check_supported(
        cfg.replace(train=dataclasses.replace(tc, ensemble_size=1)),
        training=True)
    train_lib.check_ensemble_knobs(tc)
    cfg = train_lib.resolve_large_batch(cfg)
    # The persisted member-0 seed is the base seed on resume; member m's
    # run_meta then pins base + m.
    seed = _load_or_write_run_meta(ckpt_lib.member_dir(workdir, 0), tc.seed,
                                   cfg.name, tc.resume)
    for m in range(1, k):
        persisted = _load_or_write_run_meta(ckpt_lib.member_dir(workdir, m),
                                            seed + m, cfg.name, tc.resume)
        if persisted != seed + m:
            raise ValueError(
                f"member {m} run_meta pins seed {persisted}, but this "
                f"ensemble derives member seeds from base {seed} (expected "
                f"{seed + m}): the workdir belongs to a differently seeded "
                "ensemble; resume with the original base seed or use a fresh "
                "workdir")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=seed))
    tc = cfg.train
    seeds = [seed + m for m in range(k)]
    # Marks this driver's workdirs: the torn-save rollback deletes
    # checkpoints and must never fire on a sequential ensemble's. Read
    # before it is written.
    marker = os.path.join(workdir, MEMBER_PARALLEL_MARKER)
    was_member_parallel = os.path.exists(marker)
    os.makedirs(workdir, exist_ok=True)
    with open(marker, "w") as f:
        f.write("workdir written by trainer.fit_ensemble_parallel\n")
    log = RunLog(workdir, METRICS_FILE, tensorboard=tc.tensorboard,
                 fresh=not tc.resume)
    log.write("config", name=cfg.name, seed=seed, ensemble_parallel=True,
              n_members=k, n_devices=1)
    curve_gate = _DtypeCurveGate(cfg)
    ckpts = [ckpt_lib.Checkpointer(
        os.path.abspath(ckpt_lib.member_dir(workdir, m)),
        max_to_keep=tc.max_to_keep) for m in range(k)]

    start_step = 0
    best_auc = np.full((k,), -np.inf)
    best_step = np.zeros((k,), np.int64)
    since_best = np.zeros((k,), np.int64)
    _obs_begin_run(cfg)  # before the restore and the stream's metrics
    step0 = (_restore_members(cfg, workdir, ckpts, was_member_parallel)
             if tc.resume else None)
    if step0 is None:
        state = train_lib.create_ensemble_state(cfg, seeds, dev)
    else:
        members = []
        for c in ckpts:
            member = train_lib.create_state(cfg, models.build(cfg.model),
                                            "cpu")
            members.append(_load_restored(member, c, step0))
        state = train_lib.stack_states(members, seeds, dev)
        del members
        start_step = int(step0)
        best_auc, best_step, since_best = _reconstruct_member_tracking(
            workdir, start_step, cfg, ckpts)
        log.write("resume", step=start_step,
                  best_auc_per_member=[
                      round(float(a), 5) if np.isfinite(a) else None
                      for a in best_auc])

    overlap = tc.eval_overlap
    saver = ckpt_lib.AsyncSaver() if (tc.async_save or overlap) else None
    knobs, tuner = _autotune_for(cfg, dev)
    # The stacked step reads the same global batches as one fit.
    stream, grain_tee = _train_stream(
        cfg, data_dir, seed, start_step, dev, knobs,
        grain_state=_load_grain_state(cfg, workdir, start_step))
    val_cache = _eval_cache_for(cfg, data_dir, "val", device=dev)
    profiler = _ProfilerWindow(cfg, log, workdir, start_step, dev)
    flight = _flight_for(cfg, workdir, profiler)
    _, stalls, snap = _telemetry_for(cfg, log, workdir, flight=flight)
    clock = _ThroughputClock(cfg.data.batch_size)
    stopped_early = False
    save_stall = [0.0]
    last_step = start_step
    in_step = False
    eval_job: "_BgJob | None" = None
    preempted = threading.Event()

    def save_members(step_now: int, src: train_lib.EnsembleState,
                     aucs) -> None:
        # Checked on the writer too: a late eval-time save must not land
        # behind the preemption save and roll latest/ back.
        if preempted.is_set():
            return
        for m in range(k):
            ckpts[m].save(step_now,
                          train_lib.state_to_flat(
                              train_lib.unstack_member(src, m)),
                          {"val_auc": float(aucs[m])})
        _persist_grain_state(
            grain_tee, workdir, step_now,
            kept_steps=set.union(*[c.all_steps() for c in ckpts]))

    def eval_members(step_now: int, eval_state, ba, bs, sb, stable: bool,
                     attribute: bool):
        """One eval block: predict -> per-member AUCs -> ensemble AUC ->
        best tracking -> the curve gate -> the lock-step save. Inline
        (``attribute``: its save time goes to the ``save`` stall), or on
        the overlap thread over a snapshot (``stable``)."""
        grades, probs = _predict_split_members(cfg, eval_state, data_dir,
                                               "val", dev, cache=val_cache)
        labels = (grades >= 2).astype(np.float64)
        member_probs = [_referable(p, cfg.model.head) for p in probs]
        aucs = np.array([metrics.roc_auc(labels, p) for p in member_probs])
        ens_auc = metrics.roc_auc(labels,
                                  metrics.ensemble_average(member_probs))
        ba, bs, sb = _best_tracking_update(aucs, ba, bs, sb, step_now,
                                           tc.min_delta)
        # Full precision per member: resume replays it.
        log.write("eval", step=step_now,
                  val_auc_per_member=[float(a) for a in aucs],
                  ensemble_val_auc=round(float(ens_auc), 5),
                  best_auc_per_member=[round(float(a), 5) for a in ba])
        curve_gate.check(step_now, float(ens_auc))
        stopping = bool(np.all(sb >= tc.early_stop_patience))
        if (_save_due(cfg, step_now) or stopping) and not preempted.is_set():
            t0 = time.perf_counter()
            if saver is None:
                save_members(step_now, eval_state, aucs)
            else:
                snap = (None if stable
                        else train_lib.snapshot(eval_state))

                def job(snap=snap):
                    if snap is not None:
                        snap.wait()
                    save_members(step_now,
                                 eval_state if snap is None else snap.state,
                                 aucs)

                saver.submit(job)
            if attribute:
                dt = time.perf_counter() - t0
                stalls.add("save", dt)
                save_stall[0] += dt
        if stopping:
            log.write("early_stop", step=step_now,
                      best_step=[int(x) for x in bs])
        return ba, bs, sb, stopping

    def submit_eval(step_now: int) -> _BgJob:
        snap = train_lib.snapshot(state)
        tracked = (best_auc, best_step, since_best)

        def job():
            snap.wait()
            with _stream_context(dev), torch.no_grad():
                return eval_members(step_now, snap.state, *tracked,
                                    stable=True, attribute=False)

        return _BgJob(job)

    def preempt_save_latest(step_now: int) -> bool:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        def write() -> bool:
            wrote = False
            for m in range(k):
                wrote = ckpts[m].save_latest(
                    step_now, train_lib.state_to_flat(
                        train_lib.unstack_member(state, m))) or wrote
            return wrote

        if saver is None:
            return write()
        out = {}
        saver.submit(lambda: out.__setitem__("saved", write()))
        saver.drain()
        return out["saved"]

    try:
        if flight is not None:
            flight.install_signal_handlers()
        try:
            for step_i in range(start_step, tc.steps):
                t_step = time.perf_counter()
                faultinject.check("trainer.step")
                profiler.before_step(step_i)
                with stalls.measure("input"):
                    batch = next(stream)
                in_step = True
                with stalls.measure("dispatch"):
                    if tc.debug:
                        losses = _debug_step(
                            lambda: train_lib.ensemble_train_step(
                                state, batch, cfg), step_i + 1)
                    else:
                        losses = train_lib.ensemble_train_step(state, batch,
                                                               cfg)
                last_step = step_i + 1
                in_step = False
                clock.after_step()
                if snap is not None:
                    snap.progress(step_i + 1)
                dt_step = time.perf_counter() - t_step
                profiler.after_step(step_i)
                if flight is not None:
                    flight.progress(step_i + 1)
                    flight.note_step_time(dt_step, step=step_i + 1)
                if (step_i + 1) % tc.log_every == 0:
                    per = losses.detach().cpu().numpy()
                    if flight is not None:
                        flight.note_loss(per, step=step_i + 1)
                    stall_fields = stalls.fields()
                    log.write("train", step=step_i + 1,
                              loss=round(float(per.mean()), 6),
                              loss_per_member=[round(float(x), 6)
                                               for x in per],
                              **clock.fields(), **stall_fields)
                    if tuner is not None:
                        tuner.observe(stall_fields["window_sec"],
                                      stall_fields["input_wait_sec"])
                    if snap is not None:
                        snap.maybe_flush()
                if eval_job is not None and eval_job.done():
                    best_auc, best_step, since_best, stop = eval_job.result()
                    eval_job = None
                    if stop:
                        stopped_early = True
                        break
                if not ((step_i + 1) % tc.eval_every == 0
                        or step_i + 1 == tc.steps):
                    continue
                if overlap:
                    if eval_job is not None:
                        clock.pause()
                        with stalls.measure("pause"):
                            best_auc, best_step, since_best, stop = (
                                eval_job.result())
                        eval_job = None
                        clock.resume()
                        if stop:
                            stopped_early = True
                            break
                    with stalls.measure("pause"):
                        eval_job = submit_eval(step_i + 1)
                    continue
                clock.pause()
                t_pause = time.perf_counter()
                save_stall[0] = 0.0
                with torch.no_grad():
                    best_auc, best_step, since_best, stop = eval_members(
                        step_i + 1, state, best_auc, best_step, since_best,
                        stable=False, attribute=True)
                stalls.add("pause", max(
                    0.0, time.perf_counter() - t_pause - save_stall[0]))
                clock.resume()
                if stop:
                    stopped_early = True
                    break
        except BaseException as e:
            if flight is not None:
                flight.record_exception(e)
            if (isinstance(e, (SystemExit, KeyboardInterrupt))
                    and last_step > start_step):
                preempted.set()
                if saver is not None:
                    try:
                        saver.drain()
                    except Exception as err:  # noqa: BLE001 - exit path
                        _log.error("a queued save failed before the "
                                   "preemption save: %s", err)
                if in_step:
                    log.write("preempt_save", step=last_step, saved=False)
                    _log.warning("preemption inside step %d: the state is "
                                 "part-updated, latest/ is left as it was",
                                 last_step + 1)
                else:
                    # Every member in lock-step, as the eval-time save.
                    _preempt_save(log, last_step, preempt_save_latest,
                                  grain_tee, workdir)
            raise
        finally:
            profiler.finalize()
            if flight is not None:
                flight.uninstall_signal_handlers()
        if eval_job is not None:
            best_auc, best_step, since_best, stop = eval_job.result()
            eval_job = None
            stopped_early = stopped_early or stop
        if saver is not None:
            saver.close()
        if cfg.obs.quality.profile_out:
            def ensemble_predict():
                grades, probs = _predict_split_members(
                    cfg, state, data_dir, "val", dev, cache=val_cache)
                return grades, metrics.ensemble_average(list(probs))

            with torch.no_grad():
                _emit_quality_profile(cfg, data_dir, ensemble_predict, log)
        if snap is not None:
            snap.close()
    finally:
        stream.close()
        if saver is not None:
            try:
                saver.close()
            except Exception as err:  # noqa: BLE001 - another is raising
                _log.error("a queued save failed while the run was "
                           "stopping: %s", err)
        log.close()
    return [{"member": m, "workdir": ckpt_lib.member_dir(workdir, m),
             "best_auc": (float(best_auc[m]) if np.isfinite(best_auc[m])
                          else None),
             "best_step": int(best_step[m]),
             "stopped_early": stopped_early} for m in range(k)]


# ---------------------------------------------------------------------------
# Evaluate
# ---------------------------------------------------------------------------

def restore_for_eval(cfg: configs.ExperimentConfig,
                     ckpt_dir: str) -> "dict[str, torch.Tensor]":
    """The eval ``state_dict`` of a member: its checkpoint dir's best step
    (the EMA shadow in place of the params when the run carried one), or
    a ``params.npz`` member dir."""
    return convert.flax_to_torch(ckpt_lib.load_member(ckpt_dir),
                                 models.build(cfg.model))


def evaluate_checkpoints(
    cfg: configs.ExperimentConfig,
    data_dir: str,
    ckpt_dirs: "list[str]",
    split: str = "test",
    backend: str = "torch",
    threshold_split: "str | None" = None,
    threshold_data_dir: "str | None" = None,
    bootstrap: int = 0,
    save_probs: "str | None" = None,
    calibrate: bool = False,
    profile_out: "str | None" = None,
    device: "str | torch.device | None" = None,
) -> dict:
    """Score ``split`` with one member or the float64 average of k, and
    report AUC and the operating points at ``eval.operating_specificities``
    (``metrics.evaluation_report``).

    ``threshold_split`` (e.g. "val") adds the paper's protocol: thresholds
    chosen at the fixed specificities on that split (of
    ``threshold_data_dir`` when given) and applied unchanged to ``split``,
    as ``operating_points_transferred``; tuning on the evaluated split
    itself raises. ``bootstrap`` > 0 adds 95 % intervals. ``save_probs``
    writes per-image probabilities as CSV. ``calibrate`` (needs
    ``threshold_split``) fits a temperature on the tuning split and
    reports the calibrated Brier score and ECE. ``profile_out`` writes
    the quality monitor's reference profile of ``split``
    (``obs/quality.py``): score and input-statistic histograms, base
    rate and the report's operating thresholds.

    Members are scored in float32 weights, one after another, as the
    reference's evaluate does: the serving knobs ``serve.dtype``,
    ``serve.member_parallel`` and ``obs.quality`` do not apply."""
    dev = device_lib.resolve(device)
    if backend == "tf":
        raise NotImplementedError(
            "backend='tf' (the keras legacy graph) is not ported: the card "
            "machine has no TensorFlow; see ROADMAP.md, \"Not queued\"")
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (want 'torch')")
    if not ckpt_dirs:
        raise ValueError("need at least one checkpoint dir")
    if calibrate and not threshold_split:
        raise ValueError(
            "calibrate=True needs threshold_split: temperature must be "
            "fit on a tuning split, never on the split being reported")
    tune_dir = threshold_data_dir or data_dir
    if threshold_split == split and (
            os.path.realpath(tune_dir) == os.path.realpath(data_dir)):
        raise ValueError(
            f"threshold_split={split!r} on the same data dir is the eval "
            "set itself — self-tuned thresholds are exactly the bias this "
            "protocol avoids (the plain operating_points rows already "
            "report them)")
    eval_cfg = cfg.replace(
        serve=dataclasses.replace(cfg.serve, dtype="fp32",
                                  member_parallel=False),
        obs=dataclasses.replace(cfg.obs, quality=configs.QualityConfig()))
    engine = ServingEngine(
        eval_cfg, state_dicts=[restore_for_eval(cfg, d) for d in ckpt_dirs],
        device=dev, registry=obs_registry.Registry(enabled=False),
        faults=False)

    passes = [("eval", data_dir, split)]
    if threshold_split:
        passes.append(("tune", tune_dir, threshold_split))
    member_probs, grades_by = {}, {}
    eval_names = None
    # One device-resident cache per (dir, split) pass under the hbm,
    # tiered and rawshard loaders, admitted against the caches already held (their joint
    # footprint, not each split's alone). The engine scores every member
    # on each cached batch, so no batch is read or uploaded twice.
    eval_caches: "dict[tuple, list | None]" = {}
    cached_bytes = 0
    for key, from_dir, s in passes:
        if (from_dir, s) not in eval_caches:
            cache = _eval_cache_for(cfg, from_dir, s,
                                    reserved_bytes=cached_bytes, device=dev)
            if cache is not None:
                cached_bytes += _eval_cache_bytes(cfg, from_dir, s)
            eval_caches[(from_dir, s)] = cache
        grades_by[key], member_probs[key], names = predict_split(
            cfg, engine.member_probs, from_dir, s,
            cache=eval_caches[(from_dir, s)], device=dev)
        if key == "eval":
            eval_names = names

    head = cfg.model.head
    probs = metrics.ensemble_average(list(member_probs["eval"]))
    report = metrics.evaluation_report(
        _binary_eval_labels(grades_by["eval"], head), probs,
        cfg.eval.operating_specificities, bootstrap_samples=bootstrap)
    if threshold_split:
        tune_bin = (grades_by["tune"] >= 2).astype(np.float64)
        tune_p = _referable(
            metrics.ensemble_average(list(member_probs["tune"])), head)
        labels = (grades_by["eval"] >= 2).astype(np.float64)
        eval_p = _referable(probs, head)
        report["operating_points_transferred"] = (
            metrics.transferred_operating_points(
                tune_bin, tune_p, labels, eval_p,
                cfg.eval.operating_specificities,
                bootstrap_samples=bootstrap))
        report["threshold_split"] = threshold_split
        if threshold_data_dir:
            report["threshold_data_dir"] = threshold_data_dir
        if calibrate:
            temp = metrics.fit_temperature(tune_bin, tune_p)
            cal = metrics.apply_temperature(eval_p, temp)
            report["calibration"] = {
                "temperature": round(temp, 4),
                "brier": metrics.brier_score(labels, cal),
                "ece": metrics.expected_calibration_error(labels, cal),
            }
    if save_probs:
        quality_by_name = tfrecord.read_quality_by_name(
            tfrecord.list_split(data_dir, split))
        _write_probs_csv(save_probs, eval_names, grades_by["eval"], probs,
                         head, quality_by_name)
        report["probs_file"] = save_probs
    if profile_out:
        profile = quality_lib.build_profile(
            _referable(probs, head),
            labels=(grades_by["eval"] >= 2).astype(np.float64),
            stat_values=quality_lib.split_input_stats(
                data_dir, split, cfg.eval.batch_size, cfg.model.image_size),
            thresholds=[{"target_specificity": row["target_specificity"],
                         "threshold": row["threshold"]}
                        for row in report["operating_points"]],
            bins=cfg.obs.quality.score_bins,
            meta={"config": cfg.name, "split": split,
                  "n_models": len(ckpt_dirs), "source": "evaluate"})
        quality_lib.save_profile(profile_out, profile)
        report["profile_out"] = profile_out
    report["split"] = split
    report["n_models"] = len(ckpt_dirs)
    return report


def _write_probs_csv(path: str, names: np.ndarray, grades: np.ndarray,
                     probs: np.ndarray, head: str,
                     quality_by_name: "dict[bytes, float] | None" = None,
                     ) -> None:
    """Per-image ensemble-averaged probabilities as CSV, one row per eval
    example; ``quality`` is the preprocessing gradability score (-1 when
    the record has none). The 5-class head adds ``prob_grade_0..4``
    after ``prob_referable`` (P(grade >= 2))."""
    import csv

    def qual(nm) -> str:
        if quality_by_name is None:
            return "-1"
        return f"{quality_by_name.get(nm, -1.0):.4f}"

    grade_cols = ([] if head == "binary"
                  else [f"prob_grade_{c}" for c in range(probs.shape[-1])])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "grade", "quality", "prob_referable"]
                   + grade_cols)
        for nm, g, p, r in zip(names, grades, probs,
                               _referable(probs, head)):
            w.writerow([nm.decode(), int(g), qual(nm), f"{float(r):.6f}"]
                       + ([] if head == "binary"
                          else [f"{float(x):.6f}" for x in p]))
