"""The train and eval steps (counterpart of
``jama16_retina_tpu/train_lib.py``: ``make_schedule``, the loss,
``_step_impl``, ``_apply_update``, ``eval_params`` and ``make_eval_step``).

One step: draw the augment and dropout streams from (seed, step), augment
the uint8 batch on its device, forward and backward in train mode (batch
statistics, running statistics updated in place), then AdamW and the EMA
shadow (``compute_grads``, then the update). ``train.dtype=bf16`` runs
the forward and backward on a bfloat16 view of every parameter (the
reference's ``_bf16_params``); the float32 parameters stay the masters,
and the view's backward hands them float32 gradients (``_f32_grads``).
``train.accum_steps`` splits the augmented batch into that many
micro-batches run in order (ghost BatchNorm: each normalizes by its own
moments and updates the running statistics once), with the gradients
accumulated in float32 as ``acc + g * (1 / accum)``, micro by micro.
A batch that carries ``"soft"`` (the distillation teacher's scores,
``train.distill_from``) trains against them instead of the grades
(``_distill_loss``, in float32; split by the same micro-batch rows).
The optimizer is ``train.optimizer``'s family (``optim.py``: adamw,
sgdm, rmsprop or lamb, optionally behind ``train.gradient_clip_norm``);
adamw runs the plain AdamW (``ops/adamw.adamw_reference``) or, with
``train.use_pallas_fused``, kernel B3 (``ops/adamw.fused_adamw_update``).
The augment goes through kernel B1 (``data.use_pallas``) or B2 (fused).

The state mirrors the reference's ``TrainState`` and the family's optax
state: the step, the model (params and batch statistics), the family's
moments per leaf (``optim.MOMENTS``) with the Adam count where it has
one, the schedule's count and the EMA shadow. Counts and moments live on
the model's device, so a step reads no host value. ``state_to_flat`` and
``load_state_flat`` carry the whole state to and from the flat numpy
dict a checkpoint stores.

The member-parallel ensemble (``train.ensemble_parallel``) trains k
members in one stacked state (``EnsembleState``): every leaf gains a
leading member dimension, and ``ensemble_train_step`` advances all k in
one forward and backward under ``torch.func.vmap``, the counterpart of
the reference's ``make_ensemble_train_step`` without a mesh.
``global_batch`` and ``resolve_large_batch`` are the large-batch
recipe's learning-rate rule.

Under a data mesh of more than one rank (``parallel/mesh.py``; the
reference's ``make_train_step(mesh=...)``) each rank steps its replica
on its block of the global batch: the augment and dropout draws are the
global batch's (each rank takes its rows), the model's BatchNorms take
the global batch's moments, and the gradients and the loss are averaged
over the ranks in one flat all-reduce before the unchanged update
(``_rank_grads``), so N ranks take the one-process step. The kernels stay
on every rank (B1, or B2 and B3, on the rank's rows and replica), where
the reference routes its Mosaic kernels to the jnp composition on a mesh
(``_pallas_safe_cfg``; ROADMAP Queue C). ``make_eval_step`` then scores a
rank's rows and assembles the batch's probabilities on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jama16_retina_tpu_torch import configs, models, optim
from jama16_retina_tpu_torch.configs import ExperimentConfig, TrainConfig
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.models import common, convert, init
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.parallel import mesh as mesh_lib
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

_log = logging.getLogger(__name__)


class DtypeCurveRejected(RuntimeError):
    """A ``train.dtype=bf16`` run drifted beyond ``train.dtype_curve_tol``
    of the pinned fp32 curve (``train.dtype_curve_ref``) at an eval step:
    the run stops with the step and both AUCs named (the reference's
    ``train_lib.DtypeCurveRejected``)."""


class RecipeCurveRejected(RuntimeError):
    """A large-batch recipe run (``train.optimizer=lamb`` or a scaled
    learning rate, ``train.lr_scale_ref_batch``) drifted beyond
    ``train.recipe_curve_tol`` of the pinned baseline curve
    (``train.recipe_curve_ref``) at an eval step: the run stops with the
    step and both AUCs named (the reference's
    ``train_lib.RecipeCurveRejected``)."""


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    # optax ScaleByAdamState.count (adamw, lamb; None for the others) and
    # ScaleByScheduleState.count: int32 scalars on the model's device.
    count: "torch.Tensor | None"
    sched_count: torch.Tensor
    # The family's moments (optim.MOMENTS), keyed like
    # ``model.named_parameters()``; None where the family has none: Adam's
    # mu and nu (adamw, lamb), the RMS nu (rmsprop), the momentum trace
    # (sgdm, rmsprop).
    mu: "dict[str, torch.Tensor] | None"
    nu: "dict[str, torch.Tensor] | None"
    # EMA shadow of the parameters (None when train.ema_decay == 0).
    ema: "dict[str, torch.Tensor] | None" = None
    trace: "dict[str, torch.Tensor] | None" = None
    optimizer: str = "adamw"


def moments(state) -> "dict[str, dict[str, torch.Tensor]]":
    """The state's moments by name (``optim.MOMENTS`` of its family)."""
    return {name: getattr(state, name)
            for name in optim.MOMENTS[state.optimizer]}


def _opt_fields(family: str, params: "dict[str, torch.Tensor]",
                device) -> dict:
    """Zero moments and counts of ``family`` for ``params`` (rmsprop's
    nu starts at optax's ``initial_scale`` 0 too)."""
    optim.check_family(family)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    fields = {"mu": None, "nu": None, "trace": None, "optimizer": family,
              "count": zero.clone() if family in optim.COUNTED else None,
              "sched_count": zero.clone()}
    for name in optim.MOMENTS[family]:
        fields[name] = {k: torch.zeros_like(p) for k, p in params.items()}
    return fields


def create_state(cfg: ExperimentConfig, model: nn.Module,
                 device: "str | torch.device") -> TrainState:
    """A fresh state around ``model`` (weights already set), moved to
    ``device`` with channels_last convolution weights: zero moments and
    counts of ``train.optimizer``'s family, and the EMA shadow starting
    at the params when carried."""
    model = model.to(device, memory_format=torch.channels_last)
    params = dict(model.named_parameters())
    return TrainState(
        step=0, model=model,
        ema=({k: p.detach().clone() for k, p in params.items()}
             if cfg.train.ema_decay > 0 else None),
        **_opt_fields(cfg.train.optimizer, params, device),
    )


def _cosine(init_value: float, decay_steps: int) -> Callable:
    """optax.cosine_decay_schedule(init_value, decay_steps) in float32."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive steps, got "
                         f"{decay_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.minimum(count.float(), torch.tensor(
            float(decay_steps), device=count.device))
        decayed = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * decayed

    return schedule


def make_schedule(tc: TrainConfig) -> Callable:
    """count (int tensor) -> float32 learning rate, with optax's
    semantics for constant, cosine and warmup_cosine (warmup clamped into
    the run, as ``train_lib.py:120-138``)."""
    if tc.lr_schedule == "constant":
        return lambda count: torch.full((), tc.learning_rate,
                                        dtype=torch.float32,
                                        device=count.device)
    if tc.lr_schedule == "cosine":
        return _cosine(tc.learning_rate, tc.steps)
    if tc.lr_schedule == "warmup_cosine":
        warmup = max(1, min(tc.warmup_steps, tc.steps - 1))
        if warmup != tc.warmup_steps:
            _log.warning("warmup_steps=%d does not fit in steps=%d; "
                         "clamped to %d", tc.warmup_steps, tc.steps, warmup)
        peak = tc.learning_rate
        decay = _cosine(peak, tc.steps - warmup)

        def schedule(count: torch.Tensor) -> torch.Tensor:
            frac = 1 - torch.clamp(count, 0, warmup).float() / warmup
            linear = (0.0 - peak) * frac + peak
            return torch.where(count < warmup, linear, decay(count - warmup))

        return schedule
    raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")


def global_batch(cfg: ExperimentConfig) -> int:
    """The batch the optimizer sees per update: ``data.batch_size``,
    which factors as ``accum_steps`` x the per-forward batch x the data
    ways (the mesh's ranks). The large-batch rule scales against it."""
    return int(cfg.data.batch_size)


def resolve_large_batch(cfg: ExperimentConfig,
                        mesh: "mesh_lib.Mesh | None" = None
                        ) -> ExperimentConfig:
    """Linear learning-rate scaling tied to the global batch
    (``train.lr_scale_ref_batch``): the effective peak learning rate is
    ``learning_rate * global_batch / lr_scale_ref_batch``, logged with
    its factorization (the data ways are the mesh's). A pure function of
    the config and the mesh, applied once at fit entry, so a resume
    derives the same rate; 0 (the default) returns ``cfg`` unchanged.
    Warns when the scale is not 1 and the schedule is not
    ``warmup_cosine``."""
    ref = int(cfg.train.lr_scale_ref_batch)
    if ref <= 0:
        return cfg
    gb = global_batch(cfg)
    scale = gb / ref
    ways = 1
    if mesh is not None:
        ways = int(mesh.shape[mesh_lib._batch_axis(mesh)])
    accum = max(1, int(cfg.train.accum_steps))
    eff_lr = cfg.train.learning_rate * scale
    _log.info("large-batch recipe: global batch %d (= %d accum x %d device "
              "batch x %d data ways), LR %g x %.3g -> %g (%s)",
              gb, accum, gb // (accum * ways), ways, cfg.train.learning_rate,
              scale, eff_lr, cfg.train.optimizer)
    if scale != 1.0 and cfg.train.lr_schedule not in ("warmup_cosine",):
        _log.warning(
            "lr_scale_ref_batch scaled the peak LR %.3gx under "
            "lr_schedule=%s: scaled-LR recipes want warmup_cosine (a cold "
            "start at the scaled LR is the classic large-batch divergence "
            "mode)", scale, cfg.train.lr_schedule)
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, learning_rate=eff_lr))


def _labels_from_grades(grades: torch.Tensor, head: str) -> torch.Tensor:
    """The head's labels: ICDR grade >= 2 (referable DR) as float for the
    binary head, the grade itself (int64 class index) for ``multi``."""
    if head == "binary":
        return (grades >= 2).float()
    return grades.long()


def _sigmoid_bce(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE of logits ``x`` [B] against probabilities."""
    return (-target * F.logsigmoid(x)
            - (1.0 - target) * F.logsigmoid(-x)).mean()


def _softmax_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of [B, C] logits against [B, C]
    distributions."""
    return -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def _head_loss(logits: torch.Tensor, labels: torch.Tensor, head: str,
               smoothing: float) -> torch.Tensor:
    """Mean loss of one head, written as optax writes it. Binary: sigmoid
    BCE against ``labels * (1 - s) + 0.5 * s``. Multi: softmax cross
    entropy against the one-hot labels smoothed as ``optax.smooth_labels``
    does, ``onehot * (1 - s) + s / C``."""
    if head == "binary":
        target = labels * (1.0 - smoothing) + 0.5 * smoothing
        return _sigmoid_bce(logits[:, 0], target)
    target = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    if smoothing > 0:
        target = target * (1.0 - smoothing) + smoothing / logits.shape[-1]
    return _softmax_ce(logits, target)


def _distill_loss(logits: torch.Tensor, soft: torch.Tensor,
                  head: str) -> torch.Tensor:
    """Soft-target loss against the teacher's averaged scores
    (``train.distill_from``): the binary head's sigmoid BCE against the
    probability [B], the multi head's softmax cross entropy against the
    teacher's [B, C] distribution. No label smoothing: the teacher's
    scores are already soft."""
    if head == "binary":
        return _sigmoid_bce(logits[:, 0], soft)
    return _softmax_ce(logits, soft)


def loss_fn(logits: torch.Tensor, aux: "torch.Tensor | None",
            grades: torch.Tensor, cfg: ExperimentConfig,
            soft: "torch.Tensor | None" = None) -> torch.Tensor:
    """Head loss plus ``model.aux_weight`` times the aux head's loss, both
    under ``model.head``: against the grades, or with ``soft`` (the
    teacher's scores) the soft-target loss in their place, computed in
    float32."""
    head = cfg.model.head
    if soft is not None:
        logits = logits.float()
        loss = _distill_loss(logits, soft, head)
        if aux is not None:
            loss = loss + cfg.model.aux_weight * _distill_loss(
                aux.float(), soft, head)
        return loss
    labels = _labels_from_grades(grades, head)
    smoothing = cfg.train.label_smoothing
    loss = _head_loss(logits, labels, head, smoothing)
    if aux is not None:
        loss = loss + cfg.model.aux_weight * _head_loss(aux, labels, head,
                                                        smoothing)
    return loss


def step_generators(seed: int, step: int, device) -> "tuple":
    """(augment, dropout) generators on ``device`` for this step, seeded
    from (seed, step): the same step draws the same numbers on any
    resume, as ``fold_in(base_key, step)`` does in the reference."""
    seeds = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)


def micro_generator(seed: int, step: int, micro: int, device
                    ) -> torch.Generator:
    """Dropout generator of micro-batch ``micro`` of a step under
    ``train.accum_steps`` > 1, seeded from (seed, step, micro)."""
    s = np.random.SeedSequence([int(seed), int(step), int(micro)])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, dtype=np.uint64)[0]))


def _forward(model: nn.Module, images: torch.Tensor, generator,
             tc: TrainConfig):
    """Train forward of NHWC ``images``; under ``train.dtype=bf16`` on a
    bfloat16 cast of every floating parameter, made under autograd so
    the cast's backward returns float32 gradients to the masters. The
    BatchNorm running statistics are buffers and stay float32."""
    # NHWC float32 seen as NCHW: a channels_last view, no copy.
    x = images.permute(0, 3, 1, 2)
    kwargs = {"train": True, "generator": generator}
    if tc.dtype != "bf16":
        return model(x, **kwargs)
    view = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()
            if p.is_floating_point()}
    return torch.func.functional_call(model, view, (x,), kwargs)


def compute_grads(state: TrainState, batch: dict, cfg: ExperimentConfig,
                  augment_params: "dict | None" = None,
                  mesh: "mesh_lib.Mesh | None" = None
                  ) -> "tuple[torch.Tensor, list[torch.Tensor]]":
    """The loss (0-d, on the device) and one float32 gradient per
    parameter (``model.parameters()`` order, each in its parameter's
    layout) of one step on ``batch``, without the update. The augment
    runs once on the whole batch; under ``train.accum_steps`` > 1 the
    micro-batches then run in order, each with its own dropout
    generator, and the loss is the mean of theirs. The BatchNorm running
    statistics are updated in place, once per micro-batch. Under a data
    mesh of more than one rank, ``batch`` is this rank's rows
    (``_rank_grads``)."""
    tc = cfg.train
    model = state.model
    dev = state.sched_count.device
    accum = tc.accum_steps
    n = batch["image"].shape[0]
    if n % accum != 0:
        raise ValueError(f"train.accum_steps={accum} must divide the batch "
                         f"size {n} evenly")
    aug_gen, drop_gen = step_generators(tc.seed, state.step, dev)
    if mesh is not None and mesh.size > 1:
        return _rank_grads(state, batch, cfg, augment_params, mesh, aug_gen,
                           drop_gen)
    images = augment.augment_batch(
        aug_gen, batch["image"], cfg.data, fused=tc.use_pallas_fused,
        params=augment_params)
    grades = batch["grade"]
    soft = batch.get("soft")
    params = list(model.parameters())
    if accum == 1:
        logits, aux = _forward(model, images, drop_gen, tc)
        loss = loss_fn(logits, aux, grades, cfg, soft)
        loss.backward()
        grads = [p.grad for p in params]
        model.zero_grad(set_to_none=True)
        return loss.detach(), grads
    micro = n // accum
    grads = [torch.zeros_like(p) for p in params]
    losses = []
    for i in range(accum):
        rows = slice(i * micro, (i + 1) * micro)
        logits, aux = _forward(model, images[rows],
                               micro_generator(tc.seed, state.step, i, dev),
                               tc)
        loss = loss_fn(logits, aux, grades[rows], cfg,
                       None if soft is None else soft[rows])
        loss.backward()
        with torch.no_grad():
            for acc, p in zip(grads, params):
                acc.add_(p.grad * (1.0 / accum))
        model.zero_grad(set_to_none=True)
        losses.append(loss.detach())
    return torch.stack(losses).mean(), grads


def _rank_grads(state: TrainState, batch: dict, cfg: ExperimentConfig,
                augment_params: "dict | None", mesh: "mesh_lib.Mesh",
                aug_gen: torch.Generator, drop_gen: torch.Generator
                ) -> "tuple[torch.Tensor, list[torch.Tensor]]":
    """``compute_grads`` of one rank of a data mesh: ``batch`` is the
    rank's block of the global batch. The step's augment and dropout
    draws are the global batch's, from the step's generators (or
    ``augment_params``, global), and the rank takes its rows of them, so
    the ranks together draw what one process draws for the whole batch.
    The forward's BatchNorms take the global batch's moments (their
    ``mesh``); after the backward the gradients and the loss are
    averaged over the ranks in one flat all-reduce (the reference's
    ``pmean``). Accumulation and soft targets are refused across ranks
    (``trainer.check_mesh_knobs``)."""
    tc, model = cfg.train, state.model
    dev = state.sched_count.device
    n = batch["image"].shape[0] * mesh.size
    rows = mesh_lib.local_rows(n, mesh)
    if cfg.data.augment:
        if augment_params is None:
            augment_params = augment._draw_params(aug_gen, n, cfg.data, dev)
        augment_params = {k: v[rows] for k, v in augment_params.items()}
    images = augment.augment_batch(None, batch["image"], cfg.data,
                                   fused=tc.use_pallas_fused,
                                   params=augment_params)
    draws = common.Draws([
        torch.rand(shape, generator=drop_gen, device=dev)[rows]
        for shape in models.dropout_shapes(model, n)])
    params = list(model.parameters())
    logits, aux = _forward(model, images, draws, tc)
    loss = loss_fn(logits, aux, batch["grade"], cfg)
    loss.backward()
    grads = [p.grad for p in params]
    model.zero_grad(set_to_none=True)
    loss = loss.detach()
    mesh.all_reduce_mean_(grads + [loss])
    return loss, grads


def train_step(state: TrainState, batch: dict, cfg: ExperimentConfig,
               augment_params: "dict | None" = None,
               mesh: "mesh_lib.Mesh | None" = None) -> torch.Tensor:
    """One optimizer step in place on ``state``; returns the loss as a
    0-d tensor on the device (read it only when needed: reading waits for
    the card). ``batch`` holds ``image`` (uint8 NHWC) and ``grade`` on the
    model's device; ``augment_params`` replaces the augment draws. Under
    a data mesh of more than one rank, ``batch`` is this rank's rows, the
    state is this rank's replica (its model built with the mesh), and
    ``augment_params`` are the global batch's draws; the update runs on
    every replica from the averaged gradients, so the replicas stay
    equal."""
    tc = cfg.train
    loss, grads = compute_grads(state, batch, cfg, augment_params, mesh)
    _update(state, dict(state.model.named_parameters()), grads, tc, lead=0)
    return loss


def _update(state, params: "dict[str, torch.Tensor]", grads, tc, lead: int
            ) -> None:
    """The optimizer update and the EMA shadow in place, then the counts
    and the step: the tail of a step, single (``lead`` 0) or stacked
    (``lead`` 1)."""
    names = list(params)
    leaves = [params[k] for k in names]
    optim.apply_update(
        state.optimizer, tc, leaves, grads,
        {name: [m[k] for k in names] for name, m in moments(state).items()},
        state.count, state.sched_count, make_schedule(tc), lead=lead,
        fused=tc.use_pallas_fused)
    with torch.no_grad():
        if state.ema is not None:
            d = tc.ema_decay
            for k, p in zip(names, leaves):
                state.ema[k].mul_(d).add_(p * (1.0 - d))
    if state.count is not None:
        state.count += 1
    state.sched_count += 1
    state.step += 1


@dataclasses.dataclass
class Snapshot:
    """A copy of a train state on its device (``snapshot``) and the event
    recorded after the copies on the stream that made them (None on the
    CPU)."""
    state: TrainState
    event: "torch.cuda.Event | None"

    def wait(self) -> None:
        """Block until the copies are done: a thread that reads the
        snapshot calls this first, whatever stream it runs on."""
        if self.event is not None:
            self.event.synchronize()


def snapshot(state: "TrainState | EnsembleState") -> Snapshot:
    """A ``clone()`` of every tensor of ``state`` on its device (params,
    batch statistics, moments, the counts and the EMA shadow; a stacked
    state's too), taken on
    the current stream before the next step is issued, so a background
    save or eval reads this step's values while training updates the
    live state in place (the reference's ``_state_snapshot``)."""
    def clone(v):
        if isinstance(v, nn.Module):
            return copy.deepcopy(v)
        if isinstance(v, dict):
            return {k: t.clone() for k, t in v.items()}
        return v.clone() if isinstance(v, torch.Tensor) else v

    with torch.no_grad():
        copied = dataclasses.replace(state, **{
            f.name: clone(getattr(state, f.name))
            for f in dataclasses.fields(state)})
    event = None
    dev = state.sched_count.device
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return Snapshot(copied, event)


def eval_params(state: TrainState) -> "dict[str, torch.Tensor]":
    """The model's ``state_dict`` with the EMA shadow in place of the
    params when carried: what eval and serving score with."""
    sd = dict(state.model.state_dict())
    if state.ema is not None:
        sd.update(state.ema)
    return sd


def make_eval_step(cfg: ExperimentConfig, state: TrainState,
                   device: "str | torch.device | None" = None,
                   mesh: "mesh_lib.Mesh | None" = None) -> Callable:
    """uint8 images [B, S, S, 3] (numpy) -> float32 probabilities ([B],
    or [B, C] for ``multi``) of the state's eval params
    (``eval_params``) with its batch statistics: normalize, the eval
    forward (flip-averaged when ``eval.tta``), then
    ``models.head_probs``. It is the serving engine's forward over one
    member, made from a snapshot of the state; padding rows are scored
    and left for the caller to trim, as in the reference. Under a data
    mesh of more than one rank, ``images`` are this rank's block of the
    batch and the step returns the whole batch's probabilities on every
    rank (``Mesh.assemble``)."""
    # Evals are not serving traffic: a detached registry keeps serve.*
    # metrics out of the run's telemetry (the reference's eval step
    # records none), and an engine handed a registry leaves the process
    # tracer as the fit configured it.
    engine = ServingEngine(cfg, state_dicts=[eval_params(state)],
                           device=device,
                           registry=obs_registry.Registry(enabled=False),
                           faults=False)
    if mesh is None or mesh.size == 1:
        return lambda images: engine.member_probs(images)[0]

    def step(images):
        local = torch.from_numpy(engine.member_probs(images)[0])
        return mesh.assemble(local.to(mesh.device)).cpu().numpy()

    return step


# The flat form of a TrainState, as a checkpoint stores it: the model's
# ``params/...`` and ``batch_stats/...`` (the flat Flax tree,
# ``models/convert.torch_to_flax``), the family's optax-shaped state
# (``convert.port_to_optax``: adamw's ``adam/count``, ``adam/mu/...``,
# ``adam/nu/...``; lamb's ``lamb/...``; sgdm's ``trace/...``; rmsprop's
# ``rms/nu/...`` and ``trace/...``; every family's ``schedule/count``), the
# EMA shadow under ``utils.checkpoint.EMA_PREFIX`` + <params path> when
# carried, and ``step``.


def state_to_flat(state: TrainState) -> "dict[str, np.ndarray]":
    flat = convert.torch_to_flax(state.model)
    flat.update(convert.port_to_optax(
        state.optimizer, moments(state),
        None if state.count is None else int(state.count),
        int(state.sched_count)))
    if state.ema is not None:
        for k, v in convert.torch_to_flax(state.ema).items():
            flat[ckpt_lib.EMA_PREFIX + k.split("/", 1)[1]] = v
    flat["step"] = np.asarray(state.step, np.int64)
    return flat


def load_state_flat(state: TrainState,
                    flat: "dict[str, np.ndarray]") -> TrainState:
    """Fill ``state`` (made by ``create_state`` for the same config) in
    place from ``flat``; every value is copied exactly. The EMA shadow
    must be carried on both sides or on neither, and the optimizer
    family must be the same: a checkpoint of another family raises,
    naming both."""
    model = state.model
    has_ema = ckpt_lib.has_ema(flat)
    if has_ema != (state.ema is not None):
        raise ValueError(
            f"the saved state {'carries' if has_ema else 'lacks'} an EMA "
            f"shadow but this state {'does not' if has_ema else 'does'}")
    opt_flat = {k: v for k, v in flat.items()
                if k.startswith(convert.OPT_ROOTS)}
    family = convert.optax_family(opt_flat)
    if family != state.optimizer:
        raise ValueError(
            f"the saved state holds the {family} optimizer's state but this "
            f"run trains with train.optimizer={state.optimizer}: resume "
            "with the optimizer that wrote the checkpoint")
    with torch.no_grad():
        model.load_state_dict(convert.flax_to_torch(
            {k: v for k, v in flat.items()
             if k.startswith(("params/", "batch_stats/"))}, model))
        opt = convert.optax_to_port(opt_flat, model, family)
        for name, saved in opt["moments"].items():
            for k, t in getattr(state, name).items():
                t.copy_(saved[k])
        if state.count is not None:
            state.count.fill_(opt["count"])
        state.sched_count.fill_(opt["sched_count"])
        if has_ema:
            ema = convert.flax_to_torch(ckpt_lib.eval_tree(flat), model)
            for k in state.ema:
                state.ema[k].copy_(ema[k])
    state.step = int(flat["step"])
    return state


# ---------------------------------------------------------------------------
# Member-parallel ensembles
# ---------------------------------------------------------------------------
#
# Member m keeps the sequential driver's seed (train.seed + m) for its
# init, augment and dropout draws; all members see one batch stream (the
# train.seed stream), as in the reference's member-parallel form.


@dataclasses.dataclass
class EnsembleState:
    """k members' train states stacked: every tensor of ``TrainState``
    gains a leading member dimension, ``params`` (leaves that take
    gradients) and ``buffers`` (the BatchNorm running statistics) keyed
    like the member model's ``named_parameters`` / ``named_buffers``.
    ``model`` is a weightless skeleton (on the meta device) that
    ``torch.func.functional_call`` fills with one member's tensors. The
    counts are shared: all members step together."""
    step: int
    model: nn.Module
    seeds: "list[int]"
    params: "dict[str, torch.Tensor]"
    buffers: "dict[str, torch.Tensor]"
    count: "torch.Tensor | None"
    sched_count: torch.Tensor
    mu: "dict[str, torch.Tensor] | None"
    nu: "dict[str, torch.Tensor] | None"
    ema: "dict[str, torch.Tensor] | None" = None
    trace: "dict[str, torch.Tensor] | None" = None
    optimizer: str = "adamw"

    @property
    def k(self) -> int:
        return len(self.seeds)


def stack_states(states: "list[TrainState]", seeds: "list[int]",
                 device: "str | torch.device") -> EnsembleState:
    """Stack k single-member states (one config, one step) into one
    ``EnsembleState`` on ``device``; the inverse of ``unstack_member``.
    Unlike the reference's serving-side ``stack_states``, the optimizer
    state is kept: this state trains."""
    if not states or len(states) != len(seeds):
        raise ValueError("need one state per member seed, at least one")
    first = states[0]
    for s in states[1:]:
        if (s.step, s.optimizer, s.ema is None) != (
                first.step, first.optimizer, first.ema is None):
            raise ValueError("member states disagree on step, optimizer or "
                             "EMA shadow")

    def stack(dicts):
        return {k: torch.stack([d[k] for d in dicts]).to(device)
                for k in dicts[0]}

    with torch.no_grad():
        params = stack([dict(s.model.named_parameters()) for s in states])
        fields = {name: (None if getattr(first, name) is None
                         else stack([getattr(s, name) for s in states]))
                  for name in ("mu", "nu", "trace", "ema")}
        return EnsembleState(
            step=first.step,
            model=copy.deepcopy(first.model).to("meta"),
            seeds=[int(x) for x in seeds],
            params={k: v.requires_grad_() for k, v in params.items()},
            buffers=stack([dict(s.model.named_buffers()) for s in states]),
            count=None if first.count is None else first.count.to(device),
            sched_count=first.sched_count.to(device),
            optimizer=first.optimizer, **fields)


def create_ensemble_state(cfg: ExperimentConfig, seeds: "list[int]",
                          device: "str | torch.device") -> EnsembleState:
    """The stacked state of ``len(seeds)`` fresh members: member m is the
    state ``create_state`` makes under seed ``seeds[m]`` (the same init
    the sequential driver's ``fit`` draws), stacked on ``device``.
    ``train.use_pallas_fused`` is refused, as the reference refuses it:
    the fused step path is a single-model path."""
    check_ensemble_knobs(cfg.train)
    return stack_states(
        [create_state(cfg, init.init_flax_default(models.build(cfg.model),
                                                  s), "cpu")
         for s in seeds], seeds, device)


def check_ensemble_knobs(tc: TrainConfig) -> None:
    """The reference's refusals of the stacked step."""
    configs.validate_train_knobs(tc)
    if tc.use_pallas_fused:
        raise ValueError(
            "train.use_pallas_fused is a single-model step path; the "
            "member-parallel ensemble step runs every member in one vmap "
            "and does not batch kernels B2 and B3: unset one of the two")


def unstack_member(state: EnsembleState, m: int) -> TrainState:
    """Member m's single-model ``TrainState``, on the CPU (a copy): the
    per-member checkpoint layout is the sequential driver's."""
    model = copy.deepcopy(state.model).to_empty(device="cpu")
    with torch.no_grad():
        model.load_state_dict({k: v[m].detach().cpu() for k, v in
                               {**state.params, **state.buffers}.items()})

    def pick(d):
        return None if d is None else {k: v[m].detach().cpu()
                                       for k, v in d.items()}

    return TrainState(
        step=state.step, model=model,
        count=None if state.count is None else state.count.cpu(),
        sched_count=state.sched_count.cpu(), mu=pick(state.mu),
        nu=pick(state.nu), ema=pick(state.ema), trace=pick(state.trace),
        optimizer=state.optimizer)


def _member_draws(shapes, gens, device) -> "list[torch.Tensor]":
    """[k, *shape] uniform draws per shape, member m's from its own
    generator in the forward's order (``models.dropout_shapes``)."""
    per_member = [[torch.rand(s, generator=g, device=device) for s in shapes]
                  for g in gens]
    return [torch.stack(ts) for ts in zip(*per_member)] if shapes else []


def ensemble_train_step(state: EnsembleState, batch: dict,
                        cfg: ExperimentConfig,
                        augment_params: "list[dict] | None" = None
                        ) -> torch.Tensor:
    """One step of all k members in place on ``state``; returns the [k]
    losses on the device. Member m draws its augment and dropout from
    (``seeds[m]``, step), as a sequential member does. The augment runs
    once over the k x B stacked images, every member's draws
    concatenated (one B1 launch under ``data.use_pallas``); then one
    forward and backward of every member under ``torch.func.vmap``
    (convolutions batched as grouped convolutions, each member's
    BatchNorm running statistics updated in its slice), micro-batch by
    micro-batch under ``train.accum_steps``; then the family's update
    with every norm per member. ``augment_params`` (one dict per member)
    replaces the augment draws. Float-equivalent to the members stepped
    in turn, not bitwise."""
    tc = cfg.train
    check_ensemble_knobs(tc)
    k, dev = state.k, state.sched_count.device
    images_u8, grades = batch["image"], batch["grade"]
    n = images_u8.shape[0]
    accum = tc.accum_steps
    if n % accum != 0:
        raise ValueError(f"train.accum_steps={accum} must divide the batch "
                         f"size {n} evenly")
    gens = [step_generators(s, state.step, dev) for s in state.seeds]
    stacked_params = None
    if cfg.data.augment:
        if augment_params is None:
            augment_params = [augment._draw_params(g, n, cfg.data, dev)
                              for g, _ in gens]
        stacked_params = {key: torch.cat([p[key] for p in augment_params])
                          for key in augment_params[0]}
    images = augment.augment_batch(
        None, images_u8.repeat(k, 1, 1, 1), cfg.data,
        params=stacked_params).view(k, n, *images_u8.shape[1:])
    shapes = models.dropout_shapes(state.model, n // accum)

    def member_loss(params, buffers, imgs, draws, member_grades):
        # NHWC seen as NCHW: a channels_last view of each member's batch.
        logits, aux = torch.func.functional_call(
            state.model, {**params, **buffers}, (imgs.permute(0, 3, 1, 2),),
            {"train": True, "generator": common.Draws(draws)}, strict=True)
        return loss_fn(logits, aux, member_grades, cfg)

    stacked_loss = torch.func.vmap(member_loss,
                                   in_dims=(0, 0, 0, 0, None))
    names = list(state.params)
    grads = None
    losses = []
    micro = n // accum
    for i in range(accum):
        rows = slice(i * micro, (i + 1) * micro)
        micro_gens = ([g for _, g in gens] if accum == 1 else
                      [micro_generator(s, state.step, i, dev)
                       for s in state.seeds])
        view = state.params
        if tc.dtype == "bf16":
            view = {key: p.to(torch.bfloat16) for key, p in view.items()}
        loss = stacked_loss(view, state.buffers, images[:, rows],
                            _member_draws(shapes, micro_gens, dev),
                            grades[rows])
        loss.sum().backward()
        with torch.no_grad():
            if accum == 1:
                grads = [state.params[key].grad for key in names]
            elif grads is None:
                grads = [state.params[key].grad * (1.0 / accum)
                         for key in names]
            else:
                for acc, key in zip(grads, names):
                    acc.add_(state.params[key].grad * (1.0 / accum))
        for p in state.params.values():
            p.grad = None
        losses.append(loss.detach())
    _update(state, state.params, grads, tc, lead=1)
    return losses[0] if accum == 1 else torch.stack(losses).mean(dim=0)


def eval_state_dicts(state: EnsembleState) -> "list[dict[str, torch.Tensor]]":
    """Each member's eval ``state_dict`` (views into the stacked state):
    its EMA shadow in place of the params when carried, and its
    statistics."""
    tensors = {**{k: v.detach() for k, v in state.params.items()},
               **state.buffers, **(state.ema or {})}
    return [{k: v[m] for k, v in tensors.items()} for m in range(state.k)]


def make_ensemble_eval_step(cfg: ExperimentConfig, state: EnsembleState,
                            device: "str | torch.device | None" = None
                            ) -> Callable:
    """uint8 images [B, S, S, 3] (numpy) -> [k, B] (or [k, B, C])
    probabilities of every member's eval params: one forward of all k
    members under ``torch.func.vmap`` (the serving engine's
    ``member_parallel`` form in float32), the counterpart of the
    reference's ``make_ensemble_eval_step``."""
    eval_cfg = cfg.replace(serve=dataclasses.replace(
        cfg.serve, member_parallel=True, dtype="fp32"))
    engine = ServingEngine(eval_cfg, state_dicts=eval_state_dicts(state),
                           device=device,
                           registry=obs_registry.Registry(enabled=False),
                           faults=False)
    return engine.member_probs
