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
The optimizer is the plain AdamW (``ops/adamw.adamw_reference``,
optax's adamw with the rank >= 2 decay mask) or, with
``train.use_pallas_fused``, kernel B3 (``ops/adamw.fused_adamw_update``);
the augment goes through kernel B1 (``data.use_pallas``) or B2 (fused).

The state mirrors the reference's ``TrainState`` and optax's adamw state:
the step, the model (params and batch statistics), the Adam count and
moments, the schedule's count and the EMA shadow. Counts and moments live
on the model's device, so a step reads no host value. ``state_to_flat``
and ``load_state_flat`` carry the whole state to and from the flat numpy
dict a checkpoint stores.
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

from jama16_retina_tpu_torch.configs import ExperimentConfig, TrainConfig
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.ops import adamw
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

_log = logging.getLogger(__name__)


class DtypeCurveRejected(RuntimeError):
    """A ``train.dtype=bf16`` run drifted beyond ``train.dtype_curve_tol``
    of the pinned fp32 curve (``train.dtype_curve_ref``) at an eval step:
    the run stops with the step and both AUCs named (the reference's
    ``train_lib.DtypeCurveRejected``)."""


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    # optax ScaleByAdamState.count and ScaleByScheduleState.count: int32
    # scalars on the model's device.
    count: torch.Tensor
    sched_count: torch.Tensor
    # Adam moments, keyed like ``model.named_parameters()``.
    mu: "dict[str, torch.Tensor]"
    nu: "dict[str, torch.Tensor]"
    # EMA shadow of the parameters (None when train.ema_decay == 0).
    ema: "dict[str, torch.Tensor] | None" = None


def create_state(cfg: ExperimentConfig, model: nn.Module,
                 device: "str | torch.device") -> TrainState:
    """A fresh state around ``model`` (weights already set), moved to
    ``device`` with channels_last convolution weights: zero moments and
    counts, and the EMA shadow starting at the params when carried."""
    model = model.to(device, memory_format=torch.channels_last)
    params = dict(model.named_parameters())
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(
        step=0, model=model, count=zero.clone(), sched_count=zero.clone(),
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        ema=({k: p.detach().clone() for k, p in params.items()}
             if cfg.train.ema_decay > 0 else None),
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


def _labels_from_grades(grades: torch.Tensor, head: str) -> torch.Tensor:
    """The head's labels: ICDR grade >= 2 (referable DR) as float for the
    binary head, the grade itself (int64 class index) for ``multi``."""
    if head == "binary":
        return (grades >= 2).float()
    return grades.long()


def _head_loss(logits: torch.Tensor, labels: torch.Tensor, head: str,
               smoothing: float) -> torch.Tensor:
    """Mean loss of one head, written as optax writes it. Binary: sigmoid
    BCE against ``labels * (1 - s) + 0.5 * s``. Multi: softmax cross
    entropy against the one-hot labels smoothed as ``optax.smooth_labels``
    does, ``onehot * (1 - s) + s / C``."""
    if head == "binary":
        target = labels * (1.0 - smoothing) + 0.5 * smoothing
        x = logits[:, 0]
        per_ex = (-target * F.logsigmoid(x)
                  - (1.0 - target) * F.logsigmoid(-x))
        return per_ex.mean()
    target = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    if smoothing > 0:
        target = target * (1.0 - smoothing) + smoothing / logits.shape[-1]
    return -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def loss_fn(logits: torch.Tensor, aux: "torch.Tensor | None",
            grades: torch.Tensor, cfg: ExperimentConfig) -> torch.Tensor:
    """Head loss plus ``model.aux_weight`` times the aux head's loss, both
    under ``model.head``."""
    head = cfg.model.head
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


def decay_flags(model: nn.Module) -> "list[bool]":
    """Decoupled weight decay on rank >= 2 leaves only (conv and Dense
    kernels), as ``train_lib._decay_mask``."""
    return [p.ndim >= 2 for p in model.parameters()]


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
                  augment_params: "dict | None" = None
                  ) -> "tuple[torch.Tensor, list[torch.Tensor]]":
    """The loss (0-d, on the device) and one float32 gradient per
    parameter (``model.parameters()`` order, each in its parameter's
    layout) of one step on ``batch``, without the update. The augment
    runs once on the whole batch; under ``train.accum_steps`` > 1 the
    micro-batches then run in order, each with its own dropout
    generator, and the loss is the mean of theirs. The BatchNorm running
    statistics are updated in place, once per micro-batch."""
    tc = cfg.train
    model = state.model
    dev = state.count.device
    accum = tc.accum_steps
    n = batch["image"].shape[0]
    if n % accum != 0:
        raise ValueError(f"train.accum_steps={accum} must divide the batch "
                         f"size {n} evenly")
    aug_gen, drop_gen = step_generators(tc.seed, state.step, dev)
    images = augment.augment_batch(
        aug_gen, batch["image"], cfg.data, fused=tc.use_pallas_fused,
        params=augment_params)
    grades = batch["grade"]
    params = list(model.parameters())
    if accum == 1:
        logits, aux = _forward(model, images, drop_gen, tc)
        loss = loss_fn(logits, aux, grades, cfg)
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
        loss = loss_fn(logits, aux, grades[rows], cfg)
        loss.backward()
        with torch.no_grad():
            for acc, p in zip(grads, params):
                acc.add_(p.grad * (1.0 / accum))
        model.zero_grad(set_to_none=True)
        losses.append(loss.detach())
    return torch.stack(losses).mean(), grads


def train_step(state: TrainState, batch: dict, cfg: ExperimentConfig,
               augment_params: "dict | None" = None) -> torch.Tensor:
    """One optimizer step in place on ``state``; returns the loss as a
    0-d tensor on the device (read it only when needed: reading waits for
    the card). ``batch`` holds ``image`` (uint8 NHWC) and ``grade`` on the
    model's device; ``augment_params`` replaces the augment draws."""
    tc = cfg.train
    model = state.model
    loss, grads = compute_grads(state, batch, cfg, augment_params)
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    scalars = adamw.adamw_scalars(state.count, state.sched_count,
                                  make_schedule(tc))
    update = (adamw.fused_adamw_update if tc.use_pallas_fused
              else adamw.adamw_reference)
    with torch.no_grad():
        update(params, grads, [state.mu[k] for k in names],
               [state.nu[k] for k in names], decay_flags(model), scalars,
               tc.weight_decay)
        if state.ema is not None:
            d = tc.ema_decay
            for k, p in zip(names, params):
                state.ema[k].mul_(d).add_(p * (1.0 - d))
    state.count += 1
    state.sched_count += 1
    state.step += 1
    return loss


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


def snapshot(state: TrainState) -> Snapshot:
    """A ``clone()`` of every tensor of ``state`` on its device (params,
    batch statistics, moments, both counts and the EMA shadow), taken on
    the current stream before the next step is issued, so a background
    save or eval reads this step's values while training updates the
    live state in place (the reference's ``_state_snapshot``)."""
    with torch.no_grad():
        copied = TrainState(
            step=state.step, model=copy.deepcopy(state.model),
            count=state.count.clone(), sched_count=state.sched_count.clone(),
            mu={k: v.clone() for k, v in state.mu.items()},
            nu={k: v.clone() for k, v in state.nu.items()},
            ema=(None if state.ema is None
                 else {k: v.clone() for k, v in state.ema.items()}))
    event = None
    if state.count.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(state.count.device))
    return Snapshot(copied, event)


def eval_params(state: TrainState) -> "dict[str, torch.Tensor]":
    """The model's ``state_dict`` with the EMA shadow in place of the
    params when carried: what eval and serving score with."""
    sd = dict(state.model.state_dict())
    if state.ema is not None:
        sd.update(state.ema)
    return sd


def make_eval_step(cfg: ExperimentConfig, state: TrainState,
                   device: "str | torch.device | None" = None) -> Callable:
    """uint8 images [B, S, S, 3] (numpy) -> float32 probabilities ([B],
    or [B, C] for ``multi``) of the state's eval params
    (``eval_params``) with its batch statistics: normalize, the eval
    forward (flip-averaged when ``eval.tta``), then
    ``models.head_probs``. It is the serving engine's forward over one
    member, made from a snapshot of the state; padding rows are scored
    and left for the caller to trim, as in the reference."""
    engine = ServingEngine(cfg, state_dicts=[eval_params(state)],
                           device=device)
    return lambda images: engine.member_probs(images)[0]


# The flat form of a TrainState, as a checkpoint stores it: the model's
# ``params/...`` and ``batch_stats/...`` (the flat Flax tree,
# ``models/convert.torch_to_flax``), the optax-shaped AdamW state
# (``adam/count``, ``adam/mu/...``, ``adam/nu/...``, ``schedule/count``,
# ``convert.port_to_optax_adamw``), the EMA shadow under
# ``utils.checkpoint.EMA_PREFIX`` + <params path> when carried, and
# ``step``.


def state_to_flat(state: TrainState) -> "dict[str, np.ndarray]":
    flat = convert.torch_to_flax(state.model)
    flat.update(convert.port_to_optax_adamw(
        state.mu, state.nu, int(state.count), int(state.sched_count)))
    if state.ema is not None:
        for k, v in convert.torch_to_flax(state.ema).items():
            flat[ckpt_lib.EMA_PREFIX + k.split("/", 1)[1]] = v
    flat["step"] = np.asarray(state.step, np.int64)
    return flat


def load_state_flat(state: TrainState,
                    flat: "dict[str, np.ndarray]") -> TrainState:
    """Fill ``state`` (made by ``create_state`` for the same config) in
    place from ``flat``; every value is copied exactly. The EMA shadow
    must be carried on both sides or on neither."""
    model = state.model
    has_ema = ckpt_lib.has_ema(flat)
    if has_ema != (state.ema is not None):
        raise ValueError(
            f"the saved state {'carries' if has_ema else 'lacks'} an EMA "
            f"shadow but this state {'does not' if has_ema else 'does'}")
    with torch.no_grad():
        model.load_state_dict(convert.flax_to_torch(
            {k: v for k, v in flat.items()
             if k.startswith(("params/", "batch_stats/"))}, model))
        opt = convert.optax_adamw_to_port(
            {k: v for k, v in flat.items()
             if k.startswith(("adam/", "schedule/"))}, model)
        for k in state.mu:
            state.mu[k].copy_(opt["mu"][k])
            state.nu[k].copy_(opt["nu"][k])
        state.count.fill_(opt["count"])
        state.sched_count.fill_(opt["sched_count"])
        if has_ema:
            ema = convert.flax_to_torch(ckpt_lib.eval_tree(flat), model)
            for k in state.ema:
                state.ema[k].copy_(ema[k])
    state.step = int(flat["step"])
    return state
