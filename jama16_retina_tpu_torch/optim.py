"""The optimizer families of the train step (counterpart of
``jama16_retina_tpu/train_lib.py``: ``make_optimizer`` and
``_decay_mask``).

Each family is the optax 0.2.6 chain the JAX package builds, written out
operation by operation in float32, in optax's order, with the learning
rate from ``train_lib.make_schedule``; the decay mask is "rank >= 2"
(conv and Dense kernels) throughout:

- ``adamw``: ``optax.adamw`` (``ops/adamw.py``: the plain version, or
  kernel B3 under ``train.use_pallas_fused``);
- ``sgdm``: ``chain(add_decayed_weights(wd, mask), trace(momentum,
  nesterov=True), scale_by_learning_rate)``. The decay is coupled: it is
  added to the gradient before the momentum; the trace is ``t = u + m t``
  and the update ``u + m t``;
- ``rmsprop``: ``chain(add_decayed_weights(wd, mask), scale_by_rms(0.9,
  eps=1.0, initial_scale=0, eps_in_sqrt=True), scale_by_learning_rate,
  trace(momentum))``: eps sits inside the root, ``u * rsqrt(nu + 1)``,
  and the momentum trace runs after the learning rate, so it accumulates
  lr-scaled updates (``torch.optim.RMSprop`` does both otherwise);
- ``lamb``: ``chain(scale_by_adam(0.9, 0.999, eps=1e-6, eps_root=0),
  add_decayed_weights(wd, mask), scale_by_trust_ratio(),
  scale_by_learning_rate)``: the trust ratio is ``|p| / |u|`` per leaf,
  and 1 where either norm is 0.

``train.gradient_clip_norm`` > 0 chains ``clip_by_global_norm`` first:
``g`` if ``|g| < c`` else ``(g / |g|) * c``, over all leaves together.

The element-wise operations run as ``torch._foreach_*`` calls over every
leaf at once, each one optax operation with one rounding; a norm is the
square root of a sum of squares, the squares one multi-tensor launch and
each leaf's sum one reduction (in another order than XLA's, as any would
be); the clip's select and the trust ratio's product take one launch per
leaf. On a stacked ensemble state (``lead=1``: every leaf
carries a leading member dimension) every norm is taken per member, over
the dimensions after the first, and the decay mask reads the member
leaf's rank. These families have no hand kernel: in the JAX package they
are optax compositions that XLA fuses, with no Pallas kernel behind them.
"""

from __future__ import annotations

import torch

from jama16_retina_tpu_torch.ops import adamw

FAMILIES = ("adamw", "sgdm", "rmsprop", "lamb")
# The per-leaf tensors of each family's state, and whether it carries the
# Adam count (``ScaleByAdamState.count``); every family has the schedule's.
MOMENTS = {"adamw": ("mu", "nu"), "sgdm": ("trace",),
           "rmsprop": ("nu", "trace"), "lamb": ("mu", "nu")}
COUNTED = ("adamw", "lamb")
# optax.rmsprop's decay and eps as make_optimizer passes them.
RMS_DECAY, RMS_EPS = 0.9, 1.0
# optax.lamb's defaults.
LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6


def check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown optimizer {family!r} (want one of "
                         f"{FAMILIES})")


def decay_flags(params, lead: int = 0) -> "list[bool]":
    """``_decay_mask``: decay on leaves of rank >= 2 (of the member leaf:
    a stacked leaf's rank less ``lead``)."""
    return [p.ndim - lead >= 2 for p in params]


def _sum_squares(tensors, lead: int) -> torch.Tensor:
    """The sum of squares of each leaf, stacked: [L], or [L, k] per member
    when ``lead`` = 1. The squares are one multi-tensor launch; each
    leaf's sum is its own reduction, which sums pairwise on the CPU
    (``torch._foreach_norm`` and ``vector_norm`` accumulate float32 in
    one pass there: 3e-5 off at two million elements)."""
    squares = torch._foreach_mul(tensors, tensors)
    return torch.stack([s.sum() if lead == 0 else s.flatten(1).sum(1)
                        for s in squares])


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-d or [k] value shaped to broadcast over a (stacked) leaf."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def clip_by_global_norm(grads, max_norm: float, lead: int = 0
                        ) -> "list[torch.Tensor]":
    """``optax.clip_by_global_norm``: the leaves unchanged when their
    global norm is below ``max_norm``, else each ``(g / norm) * max_norm``
    (per member on a stacked state)."""
    norm = _sum_squares(grads, lead).sum(dim=0).sqrt()
    keep = norm < max_norm
    if lead == 0:
        scaled = torch._foreach_mul(torch._foreach_div(grads, norm),
                                    max_norm)
    else:
        scaled = [(g / _per_member(norm, g)) * max_norm for g in grads]
    return [torch.where(_per_member(keep, g), g, s)
            for g, s in zip(grads, scaled)]


def _add_decayed_weights(updates, params, decay, weight_decay: float):
    """``add_decayed_weights(wd, mask)``: ``u + wd * p`` on the masked
    leaves, two roundings (a new list; ``updates`` stay as they were)."""
    out = list(updates)
    idx = [i for i, d in enumerate(decay) if d]
    if idx and weight_decay:
        scaled = torch._foreach_mul([params[i] for i in idx], weight_decay)
        summed = torch._foreach_add([updates[i] for i in idx], scaled)
        for i, s in zip(idx, summed):
            out[i] = s
    return out


def _trace(updates, trace, momentum: float, nesterov: bool):
    """``optax.trace``: ``t = u + m * t`` in place; returns the update,
    ``u + m * t`` under Nesterov, else ``t``."""
    torch._foreach_mul_(trace, momentum)
    torch._foreach_add_(trace, updates)
    if not nesterov:
        return trace
    return torch._foreach_add(updates, torch._foreach_mul(trace, momentum))


def _scale_by_rms(updates, nu, decay: float, eps: float):
    """``scale_by_rms(eps_in_sqrt=True)``: ``nu = (1 - d) * u**2 + d * nu``
    in place, then ``rsqrt(nu + eps) * u``."""
    sq = torch._foreach_mul(updates, updates)
    torch._foreach_mul_(sq, 1 - decay)
    torch._foreach_mul_(nu, decay)
    torch._foreach_add_(nu, sq)
    scaling = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
    return torch._foreach_mul(scaling, updates)


def _scale_by_adam(grads, mu, nu, count: torch.Tensor, b1: float, b2: float,
                   eps: float):
    """``scale_by_adam(eps_root=0)``: moments in place, then
    ``(mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)`` at the
    incremented count ``t``."""
    m1 = torch._foreach_mul(grads, 1 - b1)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, m1)
    m2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(m2, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, m2)
    t = (count + 1).float()
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, t))
    nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, t))
    den = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    return torch._foreach_div(mu_hat, den)


def _scale_by_trust_ratio(updates, params, lead: int):
    """``scale_by_trust_ratio()``: each leaf times ``|p| / |u|`` (per
    member on a stacked state), or 1 where either norm is 0."""
    p_norm = _sum_squares(params, lead).sqrt()
    u_norm = _sum_squares(updates, lead).sqrt()
    ratio = torch.where((p_norm == 0) | (u_norm == 0),
                        torch.ones_like(p_norm), p_norm / u_norm)
    return [u * _per_member(r, u) for u, r in zip(updates, ratio.unbind())]


def apply_update(family: str, tc, params, grads, moments: dict,
                 count: "torch.Tensor | None", sched_count: torch.Tensor,
                 schedule, lead: int = 0, fused: bool = False) -> None:
    """One update of ``family`` in place on ``params`` (lists of float32
    leaves) and ``moments`` (name -> list of leaves, ``MOMENTS``), from
    ``grads`` (read only). ``count`` is the Adam count before this step
    (adamw, lamb; None otherwise), ``schedule`` maps ``sched_count`` to
    the float32 learning rate. The caller advances the counts. ``fused``
    takes kernel B3 (adamw only; ``configs.validate_train_knobs`` refuses
    the rest)."""
    check_family(family)
    with torch.no_grad():
        if tc.gradient_clip_norm > 0:
            grads = clip_by_global_norm(grads, tc.gradient_clip_norm, lead)
        decay = decay_flags(params, lead)
        lr = None if family == "adamw" else schedule(sched_count).float()
        if family == "adamw":
            scalars = adamw.adamw_scalars(count, sched_count, schedule)
            update = (adamw.fused_adamw_update if fused
                      else adamw.adamw_reference)
            update(params, list(grads), moments["mu"], moments["nu"], decay,
                   scalars, tc.weight_decay)
            return
        if family == "sgdm":
            u = _add_decayed_weights(grads, params, decay, tc.weight_decay)
            u = _trace(u, moments["trace"], tc.momentum, nesterov=True)
            u = torch._foreach_mul(u, -lr)
        elif family == "rmsprop":
            u = _add_decayed_weights(grads, params, decay, tc.weight_decay)
            u = _scale_by_rms(u, moments["nu"], RMS_DECAY, RMS_EPS)
            u = torch._foreach_mul(u, -lr)
            u = _trace(u, moments["trace"], tc.momentum, nesterov=False)
        else:
            u = _scale_by_adam(grads, moments["mu"], moments["nu"], count,
                               LAMB_B1, LAMB_B2, LAMB_EPS)
            u = _add_decayed_weights(u, params, decay, tc.weight_decay)
            u = _scale_by_trust_ratio(u, params, lead)
            u = torch._foreach_mul(u, -lr)
        torch._foreach_add_(params, u)
