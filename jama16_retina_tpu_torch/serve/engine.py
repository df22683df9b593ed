"""Serving engine (counterpart of ``jama16_retina_tpu/serve/engine.py``).

All k members are loaded once and kept on the device, at the serving
dtype (``serve.dtype``, ``serve/quantize.py``). A request of uint8
images is cut into chunks of at most ``serve.max_batch`` rows; each
chunk is padded with zero rows to its bucket shape
(``resolve_buckets``), normalized once and forwarded through the
members: one after another by default (the JAX engine's ``lax.map``
form), or with ``serve.member_parallel`` in one ``torch.func.vmap`` over
the stacked members (its ``vmap`` form, float-equivalent to the first,
not bitwise). In turn, an fp32 or bf16 member is one ``nn.Module`` that
holds its own weights; an int8 member, and the stacked members, are
forwarded by ``torch.func.functional_call`` of one weightless model
skeleton, int8 weights dequantized for that forward only. Padding rows
are trimmed before the results leave the engine; eval-mode forwards are
row-independent (BatchNorm uses stored statistics), so they never change
a real row.

With ``serve.fused_preprocess`` each padded chunk is normalized by the
fused CUDA kernel (``ops/serve_preprocess.py``), whose per-image input
statistics of the real rows are kept on ``last_input_stats`` and handed
to the quality monitor. Otherwise ``data.augment.normalize`` is used.
The two agree to one float32 ulp: the kernel computes ``x *
float32(1/127.5) - 1`` (as ``pallas_serve.py:67`` does) and
``normalize`` computes ``x / 127.5 - 1``.

With ``obs.quality.enabled`` (and ``obs.enabled``) ``probs`` feeds the
quality monitor (``obs/quality.py``) and runs its golden canary when
due. The canary and the construction gate score through the same path
as ``member_probs`` but leave ``last_input_stats`` to the last live
request. A bf16 or int8 engine with a pinned canary is refused at
construction (``quantize.DtypeRejected``) when its canary scores move
more than ``serve.dtype_canary_max_dev``.

The members live in a ``_Generation`` (the JAX engine's hot-swap
handle). ``reload`` builds generation N+1 off the request path (load,
dtype transform, placement, one warm forward per bucket), holds it to
the pinned golden canary, and puts it live by one reference assignment;
a request reads the handle once and scores every chunk (and its canary
ride-along) on that generation. The outgoing generation stays on the
device for ``serve.rollback_keep_s`` so that ``rollback`` is one more
assignment. ``begin_shadow`` scores every Nth live request through a
candidate too, for comparison only.

Construction arms the fault plan (``obs/faultinject.py``; the
``JAMA16_FAULTS`` variable, else ``obs.fault_plan``), and each chunk
passes the ``engine.dispatch`` seam before its forward. An engine the
port uses inside another path (a fit's eval step, the distillation
teacher, ``evaluate_checkpoints``; the reference runs no engine there)
is built with ``faults=False``: it arms nothing, so a fit's plan keeps
its counts and stays the one its reader processes hold, and fires no
seam.
"""

from __future__ import annotations

import copy
import logging
import threading
import time

import numpy as np
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import quality as quality_lib
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace
from jama16_retina_tpu_torch.obs.spans import span
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import host, quantize
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

_log = logging.getLogger(__name__)


def resolve_buckets(sc: configs.ServeConfig) -> "tuple[int, ...]":
    """The padded batch shapes: explicit ``serve.bucket_sizes`` (sorted,
    deduplicated, the largest covering ``max_batch``), else powers of
    two from 8 up to ``max_batch``."""
    if sc.max_batch < 1:
        raise ValueError(f"serve.max_batch must be >= 1, got {sc.max_batch}")
    if sc.bucket_sizes:
        buckets = tuple(sorted({int(b) for b in sc.bucket_sizes}))
        if buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {sc.bucket_sizes}")
        if buckets[-1] < sc.max_batch:
            raise ValueError(
                f"largest bucket {buckets[-1]} < serve.max_batch "
                f"{sc.max_batch}: chunks at the cap would have no bucket")
        return buckets
    out, b = [], 8
    while b < sc.max_batch:
        out.append(b)
        b *= 2
    out.append(sc.max_batch)
    return tuple(sorted(set(out)))


def _on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, memory_format=(torch.channels_last if t.ndim == 4
                                    else torch.preserve_format))


class ReloadRejected(RuntimeError):
    """A candidate generation failed its pre-swap gate (golden-canary
    deviation): the live generation keeps serving and the candidate never
    took a request. Counted under ``serve.reload_rejected``."""


class RollbackUnavailable(RuntimeError):
    """``rollback()`` found no previous generation retained (never
    swapped, already rolled back, or ``serve.rollback_keep_s`` expired):
    ``reload()`` the previous member dirs instead."""


class _ShadowSession:
    """One candidate generation shadow-scoring every Nth live request
    (N = round(1 / fraction)), counted under a lock: deterministic for a
    fixed request sequence. A shadow failure is counted
    (``serve.shadow.errors``), never raised into the live request."""

    __slots__ = ("gen", "member_dirs", "every", "count", "requests",
                 "rows", "max_abs_dev", "sum_abs_dev", "errors", "lock")

    def __init__(self, gen: "_Generation", member_dirs, fraction: float):
        if not (0.0 < fraction <= 1.0):
            raise ValueError(
                f"shadow fraction must be in (0, 1], got {fraction}")
        self.gen = gen
        self.member_dirs = list(member_dirs) if member_dirs else None
        self.every = max(1, int(round(1.0 / fraction)))
        self.count = 0
        self.requests = 0
        self.rows = 0
        self.max_abs_dev = 0.0
        self.sum_abs_dev = 0.0
        self.errors = 0
        self.lock = threading.Lock()

    def claim(self) -> bool:
        """The sampling decision for one live request."""
        with self.lock:
            self.count += 1
            return self.count % self.every == 0

    def record(self, live: np.ndarray, shadow: np.ndarray) -> None:
        dev = np.abs(np.asarray(shadow, np.float64)
                     - np.asarray(live, np.float64))
        with self.lock:
            self.requests += 1
            self.rows += int(dev.shape[0]) if dev.ndim else 1
            self.max_abs_dev = max(self.max_abs_dev, float(dev.max()))
            self.sum_abs_dev += float(dev.sum())

    def report(self) -> dict:
        with self.lock:
            return {
                "requests": self.requests,
                "rows": self.rows,
                "errors": self.errors,
                "max_abs_dev": round(self.max_abs_dev, 9),
                "mean_abs_dev": (round(self.sum_abs_dev / self.rows, 9)
                                 if self.rows else None),
            }


class _Generation:
    """One immutable serving generation: the members' tensors at the
    serving dtype in the form the engine forwards them (``members``:
    (params, buffers) per member, for int8 in turn; ``modules``: one
    module per fp32 or bf16 member in turn; ``stacked``: the stacked
    (params, buffers) of ``serve.member_parallel``), their count and
    their dirs."""

    __slots__ = ("gen_id", "members", "modules", "stacked", "n_members",
                 "member_dirs", "c_rows")

    def __init__(self, gen_id: int, members, modules, stacked,
                 n_members: int, member_dirs, c_rows=None):
        self.gen_id = gen_id
        self.members = members
        self.modules = modules
        self.stacked = stacked
        self.n_members = n_members
        self.member_dirs = list(member_dirs) if member_dirs else None
        # Rows this generation scored: a detached counter until it goes
        # live (``ServingEngine._register_gen_rows``), so a candidate's
        # gate scoring stays out of the exported ledger. None: a fused
        # generation of several tenants, which counts no rows of its own.
        self.c_rows = c_rows

    def renamed(self, gen_id: int, c_rows) -> "_Generation":
        return _Generation(gen_id, self.members, self.modules, self.stacked,
                           self.n_members, self.member_dirs, c_rows)


class ServingEngine:
    """Load-once, bucket-batched ensemble inference.

    Members come from port member dirs (``params.npz``, see
    ``utils/checkpoint.py``) or, for tests and tools, as ready
    ``state_dicts``. ``device=None`` means the card; with no card this
    raises unless ``device="cpu"`` is passed. ``registry`` receives the
    quality monitor's and the generations' metrics (default: the process
    registry, recording as ``obs.enabled`` says).
    """

    def __init__(self, cfg: configs.ExperimentConfig,
                 member_dirs: "list[str] | None" = None, *,
                 state_dicts: "list[dict] | None" = None,
                 device: "str | torch.device | None" = None,
                 registry: "obs_registry.Registry | None" = None,
                 faults: bool = True):
        self.device = device_lib.resolve(device)
        configs.check_supported(cfg)
        self.cfg = cfg
        self.dtype = quantize.check_dtype(cfg.serve.dtype)
        # The monitor's artifacts load first: a wrong path or canary size
        # fails before the members load.
        if registry is None:
            # The engine's own config decides whether the process registry
            # records, and applies the trace knobs to the process tracer
            # (a serving session runs no trainer to do it).
            registry = obs_registry.default_registry()
            registry.enabled = cfg.obs.enabled
            obs_trace.default_tracer().configure(
                enabled=cfg.obs.enabled and cfg.obs.trace_enabled,
                buffer_events=cfg.obs.trace_buffer_events)
        self.registry = registry
        self.quality = (quality_lib.monitor_from_config(
            cfg.obs.quality, registry=registry) if cfg.obs.enabled else None)
        canary = self.quality.canary if self.quality is not None else None
        if canary is not None:
            size = cfg.model.image_size
            got = tuple(canary.images.shape[1:])
            if got != (size, size, 3):
                raise ValueError(
                    f"canary images are {got} but this engine serves "
                    f"{(size, size, 3)} (model.image_size={size}) — re-pin "
                    "obs.quality.canary_path for this checkpoint")
        c, g = registry.counter, registry.gauge
        self._c_reloads = c("serve.reloads",
                            help="hot-swap generation reloads that went live")
        self._c_reload_rejected = c(
            "serve.reload_rejected",
            help="candidate generations rejected before the swap (canary "
                 "deviation / restore or warm-up failure); the old "
                 "generation kept serving")
        self._g_generation = g(
            "serve.generation",
            help="currently-serving model generation (0 = the "
                 "construction-time checkpoint set) [fleet:max]")
        self._c_rollbacks = c(
            "serve.rollbacks",
            help="instant re-swaps to the retained previous generation "
                 "(lifecycle ROLLBACK; no restore from disk)")
        self._c_shadow_requests = c(
            "serve.shadow.requests",
            help="live requests shadow-scored through a staged-rollout "
                 "candidate generation")
        self._c_shadow_rows = c(
            "serve.shadow.rows",
            help="rows shadow-scored through a staged-rollout candidate")
        self._c_shadow_errors = c(
            "serve.shadow.errors",
            help="shadow-scoring failures (counted, never raised into the "
                 "live request they rode)")
        self._g_shadow_dev = g(
            "serve.shadow.max_abs_dev",
            help="running max |candidate - live| score deviation over the "
                 "current shadow session [fleet:max]")
        self._c_rows = c("serve.engine.rows",
                         help="real (pre-padding) rows the engine forwarded")
        self._c_batches = c(
            "serve.engine.batches",
            help="bucketed chunks dispatched through the stacked forward")
        self._g_in_flight = g(
            "serve.engine.in_flight",
            help="engine chunks dispatched but not yet fetched (the "
                 "bounded dispatch window)")
        self._c_dtype_rows = c(
            f"serve.dtype_rows.{self.dtype}",
            help="real rows forwarded by an engine of this serving dtype "
                 "(per-dtype traffic share; fp32/bf16/int8)")
        # The port has no compile cache (ROADMAP item 9): the first
        # request pays its warm-up, and the gauge reads 0, as the
        # reference's does without one.
        self._g_warmup_sec = g(
            "serve.engine.warmup_sec",
            help="seconds from engine construction to every bucket "
                 "executable ready (cache-warmed restarts are the "
                 "serve_warm_start_sec story; 0 = no compile cache "
                 "configured, first request pays the compile) "
                 "[fleet:max]")
        # Pad-waste counters by bucket, made at a bucket's first use.
        self._bucket_counters: dict = {}
        # The fault plan arms at session start: JAMA16_FAULTS wins, then
        # obs.fault_plan; with neither, what a caller armed stays armed.
        # An internal engine (faults=False) neither arms nor fires.
        self._faults = faults
        if faults:
            faultinject.arm_from_env_or_config(cfg.obs.fault_plan)
        # The skeleton keeps no weights: the int8 and the stacked forms
        # swap a member's into it for one forward (functional_call), so
        # those forwards take turns, in every generation. An fp32 or bf16
        # member in turn is a module of its own on the same tensors; its
        # eval-mode forward writes no state, so threads that share the
        # engine (the router's workers) forward it at once, unlocked.
        self._model = models.build(cfg.model)
        self._shapes = {k: tuple(v.shape)
                        for k, v in self._model.state_dict().items()}
        self._names = {n for n, _ in self._model.named_parameters()}
        self._model.to("meta")
        self._forward_lock = threading.Lock()
        self.member_parallel = bool(cfg.serve.member_parallel)
        self.max_batch = int(cfg.serve.max_batch)
        self.buckets = resolve_buckets(cfg.serve)
        self.fused = bool(cfg.serve.fused_preprocess)
        # INPUT_STATS dict of the last live request's rows (fused path
        # only); the canary, the gates and the shadow leave it alone.
        self.last_input_stats: "dict | None" = None
        # Padded chunks forwarded since construction. The router's worker
        # threads may score through one engine at once, so the count is
        # taken under a lock of its own (the forwards are not).
        self.chunks_dispatched = 0
        self._count_lock = threading.Lock()
        # One rollout at a time; requests read the handle, not the lock.
        self._reload_lock = threading.Lock()
        self._prev_gen: "_Generation | None" = None
        self._prev_gen_t = 0.0
        self._shadow: "_ShadowSession | None" = None
        if (member_dirs is None) == (state_dicts is None):
            raise ValueError(
                "ServingEngine needs member dirs or state_dicts (one of)")
        self._gen = self._build_generation(0, member_dirs, state_dicts)
        self._gen.c_rows = self._register_gen_rows(0)
        self._g_generation.set(0)
        self._dtype_construction_gate()

    # How many generations' row counters stay exported after a swap: the
    # live one, the one draining its last requests, and a little history.
    GEN_ROWS_KEEP = 4

    def _register_gen_rows(self, gen_id: int) -> obs_registry.Counter:
        """The exported row counter of a generation going live; the one
        ``GEN_ROWS_KEEP`` generations older is retired from snapshots."""
        retire = gen_id - self.GEN_ROWS_KEEP
        if retire >= 0:
            self.registry.remove(f"serve.gen{retire}.rows")
        return self.registry.counter(
            f"serve.gen{gen_id}.rows",
            help="rows served by this model generation (response "
                 "attribution: the per-generation ledger)")

    # -- generations -------------------------------------------------------

    @property
    def generation(self) -> int:
        """Id of the generation new requests score on."""
        return self._gen.gen_id

    @property
    def n_members(self) -> int:
        return self._gen.n_members

    @property
    def _members(self):
        return self._gen.members

    def _check(self, sd: dict) -> None:
        """A member's names and shapes against the model's."""
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if got != self._shapes:
            missing = sorted(set(self._shapes) - set(got))
            extra = sorted(set(got) - set(self._shapes))
            wrong = sorted(k for k in set(got) & set(self._shapes)
                           if got[k] != self._shapes[k])
            raise ValueError(
                f"member state_dict does not fit {type(self._model).__name__}"
                f": missing {missing[:3]}, unexpected {extra[:3]}, wrong "
                f"shape {wrong[:3]}")

    def _build_generation(self, gen_id: int, member_dirs=None,
                          state_dicts=None, warm: bool = False
                          ) -> _Generation:
        """Load -> dtype transform -> place -> (optionally) one warm
        forward per bucket, off the request path: nothing here touches
        the live generation."""
        if state_dicts is None:
            state_dicts = [
                convert.flax_to_torch(ckpt_lib.load_member(d), self._model)
                for d in member_dirs or ()]
        if not state_dicts:
            raise ValueError("ServingEngine needs at least one member")
        members = []
        for sd in state_dicts:
            self._check(sd)
            params = {k: _on_device(v, self.device) for k, v in sd.items()
                      if k in self._names}
            buffers = {k: _on_device(v, self.device) for k, v in sd.items()
                       if k not in self._names}
            members.append((quantize.params_for_dtype(params, self.dtype),
                            buffers))
        modules = stacked = None
        if self.member_parallel:
            stacked = (quantize.stack([p for p, _ in members]),
                       quantize.stack([b for _, b in members]))
            kept = None
        else:
            kept = members
            if self.dtype != "int8":
                modules = []
                for p, b in members:
                    module = copy.deepcopy(self._model)
                    module.load_state_dict({**p, **b}, assign=True)
                    modules.append(module)
        gen = _Generation(gen_id, kept, modules, stacked, len(members),
                          member_dirs, obs_registry.Counter(
                              f"serve.gen{gen_id}.rows", self.registry))
        if warm:
            self._warm(gen)
        return gen

    def _warm(self, gen: _Generation) -> None:
        """One forward per bucket on ``gen``, finished on the device (the
        probabilities come back to the host) before this returns."""
        size = self.cfg.model.image_size
        for b in self.buckets:
            self._member_probs(np.zeros((b, size, size, 3), np.uint8), gen)

    def _canary_gate(self, gen: _Generation) -> dict:
        """The reload's canary check of a candidate: ``canary_checked``
        and ``canary_max_dev`` for the info dict; raises
        ``ReloadRejected`` on a deviation beyond ``canary_atol`` (exact
        at 0)."""
        q = self.quality
        canary = q.canary if q is not None else None
        if canary is None or canary.reference is None:
            return {"canary_checked": False}
        scores = np.asarray(metrics.ensemble_average(list(
            self._member_probs(canary.images, gen)[0])), np.float64).ravel()
        ref = canary.reference
        same = scores.shape == ref.shape
        dev = float(np.max(np.abs(scores - ref))) if same else float("inf")
        ok = same and (np.array_equal(scores, ref) if canary.atol == 0.0
                       else bool(dev <= canary.atol))
        if not ok:
            self._c_reload_rejected.inc()
            cur = self._gen.gen_id
            _log.error("reload rejected: candidate generation %d deviates "
                       "from the golden canary (max dev %s, atol %g); "
                       "generation %d keeps serving", gen.gen_id, dev,
                       canary.atol, cur)
            raise ReloadRejected(
                f"candidate generation {gen.gen_id} failed the golden canary "
                f"(max deviation {dev} vs atol {canary.atol}); generation "
                f"{cur} keeps serving")
        return {"canary_checked": True,
                "canary_max_dev": None if dev == float("inf") else dev}

    def reload(self, member_dirs=None, *,
               state_dicts: "list[dict] | None" = None) -> dict:
        """Hot-swap to a new member set with no dropped request.

        Generation N+1 is built off the request path (load, dtype
        transform, placement, one warm forward per bucket), held to the
        pinned golden canary, then put live by one reference assignment:
        requests that already read generation N finish on it. A candidate
        that fails never takes a request: ``serve.reload_rejected``
        counts it and ``ReloadRejected`` (canary) or the load's own error
        propagates. Returns {'generation', 'n_members',
        'canary_checked'[, 'canary_max_dev']}."""
        with self._reload_lock:
            return self._reload_locked(member_dirs, state_dicts)

    def release_retained(self) -> None:
        """Drop the retained previous generation (frees its device
        memory)."""
        with self._reload_lock:
            self._prev_gen = None

    def _reload_locked(self, member_dirs, state_dicts,
                       candidate: "_Generation | None" = None) -> dict:
        cur = self._gen
        new_id = cur.gen_id + 1
        # A new rollout drops the retained generation before its candidate
        # builds, so the device holds at most two generations.
        self._prev_gen = None
        try:
            if candidate is None:
                gen = self._build_generation(new_id, member_dirs, state_dicts,
                                             warm=True)
            else:
                gen = candidate.renamed(new_id, obs_registry.Counter(
                    f"serve.gen{new_id}.rows", self.registry))
                self._warm(gen)
        except Exception:
            self._c_reload_rejected.inc()
            raise
        info = {"generation": new_id, "n_members": gen.n_members,
                **self._canary_gate(gen)}
        if self.cfg.serve.rollback_keep_s > 0:
            self._prev_gen = cur
            self._prev_gen_t = time.monotonic()
        # A shadow session compared against the outgoing generation.
        self._shadow = None
        gen.c_rows = self._register_gen_rows(new_id)
        self._gen = gen
        self._c_reloads.inc()
        self._g_generation.set(new_id)
        _log.info("serving generation %d live (%d members)", new_id,
                  gen.n_members)
        return info

    def rollback(self) -> dict:
        """Instant re-swap to the retained previous generation, minted as
        a new generation id (ids stay monotonic). Raises
        ``RollbackUnavailable`` when none is retained or the
        ``serve.rollback_keep_s`` window expired. Returns {'generation',
        'restored_from', 'n_members'}."""
        with self._reload_lock:
            prev = self._prev_gen
            keep_s = self.cfg.serve.rollback_keep_s
            if prev is None:
                raise RollbackUnavailable(
                    "no previous generation retained (never swapped, or "
                    "already rolled back); reload() the previous member "
                    "dirs instead")
            age = time.monotonic() - self._prev_gen_t
            if keep_s <= 0 or age > keep_s:
                self._prev_gen = None
                raise RollbackUnavailable(
                    f"retained generation {prev.gen_id} expired ({age:.0f}s "
                    f"old vs serve.rollback_keep_s={keep_s:g}); reload() "
                    "the previous member dirs instead")
            cur = self._gen
            gen = prev.renamed(cur.gen_id + 1, self._register_gen_rows(
                cur.gen_id + 1))
            self._prev_gen = None  # one rollback per swap
            self._shadow = None
            self._gen = gen
            self._c_rollbacks.inc()
            self._g_generation.set(gen.gen_id)
            _log.warning("ROLLBACK: generation %d live again as generation "
                         "%d (was serving %d)", prev.gen_id, gen.gen_id,
                         cur.gen_id)
            return {"generation": gen.gen_id, "restored_from": prev.gen_id,
                    "n_members": gen.n_members}

    # -- the shadow seam ----------------------------------------------------

    def prepare_candidate(self, member_dirs=None, *,
                          state_dicts: "list[dict] | None" = None,
                          warm: bool = False) -> _Generation:
        """A candidate generation built off the request path and put
        nowhere; ``member_probs(images, _gen=candidate)`` scores through
        it."""
        return self._build_generation(self._gen.gen_id + 1, member_dirs,
                                      state_dicts, warm=warm)

    def begin_shadow(self, member_dirs=None, *,
                     state_dicts: "list[dict] | None" = None,
                     candidate: "_Generation | None" = None,
                     fraction: float = 0.25) -> dict:
        """Shadow-score every round(1/fraction)-th live request through a
        candidate (a ``prepare_candidate`` handle, or one built and warmed
        here from ``member_dirs``/``state_dicts``). One session at a
        time; a reload or rollback ends it."""
        with self._reload_lock:
            if self._shadow is not None:
                raise RuntimeError("a shadow session is already active; "
                                   "end_shadow() it first")
            if candidate is None:
                candidate = self._build_generation(
                    self._gen.gen_id + 1, member_dirs, state_dicts,
                    warm=True)
            self._shadow = _ShadowSession(candidate, candidate.member_dirs,
                                          fraction)
            return {"fraction": fraction, "every": self._shadow.every}

    def shadow_report(self) -> "dict | None":
        """The active session's comparison (None: no session)."""
        sh = self._shadow
        return sh.report() if sh is not None else None

    def end_shadow(self, promote: bool = False) -> "dict | None":
        """Stop sampling and return the final report; ``promote=True``
        then puts the candidate live through the reload path (warm,
        canary gate, swap, retention), its info under 'reload'. Of two
        racing enders exactly one gets the report."""
        with self._reload_lock:
            sh, self._shadow = self._shadow, None
        if sh is None:
            return None
        report = sh.report()
        if promote:
            with self._reload_lock:
                report = {**report, "reload": self._reload_locked(
                    None, None, candidate=sh.gen)}
        return report

    def _shadow_sample(self, sh: _ShadowSession, images: np.ndarray,
                       live_out: np.ndarray) -> None:
        try:
            shadow_out = metrics.ensemble_average(
                list(self._member_probs(images, sh.gen)[0]))
            sh.record(live_out, shadow_out)
            self._c_shadow_requests.inc()
            self._c_shadow_rows.inc(images.shape[0])
            self._g_shadow_dev.set(sh.max_abs_dev)
        except Exception as e:  # noqa: BLE001 - advisory path
            with sh.lock:
                sh.errors += 1
            self._c_shadow_errors.inc()
            _log.error("shadow scoring failed (live request unaffected): "
                       "%s: %s", type(e).__name__, e)

    # -- scoring -------------------------------------------------------------

    def _dtype_construction_gate(self) -> None:
        """A bf16 or int8 engine with a pinned canary scores it now and is
        refused when it deviates beyond ``serve.dtype_canary_max_dev``;
        fp32 skips the gate, and an engine with no pinned canary serves
        ungated, with a warning."""
        if self.dtype == "fp32":
            return
        canary = self.quality.canary if self.quality is not None else None
        if canary is None or canary.reference is None:
            _log.warning(
                "serve.dtype=%s engine has no pinned golden canary; the "
                "quantized numerics are UNGATED — pin one via "
                "obs.quality.canary_path for the construction-time parity "
                "check", self.dtype)
            return
        scores = np.asarray(metrics.ensemble_average(
            list(self._member_probs(canary.images, self._gen)[0])),
            np.float64).ravel()
        ref = np.asarray(canary.reference, np.float64).ravel()
        dev = (float(np.max(np.abs(scores - ref)))
               if scores.shape == ref.shape else float("inf"))
        bound = float(self.cfg.serve.dtype_canary_max_dev)
        if dev > bound:
            raise quantize.DtypeRejected(
                f"serve.dtype={self.dtype} deviates from the pinned golden "
                f"canary by {dev:.6g} (> serve.dtype_canary_max_dev="
                f"{bound:g}); the quantized engine never took a request — "
                "serve fp32, or loosen the bound deliberately with this "
                "deviation in hand")
        _log.info("serve.dtype=%s passed the golden-canary gate (max dev "
                  "%.6g <= %g)", self.dtype, dev, bound)

    def resident_bytes(self) -> int:
        """Device bytes of the members' weights and BatchNorm statistics
        at the serving dtype, of the live and the retained generation."""
        def nbytes(gen: _Generation) -> int:
            if gen.stacked is not None:
                return sum(quantize.nbytes(d) for d in gen.stacked)
            # A module holds the same tensors as its member's dicts.
            return sum(quantize.nbytes(p) + quantize.nbytes(b)
                       for p, b in gen.members)

        prev = self._prev_gen
        return nbytes(self._gen) + (nbytes(prev) if prev is not None else 0)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"no bucket covers a chunk of {n} rows")

    def _probs(self, model, x: torch.Tensor) -> torch.Tensor:
        """Normalized NCHW batch -> one member's probabilities ([B], or
        [B, C] for the ``multi`` head), flip-TTA averaged over 4 views
        when ``eval.tta``. ``model`` maps a batch to (logits, aux)."""
        def forward(v):
            logits, _ = model(v)
            return models.head_probs(logits, self.cfg.model.head)

        if not self.cfg.eval.tta:
            return forward(x)
        views = (x, x.flip(3), x.flip(2), x.flip(2, 3))
        return torch.stack([
            forward(v.contiguous(memory_format=torch.channels_last))
            for v in views
        ]).mean(dim=0)

    def _functional(self, tensors: dict):
        return lambda v: torch.func.functional_call(self._model, tensors,
                                                    (v,), strict=True)

    def _forward(self, x: torch.Tensor, gen: _Generation) -> torch.Tensor:
        """[k, B] (or [k, B, C]) probabilities of every member of
        ``gen``."""
        if gen.modules is not None:
            return torch.stack([self._probs(m, x) for m in gen.modules])
        with self._forward_lock:
            if gen.stacked is None:
                return torch.stack([
                    self._probs(self._functional(
                        {**quantize.dequantize(p), **b}), x)
                    for p, b in gen.members])
            params, buffers = gen.stacked
            tensors = {**quantize.dequantize(params), **buffers}
            return torch.func.vmap(
                lambda t, v: self._probs(self._functional(t), v),
                in_dims=(0, None))(tensors, x)

    def forward_normalized(self, x: torch.Tensor) -> torch.Tensor:
        """[k, B] (or [k, B, C]) probabilities of the live generation's
        members for a normalized NCHW batch already on the device: the
        distillation teacher's forward, with no chunking or padding."""
        return self._forward(x, self._gen)

    def score_padded(self, rows: np.ndarray, bucket: int, gen: _Generation
                     ) -> "tuple[torch.Tensor, torch.Tensor | None]":
        """uint8 rows [n, S, S, 3] padded with zero rows to ``bucket``,
        normalized once (kernel B4 on the fused path) and forwarded
        through every member of ``gen``: ([k, n] (or [k, n, C])
        probabilities on the device, the real rows' B4 sums or None). Call
        it under ``torch.inference_mode``."""
        return self._score(self._pad(rows, bucket), rows.shape[0], gen)

    def _pad(self, rows: "np.ndarray | torch.Tensor", bucket: int
             ) -> torch.Tensor:
        """uint8 rows [n, S, S, 3] on the device, padded with zero rows to
        ``bucket``. Rows already on the device are copied there."""
        size = self.cfg.model.image_size
        padded = torch.zeros((bucket, size, size, 3), dtype=torch.uint8,
                             device=self.device)
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        padded[:rows.shape[0]].copy_(rows)
        return padded

    def _score(self, padded: torch.Tensor, n: int, gen: _Generation
               ) -> "tuple[torch.Tensor, torch.Tensor | None]":
        sums = None
        if self.fused:
            norm, sums = serve_preprocess.fused_serve_preprocess(padded)
            sums = sums[:n]
        else:
            norm = augment.normalize(padded)
        # NHWC float32 seen as NCHW: a channels_last view, no copy.
        return self._forward(norm.permute(0, 3, 1, 2), gen)[:, :n], sums

    def _member_probs(self, images: "np.ndarray | torch.Tensor",
                      gen: _Generation) -> "tuple[np.ndarray, dict | None]":
        """Every chunk of the request on ``gen``: (member probabilities,
        the real rows' INPUT_STATS on the fused path, else None). A uint8
        tensor already on the engine's device (an eval cache's batch)
        skips the upload; its producer orders it before this stream."""
        if isinstance(images, torch.Tensor):
            on = images.device
            if images.dtype != torch.uint8 or on.type != self.device.type or (
                    None not in (on.index, self.device.index)
                    and on.index != self.device.index):
                raise TypeError(
                    f"expected a uint8 tensor on {self.device}, got "
                    f"{images.dtype} on {images.device}")
        else:
            images = np.asarray(images)
            if images.dtype != np.uint8:
                raise TypeError(f"expected uint8 images, got {images.dtype}")
        size = self.cfg.model.image_size
        if images.ndim != 4 or tuple(images.shape[1:]) != (size, size, 3):
            raise ValueError(
                f"expected images [n, {size}, {size}, 3], got "
                f"{tuple(images.shape)}")
        if images.shape[0] == 0:
            raise ValueError("empty request: no rows to score")
        outs, sums = [], []
        with torch.inference_mode():
            for lo in range(0, images.shape[0], self.max_batch):
                chunk = images[lo:lo + self.max_batch]
                n = chunk.shape[0]
                bucket = self._bucket_for(n)
                self._c_rows.inc(n)
                self._c_dtype_rows.inc(n)
                if gen.c_rows is not None:
                    gen.c_rows.inc(n)
                self._c_batches.inc()
                c_pad = self._bucket_counters.get(bucket)
                if c_pad is None:
                    c_pad = self._bucket_counters[bucket] = \
                        self.registry.counter(
                            f"serve.pad_rows_b{bucket}",
                            help="pad waste: rows this bucket shape burned "
                                 "beyond real chunk rows")
                c_pad.inc(bucket - n)
                # Spans time the host: on the card the forward is queued,
                # and its device time shows in the device_get drain.
                with span("serve.engine.pad_s", self.registry):
                    padded = self._pad(chunk, bucket)
                # The engine.dispatch fault seam, once a chunk.
                if self._faults:
                    faultinject.check("engine.dispatch")
                with span("serve.engine.dispatch_s", self.registry):
                    probs, chunk_sums = self._score(padded, n, gen)
                outs.append(probs)
                # The chunks' results come back together, below.
                self._g_in_flight.set(len(outs))
                if chunk_sums is not None:
                    sums.append(chunk_sums)
                with self._count_lock:
                    self.chunks_dispatched += 1
            with span("serve.engine.device_get_s", self.registry):
                probs = torch.cat(outs, dim=1).cpu().numpy()
            self._g_in_flight.set(0)
            stats = None
            if self.fused:
                stats = serve_preprocess.input_stats_dict(
                    serve_preprocess.stats_from_sums(torch.cat(sums).cpu(),
                                                     size * size))
        return probs, stats

    def member_probs(self, images: np.ndarray, *,
                     _gen: "_Generation | None" = None) -> np.ndarray:
        """uint8 images [n, S, S, 3] -> per-member probabilities [k, n]
        (binary head) or [k, n, C] (``multi``), on the live generation
        or, internally, on the pinned ``_gen`` (a candidate's scoring
        leaves ``last_input_stats`` alone)."""
        probs, stats = self._member_probs(
            images, _gen if _gen is not None else self._gen)
        if stats is not None and _gen is None:
            self.last_input_stats = stats
        return probs

    def probs(self, images: np.ndarray) -> np.ndarray:
        """Ensemble-averaged probabilities [n] (or [n, C]), float64. The
        quality monitor, when on, observes them with the rows' input
        statistics (from the fused kernel's sums when it ran), and the
        canary, when due, is scored through ``_member_probs``, so it
        enters neither the drift windows nor ``last_input_stats``."""
        return self.probs_with_generation(images)[0]

    def probs_with_generation(self, images: np.ndarray
                              ) -> "tuple[np.ndarray, int]":
        """``probs`` and the id of the generation that scored every row:
        the handle is read once, before the first chunk, and kept for the
        whole request, its shadow sample and its canary ride-along."""
        gen = self._gen
        member, stats = self._member_probs(images, gen)
        if stats is not None:
            self.last_input_stats = stats
        out = metrics.ensemble_average(list(member))
        sh = self._shadow
        if sh is not None and sh.claim():
            self._shadow_sample(sh, images, out)
        q = self.quality
        if q is not None:
            host.observe_with_stats(q, images, out, stats, self.registry)
            if q.canary_claim():
                q.run_canary(lambda imgs: metrics.ensemble_average(
                    list(self._member_probs(imgs, gen)[0])))
        return out, gen.gen_id

    def make_batcher(self):
        """A ``MicroBatcher`` over ``probs`` under the ``serve`` section's
        coalescing, shedding and deadline knobs, pinned to this model's
        uint8 [S, S, 3] rows so a malformed request is refused at submit."""
        from jama16_retina_tpu_torch.serve.batcher import MicroBatcher

        sc, size = self.cfg.serve, self.cfg.model.image_size
        return MicroBatcher(
            self.probs, max_batch=sc.max_batch, max_wait_ms=sc.max_wait_ms,
            row_shape=(size, size, 3),
            row_dtype=np.uint8, registry=self.registry,
            shed_queue_depth=sc.shed_queue_depth,
            shed_in_flight=sc.shed_in_flight,
            default_deadline_ms=sc.default_deadline_ms)
