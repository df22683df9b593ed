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
"""

from __future__ import annotations

import copy
import logging
import threading

import numpy as np
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import quality as quality_lib
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import quantize
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


class ServingEngine:
    """Load-once, bucket-batched ensemble inference.

    Members come from port member dirs (``params.npz``, see
    ``utils/checkpoint.py``) or, for tests and tools, as ready
    ``state_dicts``. ``device=None`` means the card; with no card this
    raises unless ``device="cpu"`` is passed. ``registry`` receives the
    quality monitor's metrics (default: the process registry, recording
    as ``obs.enabled`` says).
    """

    def __init__(self, cfg: configs.ExperimentConfig,
                 member_dirs: "list[str] | None" = None, *,
                 state_dicts: "list[dict] | None" = None,
                 device: "str | torch.device | None" = None,
                 registry: "obs_registry.Registry | None" = None):
        self.device = device_lib.resolve(device)
        configs.check_supported(cfg)
        self.cfg = cfg
        self.dtype = quantize.check_dtype(cfg.serve.dtype)
        if (member_dirs is None) == (state_dicts is None):
            raise ValueError(
                "ServingEngine needs member dirs or state_dicts (one of)")
        # The monitor's artifacts load first: a wrong path or canary size
        # fails before the members load.
        if registry is None:
            registry = obs_registry.default_registry()
            registry.enabled = cfg.obs.enabled
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
        self._model = models.build(cfg.model)
        if member_dirs is not None:
            state_dicts = [
                convert.flax_to_torch(ckpt_lib.load_member(d), self._model)
                for d in member_dirs]
        if not state_dicts:
            raise ValueError("ServingEngine needs at least one member")
        names = {n for n, _ in self._model.named_parameters()}
        members = []
        for sd in state_dicts:
            # Checks the member's names and shapes against the model.
            self._model.load_state_dict(sd)
            params = {k: _on_device(v, self.device) for k, v in sd.items()
                      if k in names}
            buffers = {k: _on_device(v, self.device) for k, v in sd.items()
                       if k not in names}
            members.append((quantize.params_for_dtype(params, self.dtype),
                            buffers))
        # The skeleton keeps no weights: the int8 and the stacked forms
        # swap a member's into it for one forward (functional_call), so
        # those forwards take turns. An fp32 or bf16 member in turn is a
        # module of its own on the same tensors.
        self._model.to("meta")
        self._forward_lock = threading.Lock()
        self.n_members = len(members)
        self.member_parallel = bool(cfg.serve.member_parallel)
        self._members, self._modules, self._stacked = members, None, None
        if self.member_parallel:
            self._members = None
            self._stacked = (quantize.stack([p for p, _ in members]),
                             quantize.stack([b for _, b in members]))
        elif self.dtype != "int8":
            self._modules = []
            for p, b in members:
                module = copy.deepcopy(self._model)
                module.load_state_dict({**p, **b}, assign=True)
                self._modules.append(module)
        self.max_batch = int(cfg.serve.max_batch)
        self.buckets = resolve_buckets(cfg.serve)
        self.fused = bool(cfg.serve.fused_preprocess)
        # INPUT_STATS dict of the last live request's rows (fused path
        # only); the canary and the gate leave it alone.
        self.last_input_stats: "dict | None" = None
        # Padded chunks forwarded since construction.
        self.chunks_dispatched = 0
        self._dtype_construction_gate()

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
            list(self._member_probs(canary.images)[0])), np.float64).ravel()
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
        at the serving dtype."""
        if self._stacked is not None:
            return sum(quantize.nbytes(d) for d in self._stacked)
        # A module holds the same tensors as its member's dicts.
        return sum(quantize.nbytes(p) + quantize.nbytes(b)
                   for p, b in self._members)

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

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """[k, B] (or [k, B, C]) probabilities of every member."""
        if self._modules is not None:
            return torch.stack([self._probs(m, x) for m in self._modules])
        with self._forward_lock:
            if self._stacked is None:
                return torch.stack([
                    self._probs(self._functional(
                        {**quantize.dequantize(p), **b}), x)
                    for p, b in self._members])
            params, buffers = self._stacked
            tensors = {**quantize.dequantize(params), **buffers}
            return torch.func.vmap(
                lambda t, v: self._probs(self._functional(t), v),
                in_dims=(0, None))(tensors, x)

    def _member_probs(self, images: np.ndarray
                      ) -> "tuple[np.ndarray, dict | None]":
        images = np.asarray(images)
        size = self.cfg.model.image_size
        if images.ndim != 4 or images.shape[1:] != (size, size, 3):
            raise ValueError(
                f"expected images [n, {size}, {size}, 3], got {images.shape}")
        if images.dtype != np.uint8:
            raise TypeError(f"expected uint8 images, got {images.dtype}")
        if images.shape[0] == 0:
            raise ValueError("empty request: no rows to score")
        outs, sums = [], []
        with torch.inference_mode():
            for lo in range(0, images.shape[0], self.max_batch):
                chunk = images[lo:lo + self.max_batch]
                n = chunk.shape[0]
                padded = torch.zeros((self._bucket_for(n), size, size, 3),
                                     dtype=torch.uint8, device=self.device)
                padded[:n].copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
                if self.fused:
                    norm, chunk_sums = serve_preprocess.fused_serve_preprocess(
                        padded)
                    sums.append(chunk_sums[:n])
                else:
                    norm = augment.normalize(padded)
                # NHWC float32 seen as NCHW: a channels_last view, no copy.
                outs.append(self._forward(norm.permute(0, 3, 1, 2))[:, :n])
                self.chunks_dispatched += 1
            probs = torch.cat(outs, dim=1).cpu().numpy()
            stats = None
            if self.fused:
                stats = serve_preprocess.input_stats_dict(
                    serve_preprocess.stats_from_sums(torch.cat(sums).cpu(),
                                                     size * size))
        return probs, stats

    def member_probs(self, images: np.ndarray) -> np.ndarray:
        """uint8 images [n, S, S, 3] -> per-member probabilities [k, n]
        (binary head) or [k, n, C] (``multi``)."""
        probs, stats = self._member_probs(images)
        if stats is not None:
            self.last_input_stats = stats
        return probs

    def probs(self, images: np.ndarray) -> np.ndarray:
        """Ensemble-averaged probabilities [n] (or [n, C]), float64. The
        quality monitor, when on, observes them with the rows' input
        statistics (from the fused kernel's sums when it ran), and the
        canary, when due, is scored through ``_member_probs``, so it
        enters neither the drift windows nor ``last_input_stats``."""
        member, stats = self._member_probs(images)
        if stats is not None:
            self.last_input_stats = stats
        out = metrics.ensemble_average(list(member))
        q = self.quality
        if q is not None:
            q.observe(images, out, stats=stats)
            if q.canary_claim():
                q.run_canary(lambda imgs: metrics.ensemble_average(
                    list(self._member_probs(imgs)[0])))
        return out

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
