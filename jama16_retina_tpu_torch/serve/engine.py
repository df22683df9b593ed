"""Serving engine (counterpart of ``jama16_retina_tpu/serve/engine.py``).

All k members are loaded once and kept on the device. A request of
uint8 images is cut into chunks of at most ``serve.max_batch`` rows;
each chunk is padded with zero rows to its bucket shape
(``resolve_buckets``), normalized once, and forwarded through the
members one after another (the JAX engine's ``lax.map`` form). Padding
rows are trimmed before the results leave the engine; eval-mode
forwards are row-independent (BatchNorm uses stored statistics), so
they never change a real row.

With ``serve.fused_preprocess`` each padded chunk is normalized by the
fused CUDA kernel (``ops/serve_preprocess.py``), whose per-image input
statistics of the real rows are kept on ``last_input_stats`` for the
quality monitor. Otherwise ``data.augment.normalize`` is used. The two
agree to one float32 ulp: the kernel computes ``x * float32(1/127.5) -
1`` (as ``pallas_serve.py:67`` does) and ``normalize`` computes
``x / 127.5 - 1``.
"""

from __future__ import annotations

import numpy as np
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib


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


class ServingEngine:
    """Load-once, bucket-batched ensemble inference.

    Members come from port member dirs (``params.npz``, see
    ``utils/checkpoint.py``) or, for tests and tools, as ready
    ``state_dicts``. ``device=None`` means the card; with no card this
    raises unless ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: configs.ExperimentConfig,
                 member_dirs: "list[str] | None" = None, *,
                 state_dicts: "list[dict] | None" = None,
                 device: "str | torch.device | None" = None):
        self.device = device_lib.resolve(device)
        configs.check_supported(cfg)
        self.cfg = cfg
        if (member_dirs is None) == (state_dicts is None):
            raise ValueError(
                "ServingEngine needs member dirs or state_dicts (one of)")
        if member_dirs is not None:
            if not member_dirs:
                raise ValueError("ServingEngine needs at least one member")
            state_dicts = [
                convert.flax_to_torch(ckpt_lib.load_member(d),
                                      models.build(cfg.model))
                for d in member_dirs
            ]
        if not state_dicts:
            raise ValueError("ServingEngine needs at least one member")
        self.members = []
        for sd in state_dicts:
            model = models.build(cfg.model)
            model.load_state_dict(sd)
            self.members.append(model.to(
                self.device, memory_format=torch.channels_last))
        self.max_batch = int(cfg.serve.max_batch)
        self.buckets = resolve_buckets(cfg.serve)
        self.fused = bool(cfg.serve.fused_preprocess)
        # INPUT_STATS dict of the last request's rows (fused path only).
        self.last_input_stats: "dict | None" = None
        # Padded chunks forwarded since construction.
        self.chunks_dispatched = 0

    @property
    def n_members(self) -> int:
        return len(self.members)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"no bucket covers a chunk of {n} rows")

    def _probs(self, model, x: torch.Tensor) -> torch.Tensor:
        """Normalized NCHW batch -> probabilities for one member ([B], or
        [B, C] for the ``multi`` head), flip-TTA averaged over 4 views
        when ``eval.tta``."""
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

    def member_probs(self, images: np.ndarray) -> np.ndarray:
        """uint8 images [n, S, S, 3] -> per-member probabilities [k, n]
        (binary head) or [k, n, C] (``multi``)."""
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
                x = norm.permute(0, 3, 1, 2)
                outs.append(torch.stack(
                    [self._probs(m, x)[:n] for m in self.members]))
                self.chunks_dispatched += 1
            probs = torch.cat(outs, dim=1).cpu().numpy()
            if self.fused:
                stats = serve_preprocess.stats_from_sums(
                    torch.cat(sums).cpu(), size * size)
                self.last_input_stats = serve_preprocess.input_stats_dict(
                    stats)
        return probs

    def probs(self, images: np.ndarray) -> np.ndarray:
        """Ensemble-averaged probabilities [n] (or [n, C]), float64."""
        return metrics.ensemble_average(list(self.member_probs(images)))
