"""Tiered streaming ingest: the ``data.loader="tiered"`` option
(counterpart of ``jama16_retina_tpu/data/tiered_pipeline.py``).

The ``hbm`` loader is all or nothing: a split over the budget is
refused. This loader makes the degradation a ramp, in three layers:

  1. PARALLEL HOST DECODE — the streamed tier's records are decoded by
     ``grain_pipeline.ParallelDecoder`` (``data.decode_workers`` threads;
     its output does not depend on the count).
  2. RESIDENT TIER — as many rows as the budget admits
     (``hbm_pipeline.resident_row_capacity``; ``data.tiered_resident_bytes``)
     are decoded once and kept on the card. Every batch mixes a fixed
     quota of resident rows (a gather on the card) with streamed rows.
  3. OVERLAPPED UPLOAD — each streamed batch is decoded into a pinned
     host buffer and copied to the card ``non_blocking`` on a side
     stream; the loader keeps ``data.stage_depth`` batches decoded and
     their copies issued ahead of the one yielded. A batch's combine
     (the resident gather, concatenated with its streamed rows, resident
     rows first) runs on the consumer's current stream when it is
     yielded, after that stream waits on its copy's event; a pinned
     buffer is refilled only after the copy that read it has finished
     (``pipeline.PinnedRing``, the ring ``DevicePrefetch`` stages
     through).

Batch composition is STATIC per run: with s = n // batch_size steps per
epoch and R pinnable rows, every batch holds ``res_pb = min(B, R // s)``
resident rows and ``B - res_pb`` streamed rows. The resident tier is
records [0, res_pb*s) in index order; each epoch permutes each tier
with a (seed, tier, epoch)-seeded numpy stream, so the batch sequence
is a pure function of (seed, step) at a fixed residency and a resume is
an O(1) offset (``skip_batches``). Residency 100 % is the ``hbm``
loader's steady state (a gather a step, under this loader's own
permutation); 0 % is the pure streamed path (``streamed_batches``).
``host_reference_batches`` recomputes the planned sequence from first
principles (plan -> record ids -> direct decode), the oracle the tests
and ``chip_smoke.py`` hold the card path to bit for bit.

The decode of streamed rows runs on the consumer's thread, as the
reference's does: timing never changes contents. The batches are the
trainer's as yielded: the reference also queues ``data.prefetch_batches``
of them in ``device_prefetch``, the port does not (ROADMAP.md Queue C).
A mesh and more than one process are not ported (ROADMAP.md Queue A
item 8, part 2), nor is the reference's card-memory owner ledger (item
11, part 4).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Iterator

import numpy as np
import torch

from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import grain_pipeline, pipeline, tfrecord
from jama16_retina_tpu_torch.data.hbm_pipeline import (
    resident_row_capacity,
    row_bytes,
)
from jama16_retina_tpu_torch.obs import registry as obs_registry

_log = logging.getLogger(__name__)

_MULTI_DEVICE = ("a mesh, or more than one process (the cross-host "
                 "sharded spill plan), is not ported yet; see ROADMAP.md "
                 "Queue A item 8, part 2")


def plan_residency(
    n: int, batch_size: int, capacity_rows: int
) -> tuple[int, int, int]:
    """-> (steps_per_epoch, resident_rows_per_batch, n_resident_pinned).

    Full residency (capacity >= n): pin ALL n rows and take res_pb = B,
    so the n % B epoch drop rotates as the hbm loader's does.

    Partial residency: ``res_pb = min(B, capacity // steps)``, capped at
    B-1 whenever any row stays unpinned (the streamed slot is what
    rotates the unpinnable remainder through training). Only
    ``res_pb * steps`` rows are pinned.
    """
    if batch_size > n:
        raise ValueError(f"batch_size={batch_size} exceeds dataset n={n}")
    steps = n // batch_size
    capacity_rows = max(0, capacity_rows)
    if capacity_rows >= n:
        return steps, batch_size, n
    res_pb = min(batch_size, capacity_rows // steps)
    if res_pb == batch_size:
        res_pb = batch_size - 1
    return steps, res_pb, res_pb * steps


def host_spill_plan(n_padded: int, process_count: int) -> list:
    """The reference's cross-host sharded spill plan: process-major
    contiguous ``[lo, hi)`` blocks of the padded resident set. Pure: the
    port stages the resident tier from one process (``stage_resident``
    refuses more), so no load path calls it yet."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if n_padded % process_count:
        raise ValueError(
            f"{n_padded} padded resident rows do not split across "
            f"{process_count} process(es); pad to the data-axis size "
            "first (_place_resident's rule — every host owns an equal "
            "device-aligned block)"
        )
    per = n_padded // process_count
    return [(p * per, (p + 1) * per) for p in range(process_count)]


def host_spill_ids(n_res: int, n_padded: int, process_index: int,
                   process_count: int) -> np.ndarray:
    """Global record ids host ``process_index`` stages: its
    ``host_spill_plan`` block, padding rows (>= n_res) wrapping onto
    leading records."""
    lo, hi = host_spill_plan(n_padded, process_count)[process_index]
    return (np.arange(lo, hi) % max(n_res, 1)).astype(np.int64)


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def stage_resident(decoder, n_res: int, mesh=None, process_count=None,
                   device: "str | torch.device | None" = None
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Decode the resident tier, records [0, n_res), with one
    ``decode_range`` and upload it to the card once: (uint8 [n_res, S,
    S, 3], int32 [n_res]). ``process_count`` defaults to the
    ``torch.distributed`` world's size."""
    count = _process_count() if process_count is None else process_count
    if mesh is not None or count > 1:
        raise NotImplementedError(
            f"tiered_pipeline.stage_resident: {_MULTI_DEVICE}")
    images, grades = decoder.decode_range(0, n_res)
    return _place_resident(images, grades, device)


def _place_resident(images: np.ndarray, grades: np.ndarray,
                    device: "str | torch.device | None" = None
                    ) -> "tuple[torch.Tensor, torch.Tensor]":
    dev = device_lib.resolve(device)
    return (torch.from_numpy(np.ascontiguousarray(images)).to(dev),
            torch.from_numpy(np.ascontiguousarray(grades, np.int32)).to(dev))


def _epoch_perm(seed: int, epoch: int, tier: int, n: int) -> np.ndarray:
    """Deterministic per-(tier, epoch) permutation of [0, n): a numpy
    stream seeded on (seed, tier, epoch), host-computable and
    independent of the worker count."""
    return np.random.default_rng([seed, tier, epoch]).permutation(n)


class _TierPlan:
    """Index bookkeeping for one (n, batch_size, residency) layout."""

    def __init__(self, n: int, batch_size: int, capacity_rows: int,
                 seed: int):
        self.n = n
        self.batch = batch_size
        self.steps, self.res_pb, self.n_res = plan_residency(
            n, batch_size, capacity_rows
        )
        self.str_pb = batch_size - self.res_pb
        self.n_str = n - self.n_res
        self.seed = seed
        self._perms: dict[tuple[int, int], np.ndarray] = {}

    def _perm(self, tier: int, epoch: int, n: int) -> np.ndarray:
        key = (tier, epoch)
        if key not in self._perms:
            # Keep only the current epoch's pair of perms (+ the next
            # epoch's while the staging queue straddles the boundary).
            for k in [k for k in self._perms if k[1] < epoch - 1]:
                del self._perms[k]
            self._perms[key] = _epoch_perm(self.seed, epoch, tier, n)
        return self._perms[key]

    def batch_indices(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Global record ids for batch ``step``:
        (resident_ids [res_pb], streamed_ids [str_pb])."""
        epoch, b = divmod(step, self.steps)
        res = np.zeros((0,), np.int64)
        if self.res_pb:
            perm = self._perm(0, epoch, self.n_res)
            res = perm[b * self.res_pb:(b + 1) * self.res_pb]
        streamed = np.zeros((0,), np.int64)
        if self.str_pb:
            perm = self._perm(1, epoch, self.n_str)
            streamed = self.n_res + perm[b * self.str_pb:(b + 1) * self.str_pb]
        return res, streamed


class _ResidentOrder:
    """The resident tier's epoch permutation on the card, uploaded once an
    epoch; a batch's resident ids are a slice of it."""

    def __init__(self, plan: _TierPlan, dev: torch.device):
        self.plan, self.dev = plan, dev
        self._epoch = -1
        self._perm: "torch.Tensor | None" = None

    def __call__(self, step: int) -> torch.Tensor:
        epoch, b = divmod(step, self.plan.steps)
        if epoch != self._epoch:
            self._perm = torch.from_numpy(
                self.plan._perm(0, epoch, self.plan.n_res)).to(self.dev)
            self._epoch = epoch
        pb = self.plan.res_pb
        return self._perm[b * pb:(b + 1) * pb]


def resolve_stage_depth(cfg: DataConfig) -> int:
    return cfg.stage_depth if cfg.stage_depth > 0 else max(
        2, cfg.prefetch_batches
    )


def train_batches(
    data_dir: str,
    split: str,
    cfg: DataConfig,
    image_size: int,
    seed: int = 0,
    skip_batches: int = 0,
    mesh=None,
    max_fraction: float = 0.6,
    knobs=None,
    decoder_factory=None,
    device: "str | torch.device | None" = None,
) -> Iterator[dict]:
    """Endless batches ``{'image': uint8 [B, S, S, 3], 'grade': int32
    [B]}`` on the card, whose rows mix the resident and streamed tiers;
    the reference's batches for (seed, step, residency). ``skip_batches``
    is an O(1) step offset. Nothing happens before the first ``next()``:
    the budget (``data.tiered_resident_bytes``; -1 is
    ``hbm_pipeline.hbm_budget_bytes``, 0.6 of the card's memory) is read
    and the resident tier decoded and uploaded then.

    ``knobs`` (``data/autotune.Knobs``): live decode_workers/stage_depth
    the fill polls between batches; both are content-invariant.

    ``decoder_factory`` (``(workers, quarantine) -> decoder``): swap the
    record-decode stage while keeping all of this loader's machinery.
    The decoder contract is ``grain_pipeline.ParallelDecoder``'s surface
    (``__len__``, ``decode_batch``, ``decode_range``, ``set_workers``,
    ``close``); ``data/rawshard.py`` plugs its shard reader in here."""
    if mesh is not None or _process_count() > 1:
        raise NotImplementedError(
            f"tiered_pipeline.train_batches: {_MULTI_DEVICE}")
    dev = device_lib.resolve(device)
    workers = (
        knobs.decode_workers if knobs is not None
        else grain_pipeline.resolve_decode_workers(cfg.decode_workers)
    )
    if decoder_factory is None:
        index = grain_pipeline.TFRecordIndex(
            tfrecord.list_split(data_dir, split))
        decoder = grain_pipeline.ParallelDecoder(
            index, image_size, workers=workers,
            quarantine=cfg.quarantine_bad_records,
        )
    else:
        decoder = decoder_factory(workers, cfg.quarantine_bad_records)
    try:
        n = len(decoder)
        if n == 0:
            raise ValueError(f"no records under {data_dir}/{split}")
        capacity = resident_row_capacity(
            image_size, 1, max_fraction,
            budget_bytes=(cfg.tiered_resident_bytes
                          if cfg.tiered_resident_bytes >= 0 else None),
            budget_base_bytes=cfg.hbm_budget_bytes,
            device=dev,
        )
        plan = _TierPlan(n, cfg.batch_size, capacity, seed)
        # The reference's line, word for word.
        _log.info(
            "tiered loader: %d/%d rows HBM-resident (%.0f%%, %.1f MB over "
            "%d chip(s)), %d resident + %d streamed rows per batch, %d "
            "decode worker(s)",
            plan.n_res, n, 100.0 * plan.n_res / n,
            plan.n_res * row_bytes(image_size) / 1e6, 1,
            plan.res_pb, plan.str_pb, workers,
        )
        reg = obs_registry.default_registry()
        c_hit = reg.counter(
            "data.tiered.resident_rows",
            help="batch rows served from the resident HBM tier (cache "
                 "hits: on-device gather, zero H2D)",
        )
        c_spill = reg.counter(
            "data.tiered.streamed_rows",
            help="batch rows streamed through host decode + staged H2D "
                 "(spills); hit rate = resident / (resident + streamed)",
        )
        g_depth = reg.gauge(
            "data.tiered.stage_depth",
            help="the tiered loader's staging-queue depth (decode+H2D "
                 "run-ahead; the data.stage_depth target)",
        )
        h_decode = reg.histogram(
            "data.tiered.decode_batch_s",
            help="streamed-tier decode seconds per batch",
        )
        reg.gauge(
            "data.tiered.resident_rows_pinned",
            help="rows the HBM budget admitted into the resident tier",
        ).set(plan.n_res)
        g_host_spill = reg.gauge(
            "data.tiered.host_spill_rows",
            help="resident-tier rows THIS host decoded and staged (the "
                 "cross-host sharded spill plan's addressable shard; "
                 "single-process = the whole resident set)",
        )
        res_images = res_grades = order = None
        if plan.n_res:
            res_images, res_grades = stage_resident(decoder, plan.n_res,
                                                    device=dev)
            g_host_spill.set(plan.n_res)
            order = _ResidentOrder(plan, dev)
        depth = resolve_stage_depth(cfg)
        # Streamed rows -> the card (``pipeline.PinnedRing``). The ring
        # covers the batches the fill holds; a knob raise grows it.
        ring = pipeline.PinnedRing(dev, depth + 2)

        def fill(step: int) -> tuple:
            """Batch ``step``'s streamed rows decoded and their copy
            issued: (step, the rows on the card, the copy's event)."""
            _, str_ids = plan.batch_indices(step)
            c_hit.inc(plan.res_pb)
            c_spill.inc(plan.str_pb)
            if not plan.str_pb:
                return step, None, None
            t0 = time.perf_counter()
            host = decoder.decode_batch(str_ids)
            h_decode.observe(time.perf_counter() - t0)
            rows = {"image": host["image"], "grade": host["grade"]}
            if dev.type != "cuda":
                # On the CPU the decoded rows are the batch's.
                return step, {k: torch.from_numpy(v)
                              for k, v in rows.items()}, None
            ring.grow(depth + 2)
            return (step, *ring.put(rows))

        def combine(staged: tuple) -> dict:
            """The batch on the consumer's current stream: resident rows
            gathered, then the streamed rows."""
            step, rows, event = staged
            if rows is not None:
                rows = pipeline.wait_staged(rows, event, dev)
            if not plan.res_pb:
                return rows
            idx = order(step)
            images = res_images.index_select(0, idx)
            grades = res_grades.index_select(0, idx)
            if not plan.str_pb:
                return {"image": images, "grade": grades}
            return {"image": torch.cat([images, rows["image"]]),
                    "grade": torch.cat([grades, rows["grade"]])}

        queue: collections.deque = collections.deque()
        step = skip_batches
        while True:
            if knobs is not None:
                # Live knob poll: a raised depth fills deeper on this
                # pass, a lowered one lets the queue drain to it; worker
                # resizes land between decode calls.
                decoder.set_workers(knobs.decode_workers)
                depth = knobs.stage_depth
            while len(queue) <= depth:
                queue.append(fill(step + len(queue)))
            g_depth.set(len(queue))
            yield combine(queue.popleft())
            step += 1
    finally:
        decoder.close()


def host_reference_batches(
    data_dir: str,
    split: str,
    cfg: DataConfig,
    image_size: int,
    seed: int = 0,
    skip_batches: int = 0,
    capacity_rows: int = 0,
) -> Iterator[dict]:
    """The batch sequence ``train_batches`` must produce, recomputed from
    first principles: the same ``_TierPlan`` index selection, rows decoded
    directly to host arrays in batch order (numpy ``{'image', 'grade'}``)
    — no residency, no staging, no combine."""
    index = grain_pipeline.TFRecordIndex(tfrecord.list_split(data_dir, split))
    n = len(index)
    plan = _TierPlan(n, cfg.batch_size, capacity_rows, seed)
    decoder = grain_pipeline.ParallelDecoder(
        index, image_size, workers=1,
        quarantine=cfg.quarantine_bad_records,
    )
    step = skip_batches
    try:
        while True:
            res_ids, str_ids = plan.batch_indices(step)
            yield decoder.decode_batch(
                np.concatenate([res_ids, str_ids]).astype(np.int64)
            )
            step += 1
    finally:
        decoder.close()


def streamed_batches(
    data_dir: str,
    split: str,
    cfg: DataConfig,
    image_size: int,
    seed: int = 0,
    skip_batches: int = 0,
    mesh=None,
    device: "str | torch.device | None" = None,
) -> Iterator[dict]:
    """The pure streamed tier as a loader of its own: parallel host
    decode + staged upload, nothing resident — ``train_batches`` with a
    zero budget."""
    return train_batches(
        data_dir, split,
        dataclasses.replace(cfg, tiered_resident_bytes=0),
        image_size, seed=seed, skip_batches=skip_batches, mesh=mesh,
        device=device,
    )
