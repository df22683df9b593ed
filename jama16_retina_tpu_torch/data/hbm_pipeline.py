"""Card-resident train input: the ``data.loader="hbm"`` option (counterpart
of ``jama16_retina_tpu/data/hbm_pipeline.py``).

The whole split is decoded once on the host (``grain_pipeline.
ParallelDecoder``, ``data.decode_workers`` threads, poison records
quarantined under ``data.quarantine_bad_records``) and uploaded to the
card once, as one uint8 ``[N, S, S, 3]`` tensor and one int32 ``[N]``
tensor. Every train batch after that is a gather on the card: no host
decode and no host-to-device copy of pixels on the step's path.

Batch selection is the reference's pure function of (seed, step):

    epoch = step // (n // B)               (drop-remainder epochs)
    perm  = random.permutation(fold_in(key(seed), epoch), n)
    idx   = perm[pos : pos + B]            (pos = (step % (n // B)) * B)

The permutation is JAX's threefry one, computed in numpy on the host
(``data/threefry.py``), once an epoch, and uploaded (n int64s) once an
epoch; a batch is two ``index_select`` calls on the current stream, the
stream the step that reads the batch runs on. So the batches are bitwise
the reference's for the same records, seed and step, and a resume at
step k (``skip_batches=k``) is an O(1) offset, not a replay.

The split must fit: its rows (``row_bytes``) against 0.6 of the card's
memory (``hbm_budget_bytes``: ``data.hbm_budget_bytes`` when set, else
the card's total memory from ``torch.cuda.mem_get_info``, else, as on the
CPU, an assumed 8 GB with a warning once a process). A mesh and the
multi-host load are not ported (ROADMAP.md Queue A item 8, part 2).
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np
import torch

from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import grain_pipeline, tfrecord, threefry
from jama16_retina_tpu_torch.obs import registry as obs_registry

_log = logging.getLogger(__name__)

_MULTI_DEVICE = ("a mesh (the rows sharded over its data axis, and the "
                 "multi-host load that decodes each process's rows) is not "
                 "ported yet; see ROADMAP.md Queue A item 8, part 2")
_FALLBACK_BYTES = 8 * 1024**3

# Warn-once latch for the no-limit fallback below (tests reset it).
_WARNED_NO_BYTES_LIMIT = False


def _decode_rows(index, start: int, stop: int, image_size: int,
                 n: "int | None" = None, workers: int = 1,
                 quarantine: bool = True
                 ) -> "tuple[np.ndarray, np.ndarray]":
    """Rows [start, stop) of a ``TFRecordIndex`` into preallocated uint8 /
    int32 arrays, through a ``ParallelDecoder`` of ``workers`` threads
    (its output does not depend on the count)."""
    decoder = grain_pipeline.ParallelDecoder(
        index, image_size, workers=workers, quarantine=quarantine)
    try:
        return decoder.decode_range(start, stop, n=n)
    finally:
        decoder.close()


def load_split_numpy(data_dir: str, split: str, image_size: int,
                     workers: int = 1, quarantine: bool = True
                     ) -> "tuple[np.ndarray, np.ndarray]":
    """Every record of a split, decoded once on the host: (images
    u8[N, S, S, 3], grades i32[N])."""
    index = grain_pipeline.TFRecordIndex(tfrecord.list_split(data_dir, split))
    n = len(index)
    if n == 0:
        raise ValueError(f"no records under {data_dir}/{split}")
    return _decode_rows(index, 0, n, image_size, workers=workers,
                        quarantine=quarantine)


def row_bytes(image_size: int) -> int:
    """Resident bytes one record costs: uint8 pixels + an int32 grade."""
    return image_size * image_size * 3 + 4


def dataset_bytes(n: int, image_size: int) -> int:
    return n * row_bytes(image_size)


def resident_row_capacity(image_size: int, n_devices: int = 1,
                          max_fraction: float = 0.6,
                          budget_bytes: "int | None" = None,
                          budget_base_bytes: int = 0,
                          device: "str | torch.device | None" = None) -> int:
    """How many rows the budget admits over ``n_devices`` cards:
    ``budget_bytes`` (a total) when given, else ``hbm_budget_bytes`` a
    card."""
    total = (budget_bytes if budget_bytes is not None
             else hbm_budget_bytes(max_fraction,
                                   budget_base_bytes=budget_base_bytes,
                                   device=device) * max(n_devices, 1))
    return max(0, total // row_bytes(image_size))


def hbm_budget_bytes(max_fraction: float = 0.6, budget_base_bytes: int = 0,
                     device: "str | torch.device | None" = None) -> int:
    """``max_fraction`` of a card's memory limit, the limit taken from, in
    order: ``budget_base_bytes`` (``data.hbm_budget_bytes``) when > 0; the
    card's total memory (``torch.cuda.mem_get_info``); else 8 GB, with a
    warning once a process naming the knob. ``device`` None is the card
    (``device.resolve``); the CPU reports no limit, as JAX's CPU backend
    reports no ``bytes_limit``."""
    if budget_base_bytes and budget_base_bytes > 0:
        return int(budget_base_bytes * max_fraction)
    dev = device_lib.resolve(device)
    limit = None
    if dev.type == "cuda":
        limit = torch.cuda.mem_get_info(dev)[1]
    if not limit:
        limit = _FALLBACK_BYTES
        global _WARNED_NO_BYTES_LIMIT
        if not _WARNED_NO_BYTES_LIMIT:
            _WARNED_NO_BYTES_LIMIT = True
            _log.warning(
                "device reports no memory limit: assuming a conservative "
                "%d GB budget base — set data.hbm_budget_bytes to this "
                "card's true memory limit to override", limit // 1024**3)
    return int(limit * max_fraction)


def fits_in_hbm(n: int, image_size: int, n_devices: int = 1,
                max_fraction: float = 0.6, budget_base_bytes: int = 0,
                device: "str | torch.device | None" = None) -> bool:
    """The size gate: the split's bytes a card against the budget a card."""
    per_card = dataset_bytes(n, image_size) / max(n_devices, 1)
    return per_card <= hbm_budget_bytes(
        max_fraction, budget_base_bytes=budget_base_bytes, device=device)


class _EpochOrder:
    """The epoch permutations, one computed and uploaded at a time."""

    def __init__(self, seed: int, n: int, dev: torch.device):
        self.seed, self.n, self.dev = seed, n, dev
        self._epoch = -1
        self._perm: "torch.Tensor | None" = None

    def __call__(self, epoch: int) -> torch.Tensor:
        if epoch != self._epoch:
            self._perm = torch.from_numpy(threefry.epoch_permutation(
                self.seed, epoch, self.n)).to(self.dev)
            self._epoch = epoch
        return self._perm


def make_batch_fn(images: np.ndarray, grades: np.ndarray, batch_size: int,
                  seed: int, mesh=None, n_records: "int | None" = None,
                  device: "str | torch.device | None" = None):
    """Upload the split to the card -> ``step -> {'image', 'grade'}``, a
    gather of the step's rows on the card (on the current stream).
    ``n_records`` < the rows leaves the rows past it unsampled."""
    if mesh is not None:
        raise NotImplementedError(f"hbm_pipeline.make_batch_fn: {_MULTI_DEVICE}")
    dev = device_lib.resolve(device)
    n = int(n_records) if n_records is not None else images.shape[0]
    if batch_size > n:
        raise ValueError(f"batch_size={batch_size} exceeds dataset n={n}")
    steps_per_epoch = n // batch_size
    resident_images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    resident_grades = torch.from_numpy(
        np.ascontiguousarray(grades, np.int32)).to(dev)
    order = _EpochOrder(seed, n, dev)

    def get_batch(step: int) -> "dict[str, torch.Tensor]":
        epoch, pos = divmod(step, steps_per_epoch)
        idx = order(epoch)[pos * batch_size:(pos + 1) * batch_size]
        return {"image": resident_images.index_select(0, idx),
                "grade": resident_grades.index_select(0, idx)}

    return get_batch


def train_batches(data_dir: str, split: str, cfg: DataConfig,
                  image_size: int, seed: int = 0, skip_batches: int = 0,
                  mesh=None, max_fraction: float = 0.6,
                  device: "str | torch.device | None" = None
                  ) -> Iterator[dict]:
    """Endless batches ``{'image': uint8 [B, S, S, 3], 'grade': int32
    [B]}`` born on the card, the reference's batches for (seed, step).
    ``skip_batches`` is an O(1) step offset. The split is decoded,
    gated and uploaded at the first ``next()``; the gate refuses a split
    over the budget with the reference's ``ValueError``."""
    if mesh is not None:
        raise NotImplementedError(
            f"hbm_pipeline.train_batches: {_MULTI_DEVICE}")
    dev = device_lib.resolve(device)
    workers = grain_pipeline.resolve_decode_workers(cfg.decode_workers)
    images, grades = load_split_numpy(
        data_dir, split, image_size, workers=workers,
        quarantine=cfg.quarantine_bad_records)
    n = len(images)
    budget_base = cfg.hbm_budget_bytes
    if not fits_in_hbm(n, image_size, 1, max_fraction,
                       budget_base_bytes=budget_base, device=dev):
        budget = hbm_budget_bytes(max_fraction,
                                  budget_base_bytes=budget_base, device=dev)
        # The reference's message, word for word.
        raise ValueError(
            f"{split} split ({dataset_bytes(n, image_size) / 1e9:.1f}"
            f" GB over 1 chip(s)) exceeds the HBM-resident budget "
            f"({budget / 1e9:.1f} GB/chip); use the tfdata or grain loader "
            "for datasets this size, or set data.hbm_budget_bytes if this "
            "chip's true memory limit is larger than the assumed base")
    get_batch = make_batch_fn(images, grades, cfg.batch_size, seed,
                              n_records=n, device=dev)
    del images, grades  # the card holds the split now
    reg = obs_registry.default_registry()
    reg.gauge(
        "data.hbm.resident_rows",
        help="rows of the split pinned device-resident by the hbm "
             "loader (the 100%-hit endpoint)").set(n)
    c_gather = reg.counter(
        "data.hbm.gather_batches",
        help="batches served as pure on-device gathers (zero "
             "steady-state H2D)")
    step = skip_batches
    while True:
        batch = get_batch(step)
        c_gather.inc()  # before the yield: the last batch counts too
        yield batch
        step += 1
