"""The train stream's record reading, as a function of the batch index,
and the reader processes that run it (``pipeline.train_batches``).

This module imports numpy, the port's TFRecord reader and resize, and
the fault plane (no torch): the reader processes are forked from a
forkserver that preloads it, a clean single-threaded interpreter, never from the trainer's
process, whose other threads (the prefetcher, the saver, an overlapped
eval, CUDA's) may hold a lock at the moment of a fork. Each reader loads
the image codec library itself (``init``).

A reader does not inherit the trainer's fault plan (the forkserver may
predate it): ``init`` arms the spec it is given, and ``read_into``
returns, with the slot, what the batch added to the reader's retry
counters and plan counts, for the trainer to add to its own
(``pipeline.train_batches``). Call ordinals count per reader.
"""

from __future__ import annotations

from multiprocessing import shared_memory

import numpy as np

from jama16_retina_tpu_torch.data import resize, tfrecord
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry


def decode(data, image_size: int) -> tfrecord.Record:
    """One record, decoded and at ``image_size``: a record of another size
    is resized as the reference's pipeline resizes it
    (``resize.tf_bilinear_u8``)."""
    rec = tfrecord.parse_record(data)
    if rec.image.shape[:2] != (image_size, image_size):
        rec = rec._replace(image=resize.tf_bilinear_u8(rec.image, image_size))
    return rec


class TrainOrder:
    """The train stream of a split as a function of the batch index: the
    records of batch ``k`` are positions ``k * B .. (k + 1) * B - 1`` of
    the endless sequence of epoch permutations. ``rows`` (start, stop)
    reads only that block of each batch (a rank's rows); the other
    records of the batch are not read."""

    def __init__(self, data_dir: str, split: str, batch_size: int,
                 image_size: int, seed: int,
                 rows: "tuple[int, int] | None" = None):
        self.paths = tfrecord.list_split(data_dir, split)
        self.spans = [(f, i, s) for f, p in enumerate(self.paths)
                      for i, s in enumerate(tfrecord.index_records(p))]
        if not self.spans:
            raise ValueError(f"split {split!r} in {data_dir!r} has no "
                             "records")
        self.batch_size, self.image_size, self.seed = (batch_size,
                                                       image_size, seed)
        self.rows = (0, batch_size) if rows is None else tuple(rows)
        self._perm: "tuple[int, np.ndarray] | None" = None

    def shape(self) -> tuple:
        return (self.rows[1] - self.rows[0], self.image_size,
                self.image_size, 3)

    def _order(self, epoch: int) -> np.ndarray:
        if self._perm is None or self._perm[0] != epoch:
            self._perm = (epoch, np.random.default_rng(
                [self.seed, epoch]).permutation(len(self.spans)))
        return self._perm[1]

    def open_files(self) -> list:
        return [open(p, "rb") for p in self.paths]

    def fill(self, index: int, files: list, rows: np.ndarray,
             grades: np.ndarray) -> None:
        """Read batch ``index`` (its block ``self.rows``) through
        ``files`` (one open handle per file of the split) into ``rows``
        [b, S, S, 3] and ``grades`` [b]."""
        n = len(self.spans)
        start, stop = self.rows
        for j in range(start, stop):
            pos = index * self.batch_size + j
            f, i, span = self.spans[self._order(pos // n)[pos % n]]
            rec = decode(tfrecord.read_record_at(
                files[f], span, self.paths[f], i), self.image_size)
            rows[j - start] = rec.image
            grades[j - start] = rec.grade


def slot_bytes(slots: int, shape: tuple) -> int:
    return slots * (int(np.prod(shape)) + 4 * shape[0])


def slot_views(buf, slots: int, shape: tuple
               ) -> "tuple[np.ndarray, np.ndarray]":
    """The ``slots`` batch buffers in ``buf``: uint8 images
    [slots, B, S, S, 3], then int32 grades [slots, B]."""
    n = slots * int(np.prod(shape))
    return (np.frombuffer(buf, np.uint8, n).reshape((slots,) + shape),
            np.frombuffer(buf, np.int32, slots * shape[0],
                          offset=n).reshape(slots, shape[0]))


# A reader process's state (``init``): its TrainOrder, its open files,
# the shared batch buffers, and the retry and fault counts already
# reported.
_READER: dict = {}


def init(order: TrainOrder, shared_name: str, slots: int,
         fault_spec: "dict | None" = None) -> None:
    """Reader process initializer: attach the batch buffers the stream
    owns (shared memory ``shared_name``), open the split's files and arm
    ``fault_spec`` (the trainer's plan, already validated there), or
    nothing."""
    from jama16_retina_tpu_torch.ops import image_codec

    image_codec.lib()  # built (once, behind its digest) and bound here
    faultinject.arm(fault_spec, allow_unknown=True)
    shm = shared_memory.SharedMemory(name=shared_name)
    images, grades = slot_views(shm.buf, slots, order.shape())
    _READER.update(order=order, files=order.open_files(), shm=shm,
                   images=images, grades=grades, retries={}, faults={})


def _deltas(now: dict, seen: dict) -> dict:
    """What ``now`` adds to ``seen`` ({name: number}), which takes it in."""
    out = {k: v - seen.get(k, 0) for k, v in now.items()
           if v != seen.get(k, 0)}
    seen.update(now)
    return out


def read_into(index: int, slot: int) -> "tuple[int, dict | None]":
    """Read batch ``index`` into ``slot``; (slot, None) or (slot, the
    ``{"retries": {counter: n}, "faults": {site: {"calls", "fires"}}}``
    this batch added)."""
    r = _READER
    r["order"].fill(index, r["files"], r["images"][slot], r["grades"][slot])
    retries = _deltas(
        {k: v for k, v in obs_registry.default_registry().snapshot()[
            "counters"].items() if k.startswith("io.retries")},
        r["retries"])
    plan = faultinject.active_plan()
    faults = {}
    if plan is not None:
        flat = _deltas({(s, k): v for s, c in plan.counts().items()
                        for k, v in c.items()}, r["faults"])
        for (s, k), v in flat.items():
            faults.setdefault(s, {"calls": 0, "fires": 0})[k] = v
    if not retries and not faults:
        return slot, None
    return slot, {"retries": retries, "faults": faults}
