"""The train stream's record reading, as a function of the batch index,
and the reader processes that run it (``pipeline.train_batches``).

This module imports numpy and the port's TFRecord reader and resize
only: the reader processes are forked from a forkserver that preloads
it, a clean single-threaded interpreter, never from the trainer's
process, whose other threads (the prefetcher, the saver, an overlapped
eval, CUDA's) may hold a lock at the moment of a fork. Each reader loads
the image codec library itself (``init``).
"""

from __future__ import annotations

from multiprocessing import shared_memory

import numpy as np

from jama16_retina_tpu_torch.data import resize, tfrecord


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
    the endless sequence of epoch permutations."""

    def __init__(self, data_dir: str, split: str, batch_size: int,
                 image_size: int, seed: int):
        self.paths = tfrecord.list_split(data_dir, split)
        self.spans = [(f, i, s) for f, p in enumerate(self.paths)
                      for i, s in enumerate(tfrecord.index_records(p))]
        if not self.spans:
            raise ValueError(f"split {split!r} in {data_dir!r} has no "
                             "records")
        self.batch_size, self.image_size, self.seed = (batch_size,
                                                       image_size, seed)
        self._perm: "tuple[int, np.ndarray] | None" = None

    def shape(self) -> tuple:
        return (self.batch_size, self.image_size, self.image_size, 3)

    def _order(self, epoch: int) -> np.ndarray:
        if self._perm is None or self._perm[0] != epoch:
            self._perm = (epoch, np.random.default_rng(
                [self.seed, epoch]).permutation(len(self.spans)))
        return self._perm[1]

    def open_files(self) -> list:
        return [open(p, "rb") for p in self.paths]

    def fill(self, index: int, files: list, rows: np.ndarray,
             grades: np.ndarray) -> None:
        """Read batch ``index`` through ``files`` (one open handle per
        file of the split) into ``rows`` [B, S, S, 3] and ``grades``
        [B]."""
        n = len(self.spans)
        for j in range(self.batch_size):
            pos = index * self.batch_size + j
            f, i, span = self.spans[self._order(pos // n)[pos % n]]
            rec = decode(tfrecord.read_record_at(
                files[f], span, self.paths[f], i), self.image_size)
            rows[j] = rec.image
            grades[j] = rec.grade


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


# A reader process's state (``init``): its TrainOrder, its open files and
# the shared batch buffers.
_READER: dict = {}


def init(order: TrainOrder, shared_name: str, slots: int) -> None:
    """Reader process initializer: attach the batch buffers the stream
    owns (shared memory ``shared_name``) and open the split's files."""
    from jama16_retina_tpu_torch.ops import image_codec

    image_codec.lib()  # built (once, behind its digest) and bound here
    shm = shared_memory.SharedMemory(name=shared_name)
    images, grades = slot_views(shm.buf, slots, order.shape())
    _READER.update(order=order, files=order.open_files(), shm=shm,
                   images=images, grades=grades)


def read_into(index: int, slot: int) -> int:
    r = _READER
    r["order"].fill(index, r["files"], r["images"][slot], r["grades"][slot])
    return slot
