"""Input pipeline of the port (counterpart of
``jama16_retina_tpu/data/pipeline.py``): TFRecord splits -> uint8 batches.

``eval_batches`` yields the reference's eval stream bit for bit: the same
records in the same order, in batches of ``batch_size`` whose last one is
zero-padded, with the same ``grade``, ``name`` and ``mask``. The order is
tf.data's deterministic ``interleave`` over the split's files
(``_serialized_stream``): ``cycle_length = min(4, n_files)``, block length
1, round-robin over the open files, and a file that runs out gives its
slot in the cycle to the next unopened file when the cycle comes back to
that slot (``interleave_records``).

``train_batches`` is the port's own train stream. tf.data's seeded
shuffle buffer cannot be reproduced outside TensorFlow, so the port
shuffles the whole split instead: epoch e is the permutation
``default_rng([seed, e])`` of the split's records (file order, then
record order), epochs follow each other and are cut into batches of
``batch_size`` (the last partial batch of an epoch runs on into the next,
as ``shuffle().repeat().batch(drop_remainder=True)`` does). The stream is
a pure function of (files, seed), so ``skip_batches=k`` starts exactly
where an uninterrupted run stood after k batches, without reading the
skipped records. Same records as the reference, in a different order
(ROADMAP Queue C).

Records must be raw-encoded at ``model.image_size``: JPEG records raise
``NotImplementedError`` (ROADMAP Queue A item 7), and records of another
size raise ``ValueError`` (the reference resizes them bilinearly in
TensorFlow; the port has no counterpart).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import tfrecord


def interleave_records(paths: Sequence[str],
                       cycle_length: int = 4) -> Iterator[bytes]:
    """The records of ``paths`` in the order of tf.data's deterministic
    ``interleave(TFRecordDataset, cycle_length=min(cycle_length,
    len(paths)))`` with block length 1."""
    cycle = min(cycle_length, len(paths))
    files = iter(paths)
    slots: "list[Iterator[bytes] | None]" = [None] * cycle
    end_of_input, n_open, i = False, 0, 0
    try:
        while not end_of_input or n_open > 0:
            if slots[i] is not None:
                record = next(slots[i], None)
                if record is not None:
                    yield record
                    i = (i + 1) % cycle
                    continue
                slots[i] = None
                n_open -= 1
                i = (i + 1) % cycle
            elif not end_of_input:
                path = next(files, None)
                if path is None:
                    end_of_input = True
                else:
                    slots[i] = tfrecord.read_records(path)
                    n_open += 1
            else:
                i = (i + 1) % cycle
    finally:
        for s in slots:
            if s is not None:
                s.close()


def _decode(data, image_size: int) -> tfrecord.Record:
    rec = tfrecord.parse_record(data)
    if rec.image.shape != (image_size, image_size, 3):
        raise ValueError(
            f"record {rec.name!r} is {list(rec.image.shape)}, not "
            f"[{image_size}, {image_size}, 3]: the port does not resize "
            "records (the reference resizes them bilinearly in TensorFlow); "
            "write the split at model.image_size")
    return rec


def eval_batches(data_dir: str, split: str, batch_size: int,
                 image_size: int) -> Iterator[dict]:
    """One epoch of padded batches ``{'image', 'grade', 'name', 'mask'}``:
    uint8 ``[B, S, S, 3]``, int32 ``[B]``, object ``[B]`` (bytes) and
    float32 ``[B]``; rows with mask 0 are padding."""
    paths = tfrecord.list_split(data_dir, split)
    records = interleave_records(paths)
    while True:
        rows = []
        for data in records:
            rows.append(_decode(data, image_size))
            if len(rows) == batch_size:
                break
        if not rows:
            return
        n = len(rows)
        image = np.zeros((batch_size, image_size, image_size, 3), np.uint8)
        for j, r in enumerate(rows):
            image[j] = r.image
        grade = np.zeros((batch_size,), np.int32)
        grade[:n] = [r.grade for r in rows]
        name = np.full((batch_size,), b"", object)
        name[:n] = [r.name for r in rows]
        yield {"image": image, "grade": grade, "name": name,
               "mask": (np.arange(batch_size) < n).astype(np.float32)}
        if n < batch_size:
            return


def train_batches(data_dir: str, split: str, cfg: DataConfig,
                  image_size: int, seed: int = 0, skip_batches: int = 0,
                  pin_memory: bool = False) -> Iterator[dict]:
    """Endless shuffled batches ``{'image': uint8 [B, S, S, 3], 'grade':
    int32 [B]}`` as CPU tensors, in pinned memory when ``pin_memory``, so
    ``.to(device, non_blocking=True)`` copies them without blocking the
    host."""
    paths = tfrecord.list_split(data_dir, split)
    spans = [(f, i, s) for f, p in enumerate(paths)
             for i, s in enumerate(tfrecord.index_records(p))]
    n, b = len(spans), cfg.batch_size
    if n == 0:
        raise ValueError(f"split {split!r} in {data_dir!r} has no records")
    files = [open(p, "rb") for p in paths]
    try:
        pos = skip_batches * b
        epoch, order = -1, None
        while True:
            image = torch.empty((b, image_size, image_size, 3),
                                dtype=torch.uint8, pin_memory=pin_memory)
            grade = torch.empty((b,), dtype=torch.int32,
                                pin_memory=pin_memory)
            rows, grades = image.numpy(), grade.numpy()
            for j in range(b):
                if pos // n != epoch:
                    epoch = pos // n
                    order = np.random.default_rng([seed, epoch]).permutation(n)
                f, i, span = spans[order[pos % n]]
                rec = _decode(tfrecord.read_record_at(
                    files[f], span, paths[f], i), image_size)
                rows[j] = rec.image
                grades[j] = rec.grade
                pos += 1
            yield {"image": image, "grade": grade}
    finally:
        for f in files:
            f.close()

