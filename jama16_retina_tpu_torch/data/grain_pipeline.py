"""Random-access records and the parallel decoder with its poison
quarantine (counterpart of the parts of
``jama16_retina_tpu/data/grain_pipeline.py`` that the ``hbm`` loader
runs: ``TFRecordIndex``, ``_decode_example``, ``resolve_decode_workers``
and ``ParallelDecoder``).

The reference's grain loader itself (``make_train_iterator``,
``state_at_step``, ``train_batches``: ``data.loader="grain"``) is not
ported yet; it comes with a slice of its own (ROADMAP.md Queue A item 7,
part 2).

Where the decode here differs from the ``tfdata`` records path
(``data/readers.decode``), it differs as the reference's does:

- the index does not check CRCs (``tfrecord.read_record_at`` does): a
  damaged payload is kept when it still parses, and surfaces as a
  parse or decode error, and so a quarantined record, when it does not;
- a JPEG record is decoded as ``cv2.imdecode(IMREAD_COLOR)`` decodes it,
  EXIF orientation applied (``data/imdecode.read_image``);
- a record stored at another size is resized as ``cv2.resize(...,
  INTER_LINEAR)`` (``preprocess/imgproc.resize_linear``), not as TF's
  bilinear.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np

from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.utils import retry as retry_lib

_log = logging.getLogger(__name__)


class TFRecordIndex:
    """Random-access index over TFRecord shards.

    TFRecord framing per record: u64le payload length, u32 masked CRC of
    the length, payload, u32 masked CRC of the payload. The index stores
    payload extents only; CRCs are not verified (the reference's stance)
    — a torn file surfaces as a proto parse error instead.
    """

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self._extents: "list[tuple[int, int, int]]" = []  # (path_i, off, len)
        self._files: "dict[int, int]" = {}  # lazy per-shard descriptors
        self._open_lock = threading.Lock()
        for pi, path in enumerate(self.paths):
            with open(path, "rb") as f:
                off = 0
                while True:
                    header = f.read(12)
                    if not header:
                        break
                    if len(header) < 12:
                        raise ValueError(
                            f"truncated TFRecord header in {path}")
                    (length,) = struct.unpack("<Q", header[:8])
                    self._extents.append((pi, off + 12, length))
                    off += 12 + length + 4
                    f.seek(off)

    def __len__(self) -> int:
        return len(self._extents)

    def _pread(self, pi: int, length: int, off: int) -> bytes:
        """One positioned read through the ``tfrecord.read`` fault seam
        (an error, a latency or damaged bytes)."""
        fd = self._files.get(pi)
        if fd is None:
            # Locked first open: two racing decode threads would both
            # open, and the loser's descriptor would leak.
            with self._open_lock:
                fd = self._files.get(pi)
                if fd is None:
                    fd = self._files[pi] = os.open(self.paths[pi],
                                                   os.O_RDONLY)
        return faultinject.corrupt("tfrecord.read",
                                   os.pread(fd, length, off))

    def read(self, i: int) -> bytes:
        """Record ``i``'s payload. One descriptor per shard, shared by the
        decode threads (``os.pread`` has no shared cursor). An
        ``OSError`` is retried up to 3 times (``io.retries.tfrecord.
        read``); one that still fails is raised for the decoder's
        quarantine."""
        pi, off, length = self._extents[i]
        return retry_lib.retry_call(self._pread, pi, length, off,
                                    attempts=4, site="tfrecord.read")

    # Picklable without its descriptors and lock, which are per process.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_files"] = {}
        del state["_open_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_lock = threading.Lock()

    def __del__(self):
        for fd in self.__dict__.get("_files", {}).values():
            try:
                os.close(fd)
            except OSError:
                pass


def _values(feats: dict, name: str, kind: str) -> list:
    """A feature's values when it holds ``kind``, else [] (protobuf's
    empty list of the other kinds)."""
    got = feats.get(name)
    return got[1] if got is not None and got[0] == kind else []


def _decode_example(payload: bytes, image_size: int) -> "dict[str, Any]":
    """Serialized tf.train.Example -> {'image': u8[S,S,3], 'grade':
    int32}, as the reference's ``_decode_example`` reads it: the first
    value of each feature, a raw record reshaped to its height and width,
    else the encoded image decoded as ``cv2.imdecode(IMREAD_COLOR)`` does
    (RGB here), and a record of another size resized as ``cv2.resize(...,
    INTER_LINEAR)``. A payload that does not parse, decode or reshape
    raises (``ValueError``, ``IndexError``, ...)."""
    from jama16_retina_tpu_torch.data import imdecode
    from jama16_retina_tpu_torch.preprocess import imgproc

    feats = tfrecord.parse_example(payload)
    raw = _values(feats, "image/raw", "bytes")
    if raw and raw[0]:
        h = _values(feats, "image/height", "int64")[0]
        w = _values(feats, "image/width", "int64")[0]
        image = np.frombuffer(raw[0], np.uint8).reshape(h, w, 3)
    else:
        encoded = _values(feats, "image/encoded", "bytes")[0]
        image, why = imdecode.read_image(encoded)
        if image is None:
            raise ValueError(why or "JPEG decode failed")
    if image.shape[:2] != (image_size, image_size):
        image = imgproc.resize_linear(image, image_size, image_size)
    grade = np.int32(_values(feats, "image/grade", "int64")[0])
    return {"image": np.ascontiguousarray(image), "grade": grade}


def resolve_decode_workers(requested: int) -> int:
    """``data.decode_workers``: a positive count as given; 0 is one thread
    per core up to 8, leaving one core for the step's thread (1 on a
    1-core host)."""
    if requested > 0:
        return requested
    cpus = os.cpu_count() or 1
    return max(1, min(8, cpus - 1))


def _batch_dicts(rows) -> "dict[str, np.ndarray]":
    return {
        "image": np.stack([r["image"] for r in rows]),
        "grade": np.asarray([r["grade"] for r in rows], np.int32),
    }


class ParallelDecoder:
    """Deterministic multi-thread decode over a ``TFRecordIndex``.

    Output depends only on the record ids asked for, never on the worker
    count or the schedule: ``decode_batch`` maps ids in order, and
    ``decode_range`` has each worker fill a disjoint slice of one
    preallocated array. Threads, as in the reference: the codec's C
    loops (``ops/csrc/image_codec.c`` through ctypes) release the
    interpreter lock; the proto parse is Python and does not.

    Poison quarantine: a record whose read or decode fails is counted in
    ``data.quarantined`` and ``data.quarantined.{read_error,
    decode_error}`` (an ``OSError`` is a read error, anything else a
    decode error) and replaced by the next decodable record, scanning
    forward and wrapping; each further failure on the scan counts in
    ``data.quarantined`` again. Only a split where every record fails
    raises (``ValueError``). ``quarantine=False`` raises the first
    failure instead.
    """

    def __init__(self, index: TFRecordIndex, image_size: int,
                 workers: int = 1,
                 registry: "obs_registry.Registry | None" = None,
                 quarantine: bool = True):
        self.index = index
        self.image_size = image_size
        self.workers = max(1, int(workers))
        self.quarantine = bool(quarantine)
        self._registry = (registry if registry is not None
                          else obs_registry.default_registry())
        self._c_records = self._registry.counter(
            "data.decode.records",
            help="records decoded by the parallel host decode pool")
        self._c_busy = self._registry.counter(
            "data.decode.busy_s",
            help="summed per-record decode seconds across pool workers; "
                 "utilization = delta / (wall x workers)")
        self._c_quarantined = self._registry.counter(
            "data.quarantined",
            help="records skipped by the poison quarantine (corrupt "
                 "payload / failed decode), all reasons; the "
                 "data_quarantine alert rule reads this burn rate")
        self._registry.gauge(
            "data.decode.workers",
            help="decode threads in the parallel host pool (live-"
                 "resized by the ingest autotuner)").set(self.workers)
        self._pool = self._make_pool(self.workers)

    @staticmethod
    def _make_pool(n: int) -> "ThreadPoolExecutor | None":
        return (ThreadPoolExecutor(max_workers=n,
                                   thread_name_prefix="jama16-decode")
                if n > 1 else None)

    def __len__(self) -> int:
        return len(self.index)

    def set_workers(self, n: int) -> None:
        """Resize the pool between decode calls (never during one); the
        output does not change."""
        n = max(1, int(n))
        if n == self.workers:
            return
        old = self._pool
        self.workers = n
        self._pool = self._make_pool(n)
        if old is not None:
            old.shutdown(wait=False)
        self._registry.gauge("data.decode.workers").set(n)

    def _read_decode(self, i: int, n: "int | None" = None) -> dict:
        return _decode_example(self.index.read(i % n if n else i),
                               self.image_size)

    def _quarantine_substitute(self, i: int, n: "int | None",
                               exc: Exception) -> dict:
        """Count the poison record and return the next decodable one."""
        total = n if n else len(self.index)
        reason = "read_error" if isinstance(exc, OSError) else "decode_error"
        self._c_quarantined.inc()
        self._registry.counter(
            f"data.quarantined.{reason}",
            help="poison records quarantined for this one reason "
                 "(decode_error/read_error)").inc()
        _log.warning("record %d quarantined (%s: %s); substituting the next "
                     "decodable record", i, type(exc).__name__, exc)
        for k in range(1, total):
            try:
                return self._read_decode((i + k) % total, n)
            except Exception:  # noqa: BLE001 - keep scanning
                self._c_quarantined.inc()
        raise ValueError(
            f"every record in the split failed to decode (started from "
            f"record {i}) — this is not a poison record, the dataset is "
            "destroyed") from exc

    def _decode_one(self, i: int, n: "int | None" = None) -> dict:
        if not self._registry.enabled and not self.quarantine:
            return self._read_decode(i, n)
        t0 = time.perf_counter() if self._registry.enabled else 0.0
        try:
            row = self._read_decode(i, n)
        except Exception as e:  # noqa: BLE001 - the quarantine decides
            if not self.quarantine:
                raise
            row = self._quarantine_substitute(i, n, e)
        if self._registry.enabled:
            self._c_busy.inc(time.perf_counter() - t0)
            self._c_records.inc()
        return row

    def decode_batch(self, ids) -> "dict[str, np.ndarray]":
        """ids -> {'image': u8[len(ids), S, S, 3], 'grade':
        i32[len(ids)]} in ``ids`` order."""
        ids = [int(i) for i in ids]
        if self._pool is None:
            rows = [self._decode_one(i) for i in ids]
        else:
            rows = list(self._pool.map(self._decode_one, ids))
        return _batch_dicts(rows)

    def decode_range(self, start: int, stop: int, n: "int | None" = None
                     ) -> "tuple[np.ndarray, np.ndarray]":
        """Rows [start, stop) into preallocated uint8 / int32 arrays, each
        worker filling a disjoint slice. ``n`` wraps row ids past the
        record count."""
        count = stop - start
        images = np.empty((count, self.image_size, self.image_size, 3),
                          np.uint8)
        grades = np.empty((count,), np.int32)

        def fill(lo: int, hi: int) -> None:
            for i in range(lo, hi):
                row = self._decode_one(i, n)
                images[i - start] = row["image"]
                grades[i - start] = row["grade"]

        if self._pool is None or count < 2 * self.workers:
            fill(start, stop)
            return images, grades
        chunk = -(-count // self.workers)
        futures = [self._pool.submit(fill, start + w * chunk,
                                     min(start + (w + 1) * chunk, stop))
                   for w in range(self.workers)]
        for f in futures:
            f.result()  # a decode error is raised on the caller's thread
        return images, grades

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
