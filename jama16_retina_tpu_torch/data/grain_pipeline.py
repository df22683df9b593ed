"""The grain loader (``data.loader="grain"``) and the random-access
records and parallel decoder the other loaders share: the port's copy of
``jama16_retina_tpu/data/grain_pipeline.py`` without the ``grain``
package (``TFRecordIndex``, ``_decode_example``, ``resolve_decode_workers``,
``ParallelDecoder``, ``FundusSource``, ``make_train_iterator``,
``state_at_step`` and ``train_batches``).

The grain loader's batches are the reference's, record for record and in
order, and its iterator state is the reference's byte for byte: the order
is pygrain's ``IndexSampler`` (``data/grain_index.py``), and the iterator
(``GrainIterator``) keeps ``pygrain.DataLoader``'s bookkeeping. With
``worker_count=0`` the records are decoded in the consumer's process;
with ``W > 0``, W worker processes each read the sampler positions of
their slice (``w, w + W*P, ...``), batch their own records, and the
consumer takes their batches round-robin. ``state_at_step`` derives the
in-process state after k batches (O(1) resume); worker-mode positions
have no closed form, so the trainer persists ``get_state()`` next to each
checkpoint. A record that fails to decode raises: grain has no
quarantine (the reference's ``configs.py:164-172``).

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

import collections
import concurrent.futures
import json
import logging
import multiprocessing
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Any, Sequence

import numpy as np

from jama16_retina_tpu_torch.data import grain_index, tfrecord
from jama16_retina_tpu_torch.data import readers as readers_lib
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


class FundusSource:
    """The grain loader's random-access source over a split's TFRecord
    shards."""

    def __init__(self, data_dir: str, split: str, image_size: int):
        self.index = TFRecordIndex(tfrecord.list_split(data_dir, split))
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> "dict[str, Any]":
        return _decode_example(self.index.read(int(i)), self.image_size)

    def __repr__(self) -> str:  # part of the iterator state
        return f"FundusSource(n={len(self)}, size={self.image_size})"


def _resolve_process(process_index: "int | None",
                     process_count: "int | None") -> "tuple[int, int]":
    """(process index, count): one process unless the caller names a
    shard (the port trains in one process)."""
    if process_count is None:
        return 0, 1
    return process_index or 0, process_count


def _local_batch_size(global_batch: int, p_cnt: int, what: str) -> int:
    if global_batch % p_cnt:
        raise ValueError(
            f"{what}={global_batch} not divisible by process_count={p_cnt}")
    return global_batch // p_cnt


# A grain worker process's state (``_worker_init``): its slice, the
# sampler, the source and the shared batch slots.
_WORKER: dict = {}


def _worker_init(source: FundusSource, sampler: grain_index.IndexSampler,
                 geometry: tuple, shared_name: str, slots: int) -> None:
    """Worker process initializer: attach the batch slots (shared memory
    ``shared_name``) the consumer owns."""
    shm = shared_memory.SharedMemory(name=shared_name)
    shape = (geometry[4], source.image_size, source.image_size, 3)
    images, grades = readers_lib.slot_views(shm.buf, slots, shape)
    _WORKER.update(source=source, sampler=sampler, geometry=geometry,
                   shm=shm, images=images, grades=grades)


def _positions(geometry: tuple, start: int) -> np.ndarray:
    """Global sampler positions of the batch at slice position ``start``
    of worker ``w``: slice position j is the shard's local position
    ``w + j*W`` (``j`` itself in-process), global ``local*P + p``."""
    w, n_workers, p, p_cnt, bs = geometry
    j = np.arange(start, start + bs, dtype=np.int64)
    local = w + j * n_workers if n_workers else j
    return local * p_cnt + p


def _worker_fill(start: int, slot: int) -> int:
    """Decode the batch at slice position ``start`` into ``slot``."""
    wk = _WORKER
    keys = wk["sampler"].record_keys(_positions(wk["geometry"], start))
    for r, key in enumerate(keys):
        row = wk["source"][int(key)]
        wk["images"][slot, r] = row["image"]
        wk["grades"][slot, r] = row["grade"]
    return slot


def _worker_context():
    """Worker processes start from a forkserver that preloads this module,
    a clean single-threaded interpreter (never a fork of the trainer,
    whose other threads may hold a lock)."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", __name__])
    return ctx


_VERSION = 2
_PER_WORKER_SLOTS = 2


class GrainIterator:
    """``iter(pygrain.DataLoader(source, sampler, [Batch(drop_remainder=
    True)], worker_count))`` without grain: batches ``{'image': uint8 [b,
    S, S, 3], 'grade': int32 [b]}`` (numpy), and ``get_state()`` /
    ``set_state()`` with grain's state bytes.

    Bookkeeping, as grain's ``_DataLoaderStateDatasetIterator`` and
    ``MultiprocessPrefetchDatasetIterator`` keep it: each worker (one
    in-process) counts the records of its slice it has handed out
    (``next_index``); a state's ``last_seen_indices[i]`` is the global
    position of worker i's last record, ``p + i*P + (next_index - 1)*W*P``
    (W read as 1 in-process); ``last_worker_index`` is the worker whose
    batch came out last, and the next batch comes from the one after it.
    Each worker process decodes ``_PER_WORKER_SLOTS`` batches ahead into
    shared memory. A decode error raises where its batch would have come
    out. ``close()`` stops the workers."""

    def __init__(self, source: FundusSource,
                 sampler: grain_index.IndexSampler, batch_size: int,
                 worker_count: int = 0):
        if worker_count < 0:
            raise ValueError("Worker count should be greater than or equal "
                             f"zero.Current worker_count is {worker_count}.")
        self._source, self._sampler = source, sampler
        self._bs, self._workers_n = batch_size, worker_count
        opts = sampler.shard_options
        self._p, self._p_cnt = opts.shard_index, opts.shard_count
        self._next_index = [0] * max(1, worker_count)
        self._last_worker = -1
        # Started on the first batch after a construction or a set_state.
        self._pools: "list | None" = None
        self._pending: "list[collections.deque]" = []
        self._shared = None
        self._views = None
        self._closed = False

    def __iter__(self):
        return self

    def _geometry(self, w: int) -> tuple:
        return (w, self._workers_n, self._p, self._p_cnt, self._bs)

    def _decode(self, start: int) -> dict:
        keys = self._sampler.record_keys(_positions(self._geometry(0),
                                                    start))
        return _batch_dicts([self._source[int(k)] for k in keys])

    def _start_workers(self) -> None:
        n = self._workers_n
        shape = (self._bs, self._source.image_size,
                 self._source.image_size, 3)
        slots = n * _PER_WORKER_SLOTS
        self._shared = shared_memory.SharedMemory(
            create=True, size=readers_lib.slot_bytes(slots, shape))
        self._views = readers_lib.slot_views(self._shared.buf, slots, shape)
        ctx = _worker_context()
        self._pools, self._pending = [], []
        for w in range(n):
            pool = concurrent.futures.ProcessPoolExecutor(
                1, mp_context=ctx, initializer=_worker_init,
                initargs=(self._source, self._sampler, self._geometry(w),
                          self._shared.name, slots))
            self._pools.append(pool)
            self._pending.append(collections.deque(
                (pool.submit(_worker_fill,
                             self._next_index[w] + d * self._bs,
                             w * _PER_WORKER_SLOTS + d),
                 self._next_index[w] + d * self._bs)
                for d in range(_PER_WORKER_SLOTS)))

    def __next__(self) -> dict:
        if self._closed:
            raise RuntimeError("the grain iterator is closed")
        if self._workers_n == 0:
            batch = self._decode(self._next_index[0])
            self._next_index[0] += self._bs
            return batch
        if self._pools is None:
            self._start_workers()
        w = (self._last_worker + 1) % self._workers_n
        future, start = self._pending[w].popleft()
        slot = future.result()
        images, grades = self._views
        batch = {"image": images[slot].copy(), "grade": grades[slot].copy()}
        # The slot is copied out: the worker's batch _PER_WORKER_SLOTS
        # ahead reuses it.
        ahead = start + _PER_WORKER_SLOTS * self._bs
        self._pending[w].append(
            (self._pools[w].submit(_worker_fill, ahead, slot), ahead))
        self._next_index[w] = start + self._bs
        self._last_worker = w
        return batch

    def _state(self) -> dict:
        n = max(1, self._workers_n)
        gw = n * self._p_cnt
        return {
            "version": _VERSION,
            "last_seen_indices": {
                str(i): (self._p - gw + i * self._p_cnt
                         + self._next_index[i] * gw)
                for i in range(n)},
            "last_worker_index": self._last_worker,
            "worker_count": self._workers_n,
            "sampler": repr(self._sampler),
            "data_source": repr(self._source),
        }

    def get_state(self) -> bytes:
        return json.dumps(self._state(), indent=4).encode()

    def set_state(self, state: bytes) -> None:
        """Restore ``state`` (grain's bytes), checked against this loader
        as grain checks it; the workers restart from the new positions."""
        st = json.loads(state.decode())
        if st["worker_count"] != self._workers_n:
            raise ValueError(
                "Worker count in checkpoint does not match dataloader "
                f"worker count.\nworker count in checkpoint: "
                f"{st['worker_count']}\nworker count in dataloader: "
                f"{self._workers_n}")
        if st["sampler"] != repr(self._sampler):
            raise ValueError(
                "Sampler in checkpoint does not match dataloader sampler.\n"
                f"sampler in checkpoint: {st['sampler']}\n"
                f"sampler in dataloader: {self._sampler!r}")
        if st["data_source"] != repr(self._source):
            raise ValueError(
                "DataSource in checkpoint does not match datasource in "
                f"dataloader.\ndata source in checkpoint: "
                f"{st['data_source']}\ndata source in dataloader: "
                f"{self._source!r}")
        seen = st["last_seen_indices"]
        p, p_cnt = self._p, self._p_cnt
        if self._workers_n == 0:
            self._next_index = [(seen["0"] + p_cnt - p) // p_cnt]
            return
        gw = self._workers_n * p_cnt
        self._stop_workers()
        self._next_index = [(seen[str(i)] + gw - p - i * p_cnt) // gw
                            for i in range(self._workers_n)]
        self._last_worker = st["last_worker_index"]

    def _stop_workers(self) -> None:
        if self._pools is None:
            return
        for pool in self._pools:
            pool.shutdown(wait=True, cancel_futures=True)
        self._pools, self._pending = None, []
        # The views hold the buffer's memory: it closes only without them.
        self._views = None
        self._shared.close()
        self._shared.unlink()
        self._shared = None

    def close(self) -> None:
        """Stop the worker processes and free their slots; idempotent."""
        if not self._closed:
            self._closed = True
            self._stop_workers()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def make_train_iterator(data_dir: str, split: str, cfg, image_size: int,
                        seed: int = 0, process_index: "int | None" = None,
                        process_count: "int | None" = None,
                        worker_count: int = 0) -> GrainIterator:
    """Endless per-process batches of ``batch_size / P`` records, as the
    reference's grain iterator (``IndexSampler`` over the split, sharded
    with ``drop_remainder``, shuffled per epoch, batched with
    ``drop_remainder``), with ``get_state()``/``set_state()``."""
    p_idx, p_cnt = _resolve_process(process_index, process_count)
    local_bs = _local_batch_size(cfg.batch_size, p_cnt, "data.batch_size")
    source = FundusSource(data_dir, split, image_size)
    if len(source) == 0:
        raise ValueError(f"no records under {data_dir}/{split}")
    sampler = grain_index.IndexSampler(
        len(source), grain_index.ShardOptions(
            shard_index=p_idx, shard_count=p_cnt, drop_remainder=True),
        seed=seed)
    return GrainIterator(source, sampler, local_bs, worker_count)


def state_at_step(iterator: GrainIterator, step: int, local_batch_size: int,
                  process_index: int = 0, process_count: int = 1) -> bytes:
    """The state an uninterrupted in-process run has after ``step``
    batches: after k = step * local_batch_size records, shard p of P last
    read global position ``p + (k - 1) * P``. Defined for
    ``worker_count=0`` only: worker processes hand out whole batches
    round-robin, and their positions have no closed form."""
    state = json.loads(iterator.get_state().decode())
    if int(state["worker_count"]) > 0:
        raise NotImplementedError(
            "state_at_step derivation is defined for in-process loading "
            "(worker_count=0, the default); worker-process runs resume "
            "from the get_state() bytes the trainer persists next to "
            "each checkpoint (grain_state/<step>.json — absent here, so "
            "either this workdir predates worker-mode persistence or "
            "the state file for this step was lost)")
    k = step * local_batch_size
    state["last_seen_indices"] = {
        "0": process_index + (k - 1) * process_count if k else -1}
    state["last_worker_index"] = -1
    return json.dumps(state).encode()


def train_batches(data_dir: str, split: str, cfg, image_size: int,
                  seed: int = 0, process_index: "int | None" = None,
                  process_count: "int | None" = None, skip_batches: int = 0,
                  worker_count: int = 0,
                  initial_state: "bytes | None" = None) -> GrainIterator:
    """The grain loader's train stream: ``make_train_iterator`` from
    ``initial_state`` (the persisted worker-mode state) or, without it,
    from batch ``skip_batches`` through ``state_at_step`` (which raises
    for ``worker_count > 0``)."""
    it = make_train_iterator(data_dir, split, cfg, image_size, seed=seed,
                             process_index=process_index,
                             process_count=process_count,
                             worker_count=worker_count)
    if initial_state is not None:
        it.set_state(initial_state)
    elif skip_batches:
        p_idx, p_cnt = _resolve_process(process_index, process_count)
        local_bs = _local_batch_size(cfg.batch_size, p_cnt,
                                     "data.batch_size")
        try:
            it.set_state(state_at_step(it, skip_batches, local_bs, p_idx,
                                       p_cnt))
        except BaseException:
            it.close()
            raise
    return it
