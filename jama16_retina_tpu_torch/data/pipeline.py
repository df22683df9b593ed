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
(ROADMAP Queue C). ``readers`` reader processes read and decode whole
batches in parallel (tf.data's parallel parse; ``data/readers.py``), and
the batches still come out in the stream's order.

``DevicePrefetch`` (the reference's ``device_prefetch``) stages any
stream of host batches on the device ahead of the step: a thread copies
each batch into one of a ring of pinned host buffers and from there to
the card on a side stream, ``size`` (or the live ``knobs.prefetch_depth``)
batches ahead of the consumer, and publishes how many are staged ahead in
the ``data.prefetch.depth`` gauge of the process registry, as the
reference does. Its ring is ``PinnedRing``, which the tiered loader's
streamed rows also go through.

Records may be raw or JPEG-encoded (``tfrecord.parse_record``); a record
that is not at ``model.image_size`` is resized as the reference resizes
it (``readers.decode``).

Under a data mesh of P ranks (``process_index``, ``process_count``),
``train_batches`` yields the rank's block of each batch of the
one-process stream, ``eval_batches`` the rank's image rows with the whole
batch's metadata, and ``eval_batches_sharded`` (``eval.sharded``) the
reference's stride-sharded eval stream, bitwise.
"""

from __future__ import annotations

import collections
import concurrent.futures
import multiprocessing
import threading
from multiprocessing import shared_memory
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import readers as readers_lib
from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.utils import retry


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


def local_batch_size(global_batch: int, process_count: int,
                     what: str) -> int:
    """A process's rows of a global batch; refused, with the reference's
    message, when the processes do not divide it."""
    if global_batch % process_count:
        raise ValueError(f"{what}={global_batch} not divisible by "
                         f"process_count={process_count}")
    return global_batch // process_count


def eval_batches(data_dir: str, split: str, batch_size: int,
                 image_size: int, process_index: int = 0,
                 process_count: int = 1) -> Iterator[dict]:
    """One epoch of padded batches ``{'image', 'grade', 'name', 'mask'}``:
    uint8 ``[B, S, S, 3]``, int32 ``[B]``, object ``[B]`` (bytes) and
    float32 ``[B]``; rows with mask 0 are padding. Under ``process_count``
    P > 1, ``image`` is process ``process_index``'s block of each batch
    (rows ``[p B/P, (p + 1) B/P)``), and ``grade``, ``name`` and ``mask``
    stay the whole batch's, as in the reference: every process reads the
    whole split and makes the same number of batches."""
    local = local_batch_size(batch_size, process_count, "eval.batch_size")
    paths = tfrecord.list_split(data_dir, split)
    records = interleave_records(paths)
    while True:
        rows = []
        for data in records:
            rows.append(readers_lib.decode(data, image_size))
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
        if process_count > 1:
            image = image[process_index * local:(process_index + 1) * local]
        yield {"image": image, "grade": grade, "name": name,
               "mask": (np.arange(batch_size) < n).astype(np.float32)}
        if n < batch_size:
            return


def read_split_metadata(data_dir: str, split: str
                        ) -> "tuple[np.ndarray, np.ndarray]":
    """(grades int32 [n], names object [n] of bytes) of a split in the
    eval stream's record order, from a parse of each record that decodes
    no image."""
    grades, names = [], []
    for data in interleave_records(tfrecord.list_split(data_dir, split)):
        feats = tfrecord.parse_example(data)
        grades.append(int(tfrecord._scalar(feats, "image/grade", "int64")))
        names.append(tfrecord._scalar(feats, "image/name", "bytes", b""))
    out = np.empty((len(names),), object)
    out[:] = names
    return np.asarray(grades, np.int32), out


def eval_batches_sharded(data_dir: str, split: str, batch_size: int,
                         image_size: int, process_index: int = 0,
                         process_count: int = 1) -> Iterator[dict]:
    """The eval stream with each process decoding only every P-th record
    (``eval.sharded``, the reference's ``eval_batches_sharded``): process
    p decodes records p, p + P, ... of the eval order, ``B/P`` to a
    batch, so the assembled rank-major batch k holds at row ``p B/P + i``
    the record ``p + (k B/P + i) P``. ``grade``, ``name`` and ``mask``
    come from a parse-only pass (``read_split_metadata``) in that
    assembled order; every process yields ceil(n / B) batches. One
    process is the plain eval order."""
    p_idx, p_cnt = process_index, process_count
    local = local_batch_size(batch_size, p_cnt, "eval.batch_size")
    grades, names = read_split_metadata(data_dir, split)
    n = len(grades)
    if n == 0:
        return
    mine = (readers_lib.decode(data, image_size).image
            for i, data in enumerate(interleave_records(
                tfrecord.list_split(data_dir, split)))
            if i % p_cnt == p_idx)
    block = np.arange(local)
    for k in range(-(-n // batch_size)):
        imgs = np.zeros((local, image_size, image_size, 3), np.uint8)
        for j in range(local):
            img = next(mine, None)
            if img is None:
                break
            imgs[j] = img
        rec = np.concatenate([p + (k * local + block) * p_cnt
                              for p in range(p_cnt)])
        valid = rec < n
        safe = np.minimum(rec, n - 1)
        name = np.empty((batch_size,), object)
        name[:] = [names[r] if v else b"" for r, v in zip(safe, valid)]
        yield {"image": imgs,
               "grade": np.where(valid, grades[safe], 0).astype(np.int32),
               "name": name, "mask": valid.astype(np.float32)}


def _reader_context():
    """The reader processes' start method: a forkserver that preloads
    ``readers`` (and, as the default does, the main module), so each
    reader is forked from a clean single-threaded interpreter."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", readers_lib.__name__])
    return ctx


def train_batches(data_dir: str, split: str, cfg: DataConfig,
                  image_size: int, seed: int = 0, skip_batches: int = 0,
                  pin_memory: bool = False, readers: int = 1,
                  process_index: int = 0,
                  process_count: int = 1) -> Iterator[dict]:
    """Endless shuffled batches ``{'image': uint8 [B, S, S, 3], 'grade':
    int32 [B]}`` as CPU tensors, in pinned memory when ``pin_memory``, so
    ``.to(device, non_blocking=True)`` copies them without blocking the
    host. Under ``process_count`` P > 1 the process yields its ``B/P``
    rows of each one-process batch, the block ``[p B/P, (p + 1) B/P)``,
    and reads no other record: the P processes' batches, concatenated in
    process order, are the one-process stream's (the reference shards
    whole files instead; ROADMAP.md Queue C).

    ``readers`` reader processes read and decode whole batches ahead, in
    parallel, into a shared buffer of ``2 * readers`` batch slots; the
    batches still come out in the stream's order, and a reader's
    exception is raised where its batch would have been. Processes, not
    threads: the record checks and the decode are Python, and a thread
    doing them would take the interpreter lock from the step's thread
    thousands of times a batch. They start from a forkserver
    (``readers_lib``), so a script that trains needs the usual
    ``if __name__ == "__main__":`` guard. Closing the generator stops the
    readers and frees the buffer.

    The fault plan armed when the stream starts goes to every reader
    (``tfrecord.read`` fires there), and what a batch's reader counted
    (retries, the plan's calls and fires) is added to this process's
    registry and plan as the batch comes out. A plan armed or disarmed
    while the stream runs cannot reach the readers: the next batch
    raises."""
    if readers < 1:
        raise ValueError(f"readers={readers} must be >= 1")
    b = local_batch_size(cfg.batch_size, process_count, "data.batch_size")
    plan = faultinject.active_plan()
    order = readers_lib.TrainOrder(
        data_dir, split, cfg.batch_size, image_size, seed,
        rows=(process_index * b, (process_index + 1) * b))
    shape = order.shape()
    slots = 2 * readers
    shared = shared_memory.SharedMemory(
        create=True, size=readers_lib.slot_bytes(slots, shape))
    images, grades = (torch.from_numpy(a) for a in
                      readers_lib.slot_views(shared.buf, slots, shape))
    try:
        pool = concurrent.futures.ProcessPoolExecutor(
            readers, mp_context=_reader_context(),
            initializer=readers_lib.init,
            initargs=(order, shared.name, slots,
                      plan.spec() if plan is not None else None))
        try:
            pending = collections.deque(
                pool.submit(readers_lib.read_into, skip_batches + k, k)
                for k in range(slots))
            index = skip_batches + slots
            while True:
                slot, report = pending.popleft().result()
                if faultinject.active_plan() is not plan:
                    raise RuntimeError(
                        "the fault plan changed while the train stream ran; "
                        "its reader processes hold the plan armed when it "
                        "started: arm or disarm before the stream starts")
                if report is not None:
                    _absorb(report, plan)
                out = {"image": torch.empty(shape, dtype=torch.uint8,
                                            pin_memory=pin_memory),
                       "grade": torch.empty((b,), dtype=torch.int32,
                                            pin_memory=pin_memory)}
                out["image"].copy_(images[slot])
                out["grade"].copy_(grades[slot])
                # The slot is copied out: the batch ``slots`` ahead reuses
                # it.
                pending.append(pool.submit(readers_lib.read_into, index,
                                           slot))
                index += 1
                yield out
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    finally:
        # The views hold the buffer's memory: it closes only without them.
        del images, grades
        shared.close()
        shared.unlink()


def _absorb(report: dict, plan: "faultinject.FaultPlan | None") -> None:
    """A reader's ``read_into`` report into this process's registry and
    fault plan."""
    reg = obs_registry.default_registry()
    for name, n in report["retries"].items():
        reg.counter(name, help=(retry.RETRIES_HELP if name == "io.retries"
                                else retry.SITE_RETRIES_HELP)).inc(n)
    if report["faults"]:
        plan.absorb(report["faults"])


class PinnedRing:
    """Host arrays -> the card through a ring of pinned host buffers.

    ``put`` copies a batch's arrays into the next slot's pinned buffers
    and from there ``non_blocking`` to the card on a side stream,
    recording an event after the copy. A slot's buffers are refilled only
    after the event of the copy that last read them has completed, so a
    ring of any length is safe: a ring too short only makes ``put`` wait.
    ``grow`` lengthens the ring, never shortens it. The consumer reads a
    batch through ``wait_staged``. CUDA only: nothing touches the card
    before the first ``put``."""

    def __init__(self, device: "str | torch.device", slots: int):
        self._dev = torch.device(device)
        # (pinned host buffers by key, event of the copy that read them).
        self._slots: list = [None] * max(1, slots)
        self._count = 0
        self._side: "torch.cuda.Stream | None" = None

    def grow(self, slots: int) -> None:
        self._slots.extend([None] * (slots - len(self._slots)))

    def put(self, batch: dict) -> tuple:
        """-> (the batch's tensors on the card, its copy's event)."""
        slot = self._count % len(self._slots)
        self._count += 1
        held = self._slots[slot]
        host = held[0] if held is not None else {}
        if held is not None:
            held[1].synchronize()
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if k not in host or host[k].shape != v.shape or (
                    host[k].dtype != v.dtype):
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
            host[k].copy_(v)
        if self._side is None:
            self._side = torch.cuda.Stream(self._dev)
        with torch.cuda.stream(self._side):
            out = {k: host[k].to(self._dev, non_blocking=True)
                   for k in batch}
            event = torch.cuda.Event()
            event.record(self._side)
        self._slots[slot] = (host, event)
        return out, event


def wait_staged(out: dict, event, device: "str | torch.device") -> dict:
    """A staged batch made safe to read on the consumer's current stream:
    that stream waits on the copy's ``event`` (None: nothing to wait
    for), and the tensors, allocated on the side stream, are
    ``record_stream``ed to it."""
    if event is not None:
        current = torch.cuda.current_stream(torch.device(device))
        current.wait_event(event)
        for t in out.values():
            t.record_stream(current)
    return out


class DevicePrefetch:
    """Host batches -> device batches, ``size`` ahead of the consumer.

    A thread takes each batch from ``batches``, copies it into one of a
    ring of pinned host buffers (``size + 1`` of them) and issues the
    non-blocking copy to the card on a side stream, recording an event
    there; ``next()`` makes the consumer's current stream wait on that
    event, so the step never reads a batch before its copy is done. A
    buffer is refilled only after the event of the copy that last read it
    has completed: with ``size`` batches queued and one being filled, the
    buffer of the batch the consumer took ``size + 1`` batches ago is the
    one reused. On the CPU the "copy" is a clone and no buffer is kept.

    With ``knobs`` (``data/autotune.Knobs``) the depth is the live
    ``knobs.prefetch_depth``, read by the thread before each batch it
    stages: a raise lets it stage further ahead (the ring grows to the
    new depth + 1), a cut lets the queue drain to the new depth. Order
    and contents do not change.

    Batches come out in the stream's order. An exception raised by the
    stream (or in staging) is re-raised by the ``next()`` that reaches
    its place in the order, and by every later one; the end of the
    stream is a ``StopIteration`` there. ``close()`` stops the thread and
    closes the stream. ``size == 0`` runs no thread: ``next()`` reads the
    batch and copies it itself.
    """

    def __init__(self, batches: Iterable[dict],
                 device: "str | torch.device", size: int = 2,
                 knobs=None):
        if size < 0:
            raise ValueError(f"prefetch size {size} must be >= 0")
        self._it = iter(batches)
        self._dev = torch.device(device)
        self._knobs = knobs
        self._size = int(size) if knobs is None else self._depth()
        self._closed = False
        self._error: "BaseException | None" = None
        self._thread: "threading.Thread | None" = None
        self._g_depth = obs_registry.default_registry().gauge(
            "data.prefetch.depth",
            help="batches staged ahead of the one being yielded in "
                 "device_prefetch (the effective run-ahead config)")
        if self._size == 0:
            return
        self._cond = threading.Condition()
        self._ready: collections.deque = collections.deque()
        self._stop = False
        self._ring = PinnedRing(self._dev, self._size + 1)
        self._thread = threading.Thread(target=self._run,
                                        name="train-prefetch", daemon=True)
        self._thread.start()

    def _depth(self) -> int:
        if self._knobs is None:
            return self._size
        return max(1, self._knobs.prefetch_depth)

    def __iter__(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _stage(self, batch: dict) -> tuple:
        """(device batch, its copy's event or None)."""
        if self._dev.type != "cuda":
            return ({k: torch.as_tensor(v).to(self._dev, copy=True)
                     for k, v in batch.items()}, None)
        return self._ring.put(batch)

    def _put(self, item: tuple) -> None:
        with self._cond:
            self._ready.append(item)
            self._cond.notify_all()

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while (len(self._ready) >= self._depth()
                           and not self._stop):
                        self._cond.wait()
                    if self._stop:
                        return
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._put(("end", None))
                    return
                # A raised depth grows the ring.
                self._ring.grow(self._depth() + 1)
                staged = self._stage(batch)
                self._put(("batch", staged))
        except BaseException as e:  # noqa: BLE001 - re-raised in next()
            self._put(("error", e))
        finally:
            close = getattr(self._it, "close", None)
            if close is not None:
                close()

    def __next__(self) -> dict:
        if self._closed:
            raise RuntimeError("the train stream is closed")
        if self._thread is None:
            if self._error is not None:
                raise self._error
            try:
                batch = next(self._it)
            except StopIteration:
                raise
            except BaseException as e:
                self._error = e
                raise
            self._g_depth.set(0)
            return {k: torch.as_tensor(v).to(self._dev, non_blocking=True)
                    for k, v in batch.items()}
        with self._cond:
            while not self._ready:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "the train prefetch thread stopped without a batch")
                self._cond.wait(timeout=1.0)
            kind, item = self._ready[0]
            if kind == "batch":
                self._ready.popleft()
                self._g_depth.set(sum(k == "batch" for k, _ in self._ready))
                self._cond.notify_all()
        if kind == "error":
            raise item
        if kind == "end":
            raise StopIteration
        return wait_staged(*item, self._dev)

    def close(self) -> None:
        """Stop the thread (after the batch it is reading, if any) and
        close the stream; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is None:
            close = getattr(self._it, "close", None)
            if close is not None:
                close()
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()

