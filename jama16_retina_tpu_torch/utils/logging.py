"""Run metrics log of the port (counterpart of
``jama16_retina_tpu/utils/logging.py``, without absl).

One JSONL file per run, ``<workdir>/metrics.jsonl``: a line
``{"kind", "t", **fields}`` per event, flushed as it is written, with the
reference's kinds and keys (``config``, ``train``, ``eval``,
``early_stop``, ``resume``), so a port run's file diffs against a JAX
run's. The port runs one process, so there are no per-process mirrors.

``tensorboard=True`` mirrors the numeric fields of every record that has
a ``step`` (heartbeats aside) into ``<workdir>/tb`` as TensorBoard
scalars, tagged ``<kind>/<field>``, as the reference's ``tf.summary``
writer does. Neither TensorFlow nor the ``tensorboard`` package is
needed: the events file is written here, TFRecord framing with masked
CRC32C around ``Event`` protobufs encoded by hand, in the form TF's v2
writer gives a ``tf.summary.scalar`` (a float32 tensor under the
``scalars`` plugin).
"""

from __future__ import annotations

import itertools
import json
import logging
import numbers
import os
import socket
import struct
import threading
import time
from typing import IO

from jama16_retina_tpu_torch.data import tfrecord

_log = logging.getLogger(__name__)


# Suffix counter of events file names, as TF's writer numbers them.
_tb_files = itertools.count()


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    """One ``Event`` protobuf holding one scalar summary value."""
    _key, _len_field = tfrecord._key, tfrecord._len_field
    _varint_bytes = tfrecord._varint_bytes
    tensor = b"".join((
        _key(1, 0), _varint_bytes(1),           # dtype: DT_FLOAT
        _len_field(2, b""),                      # tensor_shape: scalar
        _len_field(4, struct.pack("<f", value)),  # tensor_content
    ))
    metadata = _len_field(1, _len_field(1, b"scalars"))  # plugin_data
    summary_value = b"".join((_len_field(1, tag.encode("utf-8")),
                              _len_field(8, tensor),
                              _len_field(9, metadata)))
    return b"".join((_key(1, 1), struct.pack("<d", wall_time),
                     _key(2, 0), _varint_bytes(step),
                     _len_field(5, _len_field(1, summary_value))))


class TensorBoardWriter:
    """An ``events.out.tfevents.*`` file of scalar summaries, one record
    each, flushed as written."""

    def __init__(self, logdir: str):
        _key, _len_field = tfrecord._key, tfrecord._len_field
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
                    f"{os.getpid()}.{next(_tb_files)}.v2")
        self._fh = open(self.path, "wb")
        header = b"".join((
            _key(1, 1), struct.pack("<d", float(int(now))),
            _len_field(3, b"brain.Event:2"),
            _len_field(10, _len_field(
                1, b"tensorflow.core.util.events_writer"))))
        self._fh.write(tfrecord.frame_record(header))
        self._fh.flush()

    def scalars(self, step: int, values: "dict[str, float]") -> None:
        now = time.time()
        for tag, v in values.items():
            self._fh.write(tfrecord.frame_record(
                _scalar_event(now, step, tag, v)))
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class RunLog:
    def __init__(self, workdir: str, name: str = "metrics.jsonl",
                 tensorboard: bool = False, fresh: bool = False):
        """``fresh``: a run that is not a resume rotates an existing file
        to ``<name>.prev`` instead of appending to it: the file is the
        resume-replay source for best/early-stop tracking, and a previous
        run's eval records would give a later resume of this run a best
        AUC it never reached."""
        os.makedirs(workdir, exist_ok=True)
        self._workdir = workdir
        self.path = os.path.join(workdir, name)
        self._fresh = fresh
        self._want_tb = tensorboard
        self._tb: "TensorBoardWriter | None" = None
        self._fh: "IO | None" = None
        # One writer at a time: interleaved write/flush pairs on one
        # handle can tear a line, which read_jsonl would then drop.
        self._write_lock = threading.Lock()

    def _ensure_open(self) -> None:
        if self._fh is not None:
            return
        if self._fresh and os.path.exists(self.path):
            os.replace(self.path, self.path + ".prev")
        # Rotated once: a write after close() (a background eval that
        # lands late) appends to this run's file.
        self._fresh = False
        self._fh = open(self.path, "a")
        if self._want_tb and self._tb is None:
            self._tb = TensorBoardWriter(os.path.join(self._workdir, "tb"))

    def write(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": round(time.time(), 3), **fields}
        line = json.dumps(rec) + "\n"
        with self._write_lock:
            self._ensure_open()
            self._fh.write(line)
            self._fh.flush()
            # Step-indexed series only: a heartbeat is a liveness record.
            if (self._tb is not None and fields.get("step") is not None
                    and kind != "heartbeat"):
                self._tb.scalars(int(fields["step"]), {
                    f"{kind}/{k}": float(v) for k, v in fields.items()
                    if k != "step" and isinstance(v, numbers.Real)})
        _log.info("%s %s", kind, fields)
        return rec

    def close(self) -> None:
        with self._write_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._tb is not None:
                # A late write after close mirrors nothing.
                self._tb.close()
                self._tb = None
                self._want_tb = False


def read_jsonl(path: str) -> "list[dict]":
    """Parse a JSONL file, skipping malformed lines with a warning: a run
    killed mid-flush leaves a torn last line, and resume replays this
    file, so a preempted run must stay resumable."""
    records = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                _log.warning("%s:%d: skipping malformed JSONL line (torn "
                             "write?)", path, i + 1)
    return records
