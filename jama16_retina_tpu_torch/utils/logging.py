"""Run metrics log of the port (counterpart of
``jama16_retina_tpu/utils/logging.py``, without absl and TensorBoard).

One JSONL file per run, ``<workdir>/metrics.jsonl``: a line
``{"kind", "t", **fields}`` per event, flushed as it is written, with the
reference's kinds and keys (``config``, ``train``, ``eval``,
``early_stop``, ``resume``), so a port run's file diffs against a JAX
run's. The port runs one process, so there are no per-process mirrors.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import IO

_log = logging.getLogger(__name__)


class RunLog:
    def __init__(self, workdir: str, name: str = "metrics.jsonl",
                 fresh: bool = False):
        """``fresh``: a run that is not a resume rotates an existing file
        to ``<name>.prev`` instead of appending to it: the file is the
        resume-replay source for best/early-stop tracking, and a previous
        run's eval records would give a later resume of this run a best
        AUC it never reached."""
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, name)
        self._fresh = fresh
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

    def write(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": round(time.time(), 3), **fields}
        line = json.dumps(rec) + "\n"
        with self._write_lock:
            self._ensure_open()
            self._fh.write(line)
            self._fh.flush()
        _log.info("%s %s", kind, fields)
        return rec

    def close(self) -> None:
        with self._write_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


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
