"""Checkpoints and member directories of the port (counterpart of
``jama16_retina_tpu/utils/checkpoint.py``).

Two formats live here:

- A **member dir** holds ``params.npz``: the flat Flax tree of the eval
  weights (``params/...`` and ``batch_stats/...`` keys, see
  ``models/convert.py``) as float32 arrays. Serving reads it, and
  ``scripts/export_torch_member.py`` writes it from a JAX checkpoint.
- A **checkpoint dir** (``Checkpointer``) holds a training run's states:
  ``best/<step>/`` keeps the top ``max_to_keep`` steps by val AUC,
  ``latest/<step>/`` exactly the newest step, for resume. Each step dir
  holds ``state.npz`` (a flat dict of numpy arrays, the whole train state;
  ``train_lib.state_to_flat`` defines it) and ``meta.json`` (``step``,
  ``val_auc``, ``has_ema``).

Every write goes to a temporary directory first and is renamed into
place, so a step dir is whole or absent; a leftover temporary directory
(a crash mid-write) is ignored on read. ``load_member`` reads either
format: a checkpoint dir gives the eval tree of its best step;
``load_donor`` gives a warm start its params, batch statistics and EMA
shadow apart. ``AsyncSaver`` runs save jobs on one background thread
(``train.async_save``).

``Checkpointer.save``/``save_latest`` pass the ``ckpt.save`` fault seam
before they write, and ``Checkpointer.restore`` reads through the
``ckpt.restore`` seam under a bounded retry (``utils/retry.py``); a
restore that cannot succeed raises ``CheckpointError`` naming the
directory and the step.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import shutil
import tempfile
import threading

import numpy as np

from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.utils import retry

PARAMS_FILE = "params.npz"
STATE_FILE = "state.npz"
META_FILE = "meta.json"
BEST_METRIC = "val_auc"
# Key prefix of the EMA shadow's params in a saved state.
EMA_PREFIX = "ema/"


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be restored, named by directory and step
    (the reference's): transient I/O that outlasted its retries, or a
    truncated or corrupted step dir. The original exception rides as
    ``__cause__``."""


def member_dir(checkpoint_dir: str, member: int) -> str:
    """One directory per ensemble member."""
    return os.path.join(checkpoint_dir, f"member_{member:02d}")


def discover_member_dirs(root: str) -> list[str]:
    """The ``member_NN`` subdirs of an ensemble root, else the root
    itself as a single model."""
    members = sorted(glob.glob(os.path.join(root, "member_*")))
    return members or [root]


def _write_npz(path: str, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def save_member(directory: str, flat: "dict[str, np.ndarray]") -> str:
    """Write ``flat`` to ``<directory>/params.npz`` atomically (a
    temporary file renamed into place); returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PARAMS_FILE)
    tmp = path + ".tmp"
    _write_npz(tmp, {k: np.asarray(v, np.float32) for k, v in flat.items()})
    os.replace(tmp, path)
    return path


def has_ema(flat: dict) -> bool:
    return any(k.startswith(EMA_PREFIX) for k in flat)


def eval_tree(flat: "dict[str, np.ndarray]") -> "dict[str, np.ndarray]":
    """The flat Flax tree eval scores with, from a saved state: the EMA
    shadow in place of the params when carried, and the batch
    statistics (what a member dir's ``params.npz`` holds)."""
    ema = has_ema(flat)
    out = {k: v for k, v in flat.items() if k.startswith("batch_stats/")}
    for k, v in flat.items():
        if ema and k.startswith(EMA_PREFIX):
            out["params/" + k[len(EMA_PREFIX):]] = v
        elif not ema and k.startswith("params/"):
            out[k] = v
    return out


def load_member(directory: str) -> "dict[str, np.ndarray]":
    """The eval tree of a member: ``params.npz`` of a member dir, else
    the best step (or, without one, the latest) of a checkpoint dir."""
    path = os.path.join(directory, PARAMS_FILE)
    if os.path.isfile(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if os.path.isdir(os.path.join(directory, "best")) or os.path.isdir(
            os.path.join(directory, "latest")):
        return eval_tree(Checkpointer(directory).restore())
    raise FileNotFoundError(
        f"no {PARAMS_FILE} and no checkpoints in {directory!r}; the port "
        "reads member dirs written by utils.checkpoint.save_member and "
        "checkpoint dirs written by trainer.fit")


def load_donor(directory: str
               ) -> "tuple[dict[str, np.ndarray], dict[str, np.ndarray] | None]":
    """A warm start's donor: (``params/...`` and ``batch_stats/...`` of
    its best step, the EMA shadow as ``params/...`` or None when the
    donor carried none). A member dir's ``params.npz`` has no shadow."""
    if os.path.isfile(os.path.join(directory, PARAMS_FILE)):
        return load_member(directory), None
    flat = Checkpointer(directory).restore()
    model = {k: v for k, v in flat.items()
             if k.startswith(("params/", "batch_stats/"))}
    ema = ({"params/" + k[len(EMA_PREFIX):]: v for k, v in flat.items()
            if k.startswith(EMA_PREFIX)} if has_ema(flat) else None)
    return model, ema


class AsyncSaver:
    """Background checkpoint writer (``train.async_save``; the
    reference's ``utils/checkpoint.AsyncSaver``).

    One worker thread runs the submitted jobs (zero-argument callables)
    strictly in submission order. A job's exception is latched and
    re-raised at the next ``submit()``, ``drain()`` or ``close()``, so a
    failed write stops the run one boundary late instead of vanishing
    with the thread. Once a run has a saver, every save goes through it
    (eval-time saves, their ``best/`` links, ``latest/`` and the
    emergency save), so no two writes to one checkpoint dir overlap."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: "BaseException | None" = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-async-saver")
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                job()
            except BaseException as e:  # noqa: BLE001 - latched, re-raised
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job) -> None:
        """Enqueue one job, after every job submitted before it; re-raise
        a prior job's latched failure first."""
        if self._closed:
            raise RuntimeError("AsyncSaver is closed")
        self._raise_pending()
        self._q.put(job)

    def drain(self) -> None:
        """Block until every submitted job has finished; re-raise any
        latched failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker and re-raise any latched failure."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._raise_pending()


class _StepDirs:
    """One directory of ``<step>/`` subdirs, each written atomically."""

    def __init__(self, directory: str):
        self.directory = directory

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> "list[int]":
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isfile(os.path.join(self.directory, d,
                                                      META_FILE)))

    def meta(self, step: int) -> "dict | None":
        try:
            with open(os.path.join(self.path(step), META_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def write(self, step: int, flat: dict, meta: dict) -> None:
        """Write one step: into a temporary directory, renamed into
        place."""

        def fill(tmp: str) -> None:
            _write_npz(os.path.join(tmp, STATE_FILE), flat)
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())

        self._put(step, fill)

    def link(self, step: int, source: str) -> None:
        """Add step ``step`` as hard links to the files of the step dir
        ``source`` (copies where the file system has no hard links): the
        bytes are written once for both directories."""

        def fill(tmp: str) -> None:
            for name in (STATE_FILE, META_FILE):
                src, dst = os.path.join(source, name), os.path.join(tmp, name)
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copyfile(src, dst)

        self._put(step, fill)

    def _put(self, step: int, fill) -> None:
        """``fill(tmp)`` writes the step's files into a temporary
        directory, which then replaces ``<step>/``."""
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            fill(tmp)
            final = self.path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def delete(self, step: int) -> None:
        shutil.rmtree(self.path(step), ignore_errors=True)

    def read(self, step: int) -> dict:
        with np.load(os.path.join(self.path(step), STATE_FILE)) as z:
            return {k: z[k] for k in z.files}


class Checkpointer:
    """Best-by-val-AUC retention plus an unconditional latest checkpoint.

    A best-only retention deletes a just-saved step when it is not among
    the top ``max_to_keep`` by val AUC, so a resume after a val-AUC
    plateau would roll back to an old best step. Two directories fix
    that: ``best/`` keeps the top-k by val AUC, ``latest/`` keeps exactly
    the newest step for resume (the reference's two managers).
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = directory
        self._max_to_keep = max_to_keep
        self._best = _StepDirs(os.path.join(directory, "best"))
        self._latest = _StepDirs(os.path.join(directory, "latest"))

    def _best_ranked(self) -> "list[tuple[float, int]]":
        """(val_auc, step) of best/, worst first; ties keep step order, so
        the earlier step goes first and the later one is best."""
        kept = []
        for s in self._best.steps():
            m = self._best.meta(s)
            if m is not None and m.get(BEST_METRIC) is not None:
                kept.append((float(m[BEST_METRIC]), s))
        return sorted(kept, key=lambda x: x[0])

    def _enters_best(self, metric: float) -> bool:
        kept = self._best_ranked()
        if len(kept) < self._max_to_keep:
            return True
        return metric > kept[0][0]

    @staticmethod
    def _meta(step: int, flat: dict, val_auc) -> dict:
        return {"step": int(step), BEST_METRIC: val_auc,
                "has_ema": has_ema(flat)}

    def save(self, step: int, flat: dict, metrics: dict) -> None:
        """``latest/`` is written every time; ``best/`` only when this
        step enters the top-k by val AUC (then the worst is dropped), as
        hard links to the files just written to ``latest/``."""
        faultinject.check("ckpt.save")
        metric = float(metrics[BEST_METRIC])
        self._write_latest(step, flat, self._meta(step, flat, metric))
        if self._enters_best(metric):
            self._best.link(step, self._latest.path(step))
            for _, s in self._best_ranked()[:-self._max_to_keep]:
                self._best.delete(s)

    def save_latest(self, step: int, flat: dict) -> bool:
        """A ``latest/``-only save (no val AUC to rank it by); False, and
        nothing written, when the step is already there."""
        faultinject.check("ckpt.save")
        if step in self._latest.steps():
            return False
        self._write_latest(step, flat, self._meta(step, flat, None))
        return True

    def _write_latest(self, step: int, flat: dict, meta: dict) -> None:
        self._latest.write(step, flat, meta)
        for s in self._latest.steps():
            if s != step:
                self._latest.delete(s)

    def _pick(self, step: "int | None") -> "tuple[_StepDirs, int]":
        if step is not None:
            dirs = (self._best if step in self._best.steps()
                    else self._latest)
            return dirs, step
        if self.best_step is not None:
            return self._best, self.best_step
        if self.latest_step is not None:
            return self._latest, self.latest_step
        raise FileNotFoundError(f"no checkpoints in {self.directory!r}")

    def restore(self, step: "int | None" = None) -> dict:
        """The flat state of ``step`` if given (from whichever directory
        has it), else of the best step, else of the latest. The read
        passes the ``ckpt.restore`` fault seam and is retried on
        ``OSError`` (3 attempts, ``io.retries.ckpt.restore``); any
        failure raises ``CheckpointError`` naming the directory and the
        step (the reference's ``Checkpointer._do_restore``)."""
        dirs, step = self._pick(step)
        if step not in dirs.steps():
            raise CheckpointError(
                f"no checkpoint at step {step} under {self.directory!r} "
                f"(available: {sorted(self.all_steps())})")

        def once() -> dict:
            faultinject.check("ckpt.restore")
            return dirs.read(step)

        try:
            return retry.retry_call(once, attempts=3, site="ckpt.restore")
        except OSError as e:
            raise CheckpointError(
                f"checkpoint restore failed with transient I/O errors "
                f"after retries: step {step} under {self.directory!r} "
                f"({type(e).__name__}: {e})") from e
        except Exception as e:
            raise self.unreadable(step, e) from e

    def unreadable(self, step: int, e: BaseException) -> CheckpointError:
        """The error of a step whose files do not restore: a truncated
        or corrupted step dir, or one missing a leaf."""
        return CheckpointError(
            f"checkpoint at step {step} under {self.directory!r} is "
            f"unreadable ({type(e).__name__}: {e}) — the directory is "
            "likely truncated/corrupted (torn copy, partial delete); "
            f"restore another step (available: {sorted(self.all_steps())}) "
            "or re-save the member")

    def saved_with_ema(self, step: "int | None" = None) -> "bool | None":
        """Whether the checkpoint (default: the one ``restore`` picks)
        carries an EMA shadow, from its ``meta.json``; None when that is
        unreadable."""
        dirs, step = self._pick(step)
        meta = dirs.meta(step)
        return None if meta is None else bool(meta.get("has_ema"))

    @property
    def best_step(self) -> "int | None":
        ranked = self._best_ranked()
        return ranked[-1][1] if ranked else None

    def best_info(self) -> "tuple[int, float] | None":
        """(step, val_auc) of the best retained checkpoint."""
        ranked = self._best_ranked()
        return (ranked[-1][1], ranked[-1][0]) if ranked else None

    @property
    def latest_step(self) -> "int | None":
        steps = self._latest.steps()
        return steps[-1] if steps else None

    def all_steps(self) -> "set[int]":
        return set(self._best.steps()) | set(self._latest.steps())

    def delete_newer_than(self, step: int) -> None:
        """Remove every checkpoint newer than ``step`` from both
        directories (a rollback to an older step must not leave the
        abandoned timeline's steps to win retention or resume)."""
        for dirs in (self._best, self._latest):
            for s in dirs.steps():
                if s > step:
                    dirs.delete(s)
