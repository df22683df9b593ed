"""The port's grain loader (``data/grain_index.py``,
``data/grain_pipeline.py``) and the trainer's worker-mode resume
(``trainer._GrainStateTee`` and the ``grain_state/<step>.json`` files)
against the ``grain`` package and the JAX package's grain loader on the
CPU (a raw train split of 22 records at 32 px and a val split of 8,
written by the JAX writer; batch 4):

- ``index_shuffle`` bitwise grain's compiled one: every permutation of
  ``[0, m]`` for m up to 300 by the digests recorded from grain in
  ``tests/data/grain_order.json``, spot positions of each live, powers
  of two +-1 up to 2**20 and splits near 100,000 at their first and last
  positions live; the sampler's repr and the shards' split as grain's;
- ``train_batches`` bitwise the reference's in-process (one process and
  both shards of two) and with 2 worker processes, across the epoch
  boundary, and the ``get_state()`` bytes equal to the reference's after
  every batch; a restored state continuing as the reference; the
  ``state_at_step`` bytes equal at P = 1 and 2;
- shards disjoint and covering the epoch;
- a port ``fit`` under ``data.loader=grain`` resumed bitwise the
  uninterrupted one at workers 0 and 2, and a worker-mode resume without
  its state file raising the reference's error.

Tolerance 0 throughout: record indices, pixels, state bytes and the
checkpoints of the same steps."""

import hashlib
import json
import os

import numpy as np
import pytest
from google.protobuf.message import DecodeError

from jama16_retina_tpu.configs import DataConfig as JaxDataConfig
from jama16_retina_tpu.data import grain_pipeline as jax_grain
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu_torch import configs, trainer
from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import grain_index, grain_pipeline
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

SIZE = 32
BATCH = 4
N_TRAIN = 22
SEED = 7
BATCHES = 12  # past the boundary of a 5.5-batch epoch
RESTORE_AT = 7
HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "data", "grain_order.json")) as _f:
    ORDER = json.load(_f)


def _grain_shuffle():
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module)

    return index_shuffle_module.index_shuffle


def _sha(a) -> str:
    return hashlib.sha256(bytes(a)).hexdigest()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
def test_index_shuffle_to_300_is_grain(seed):
    """Every permutation of [0, m], m = 0..300, end to end, against the
    digest recorded from grain; a few positions of each live."""
    perms = [grain_index.index_shuffle(np.arange(m + 1), m, seed)
             for m in range(301)]
    for m, perm in enumerate(perms):
        assert sorted(perm.tolist()) == list(range(m + 1)), m
    assert _sha(np.concatenate(perms).astype(np.int64)) == \
        ORDER["shuffle_0_300"][str(seed)]
    g = _grain_shuffle()
    for m in range(301):
        for i in {0, m}:
            assert perms[m][i] == g(i, max_index=m, seed=seed, rounds=4), m


@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
@pytest.mark.parametrize("kind", ["powers_of_two", "near_100000"])
def test_index_shuffle_at_large_sizes_is_grain(seed, kind):
    if kind == "powers_of_two":
        # Below 2**9 the sizes are in the range above.
        sizes = [m for k in range(9, 21) for m in (2**k - 1, 2**k, 2**k + 1)]
        edge = 100
    else:
        sizes = [99_990, 99_999, 100_002]
        edge = 1000
    g = _grain_shuffle()
    for m in sizes:
        idx = np.unique(np.r_[np.arange(min(edge, m + 1)),
                              np.arange(max(0, m + 1 - edge), m + 1)])
        got = grain_index.index_shuffle(idx, m, seed)
        want = [g(int(i), max_index=m, seed=seed, rounds=4) for i in idx]
        assert got.tolist() == want, m


def test_index_shuffle_rounds_and_epoch_order_are_grain():
    g = _grain_shuffle()
    for rounds in (6, 8):
        assert grain_index.index_shuffle(
            np.arange(301), 300, 42, rounds).tolist() == [
            g(i, max_index=300, seed=42, rounds=rounds) for i in range(301)]
    assert grain_index.index_shuffle(np.array([5]), 9, 42).tolist() == [
        g(5, max_index=9, seed=42, rounds=4)] == [5]
    assert grain_index.epoch_order(10, 42, 0).tolist() == \
        [8, 6, 7, 9, 0, 5, 1, 2, 4, 3]
    with pytest.raises(ValueError, match="rounds"):
        grain_index.index_shuffle(np.arange(3), 2, 0, rounds=3)


def test_sampler_and_shards_are_grain():
    """The sampler's repr (part of the state bytes), its record keys over
    two epochs of every shard, and ``even_split``, as grain's."""
    import grain.python as pygrain
    from grain._src.core import sharding

    for n, p_cnt in ((22, 1), (22, 2), (23, 3), (64, 1)):
        for p in range(p_cnt):
            for drop in (True, False):
                opts = grain_index.ShardOptions(p, p_cnt, drop)
                assert grain_index.even_split(n, opts) == \
                    sharding.even_split(n, pygrain.ShardOptions(p, p_cnt,
                                                                drop))
            ref = pygrain.IndexSampler(
                n, shard_options=pygrain.ShardOptions(p, p_cnt, True),
                shuffle=True, num_epochs=None, seed=SEED)
            ours = grain_index.IndexSampler(
                n, grain_index.ShardOptions(p, p_cnt, True), SEED)
            assert repr(ours) == repr(ref)
            pos = np.arange(p, 2 * n, p_cnt)
            assert ours.record_keys(pos).tolist() == \
                [ref[int(g)].record_key for g in pos]
    for seed in (0, 42):
        keys = grain_index.IndexSampler(
            64, grain_index.ShardOptions(0, 1, True), seed).record_keys(
            np.arange(128))
        assert _sha(keys.astype(np.int64)) == ORDER["order_2_epochs"][
            str(seed)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("splits"))
    for split, n, seed in (("train", N_TRAIN, 1), ("val", 8, 2)):
        jax_tfrecord.write_synthetic_split(root, split, n, SIZE, num_shards=3,
                                           seed=seed, encoding="raw")
    return root


def _pair(data_dir, workers, p=0, p_cnt=1):
    kw = dict(seed=SEED, process_index=p, process_count=p_cnt,
              worker_count=workers)
    return (jax_grain.make_train_iterator(
                data_dir, "train", JaxDataConfig(batch_size=BATCH), SIZE,
                **kw),
            grain_pipeline.make_train_iterator(
                data_dir, "train", DataConfig(batch_size=BATCH), SIZE, **kw))


@pytest.fixture(scope="module")
def reference_streams(data_dir):
    """The reference's batches and state bytes after each, per (workers,
    p, P): the worker-mode run starts the reference's worker processes
    once for the module."""
    out = {}
    for key in ((0, 0, 1), (0, 0, 2), (0, 1, 2), (2, 0, 1)):
        ref, _ = _pair(data_dir, *key)
        rows = []
        for _ in range(BATCHES):
            b = next(ref)
            rows.append((np.array(b["image"]), np.array(b["grade"]),
                         ref.get_state()))
        out[key] = rows
        del ref
    return out


@pytest.mark.parametrize("key", [(0, 0, 1), (0, 0, 2), (0, 1, 2), (2, 0, 1)],
                         ids=["w0", "w0-shard0of2", "w0-shard1of2", "w2"])
def test_train_batches_and_states_are_the_reference(data_dir,
                                                    reference_streams, key):
    _, port = _pair(data_dir, *key)
    first = port.get_state()
    try:
        for k, (image, grade, state) in enumerate(reference_streams[key]):
            b = next(port)
            np.testing.assert_array_equal(b["image"], image, err_msg=str(k))
            np.testing.assert_array_equal(b["grade"], grade, err_msg=str(k))
            assert b["image"].dtype == np.uint8 and b["grade"].dtype == \
                np.int32
            assert port.get_state() == state, k
    finally:
        port.close()
    ref, _ = _pair(data_dir, *key)
    assert first == ref.get_state()


@pytest.mark.parametrize("workers", [0, 2])
def test_restored_state_continues_as_the_reference(data_dir,
                                                   reference_streams,
                                                   workers):
    """A fresh iterator given the reference's state after batch 7 (past
    the epoch boundary) yields its batches 8.. with its states; under
    workers the restart is mid-round (worker 0 handed out last)."""
    rows = reference_streams[(workers, 0, 1)]
    _, port = _pair(data_dir, workers)
    try:
        port.set_state(rows[RESTORE_AT - 1][2])
        for image, _, state in rows[RESTORE_AT:]:
            np.testing.assert_array_equal(next(port)["image"], image)
            assert port.get_state() == state
    finally:
        port.close()


def test_set_state_is_checked_as_grain_checks_it(data_dir):
    ref, port = _pair(data_dir, 0)
    state = json.loads(ref.get_state().decode())
    for field, value in (("worker_count", 2), ("sampler", "IndexSampler()"),
                         ("data_source", "FundusSource(n=1, size=1)")):
        bad = json.dumps({**state, field: value}).encode()
        with pytest.raises(ValueError) as want:
            ref.set_state(bad)
        with pytest.raises(ValueError) as got:
            port.set_state(bad)
        assert str(got.value).splitlines()[0] == \
            str(want.value).splitlines()[0]


@pytest.mark.parametrize("p_cnt", [1, 2])
def test_state_at_step_is_the_reference(data_dir, p_cnt):
    for p in range(p_cnt):
        for step in (0, 1, 6):
            ref, port = _pair(data_dir, 0, p, p_cnt)
            want = jax_grain.state_at_step(ref, step, BATCH // p_cnt, p,
                                           p_cnt)
            assert grain_pipeline.state_at_step(
                port, step, BATCH // p_cnt, p, p_cnt) == want
    resumed = grain_pipeline.train_batches(
        data_dir, "train", DataConfig(batch_size=BATCH), SIZE, seed=SEED,
        skip_batches=RESTORE_AT)
    ref, _ = _pair(data_dir, 0)
    for _ in range(RESTORE_AT):
        next(ref)
    for _ in range(3):
        np.testing.assert_array_equal(next(resumed)["image"],
                                      next(ref)["image"])
    ref, port = _pair(data_dir, 2)
    with pytest.raises(NotImplementedError) as want:
        jax_grain.state_at_step(ref, 3, BATCH)
    with pytest.raises(NotImplementedError) as got:
        grain_pipeline.state_at_step(port, 3, BATCH)
    assert str(got.value) == str(want.value)


def test_shards_are_disjoint_and_cover_the_epoch(data_dir):
    """One epoch of each of 2 shards (11 records, local batch 2): no
    record twice, all 22 together, and the same as the reference's."""
    seen = []
    for p in range(2):
        _, port = _pair(data_dir, 0, p, 2)
        seen += [next(port)["image"] for _ in range(N_TRAIN // 2 // 2)]
        ref, _ = _pair(data_dir, 0, p, 2)
        np.testing.assert_array_equal(
            np.concatenate(seen[-5:]),
            np.concatenate([next(ref)["image"] for _ in range(5)]))
    rows = np.concatenate(seen)
    assert len(rows) == 20 and len({r.tobytes() for r in rows}) == 20
    keys = np.concatenate([grain_index.IndexSampler(
        N_TRAIN, grain_index.ShardOptions(p, 2, True), SEED).record_keys(
            np.arange(p, N_TRAIN, 2)) for p in range(2)])
    assert sorted(keys.tolist()) == list(range(N_TRAIN))


def _fit_cfg(steps, workers, *items):
    return configs.override(configs.get_config("smoke"), [
        f"model.image_size={SIZE}", f"data.batch_size={BATCH}",
        f"eval.batch_size={BATCH}", "data.loader=grain",
        f"data.grain_workers={workers}", f"train.steps={steps}",
        "train.eval_every=3", "train.log_every=1",
        "train.lr_schedule=constant", *items])


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_fit_resumes_bitwise(data_dir, tmp_path, workers):
    """6 steps in one run against 3 then a resume to 6 (past the epoch
    boundary): the same losses and eval records and bitwise step-6
    checkpoints; with workers the resume reads ``grain_state/3.json``,
    whose bytes are the uninterrupted run's state after batch 3."""
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    trainer.fit(_fit_cfg(6, workers), data_dir, full, device="cpu")
    trainer.fit(_fit_cfg(3, workers), data_dir, cut, device="cpu")
    state = os.path.join(cut, "grain_state", "3.json")
    assert os.path.exists(state) == (workers > 0)
    if workers:
        with open(state, "rb") as f:
            saved = f.read()
        with open(os.path.join(full, "grain_state", "3.json"), "rb") as f:
            assert f.read() == saved
        it = grain_pipeline.make_train_iterator(
            data_dir, "train", DataConfig(batch_size=BATCH), SIZE, seed=0,
            worker_count=workers)
        for _ in range(3):
            next(it)
        assert it.get_state() == saved
        it.close()
    trainer.fit(_fit_cfg(6, workers, "train.resume=true"), data_dir, cut,
                device="cpu")

    def records(wd, kind, key):
        return [(r["step"], r[key])
                for r in read_jsonl(os.path.join(wd, "metrics.jsonl"))
                if r["kind"] == kind]

    assert records(full, "train", "loss") == records(cut, "train", "loss")
    assert records(full, "eval", "val_auc") == records(cut, "eval",
                                                       "val_auc")
    a = ckpt_lib.Checkpointer(full).restore(6)
    b = ckpt_lib.Checkpointer(cut).restore(6)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_grain_worker_resume_without_state_file_fails_loudly(data_dir,
                                                             tmp_path):
    """An in-process run writes no state files; resuming it with workers
    raises the reference's ``NotImplementedError``, naming
    ``grain_state``."""
    wd = str(tmp_path / "legacy")
    trainer.fit(_fit_cfg(3, 0), data_dir, wd, device="cpu")
    assert not os.path.exists(os.path.join(wd, "grain_state"))
    with pytest.raises(NotImplementedError, match="grain_state") as got:
        trainer.fit(_fit_cfg(6, 2, "train.resume=true"), data_dir, wd,
                    device="cpu")
    ref, _ = _pair(data_dir, 2)
    with pytest.raises(NotImplementedError) as want:
        jax_grain.state_at_step(ref, 3, BATCH)
    assert str(got.value) == str(want.value)


def test_grain_state_pruning_keeps_live_and_newer_steps(tmp_path):
    """The persisted states follow retention: a step whose checkpoint is
    gone loses its state, the saved step and anything newer than the
    newest listed step stay; the torn-save rollback drops newer ones."""
    d = tmp_path / "grain_state"
    d.mkdir()
    for s in (2, 4, 6, 8, 10):
        (d / f"{s}.json").write_bytes(b"{}")
    (d / "notes.txt").write_bytes(b"")

    class Tee:
        _n, _keep = 12, 16

        def state_after(self, step):
            return b'{"step": %d}' % step

    trainer._persist_grain_state(Tee(), str(tmp_path), 12,
                                 kept_steps={4, 8})
    assert sorted(os.listdir(d)) == ["10.json", "12.json", "4.json",
                                     "8.json", "notes.txt"]
    assert (d / "12.json").read_bytes() == b'{"step": 12}'
    trainer._prune_grain_state(str(tmp_path), {4})
    assert sorted(os.listdir(d)) == ["4.json", "notes.txt"]


@pytest.mark.parametrize("workers", [0, 2])
def test_decode_errors_propagate(tmp_path, workers):
    """Grain has no quarantine: a record that fails to parse raises where
    its batch would come out, in process and from a worker (the port's
    parser's ``ValueError``; the reference's protobuf ``DecodeError``)."""
    root = str(tmp_path)
    jax_tfrecord.write_synthetic_split(root, "train", 8, 16, num_shards=1,
                                       seed=1, encoding="raw")
    path = jax_tfrecord.list_split(root, "train")[0]
    with open(path, "r+b") as f:
        f.seek(12)
        f.write(b"\xff" * 64)  # the first record's payload, length kept
    port = grain_pipeline.make_train_iterator(
        root, "train", DataConfig(batch_size=4), 16, seed=SEED,
        worker_count=workers)
    try:
        with pytest.raises(ValueError, match="tf.train.Example"):
            for _ in range(2):
                next(port)
    finally:
        port.close()
    ref = jax_grain.make_train_iterator(
        root, "train", JaxDataConfig(batch_size=4), 16, seed=SEED)
    with pytest.raises(DecodeError):
        for _ in range(2):
            next(ref)
