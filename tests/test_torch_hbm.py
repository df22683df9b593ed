"""The port's card-resident ``hbm`` loader (``data/hbm_pipeline.py``,
``data/threefry.py``) and eval cache (``trainer._eval_cache_for``,
``predict_split(cache=...)``) against the JAX package's on the CPU (raw
splits of 20 / 10 records at 32 px written by the JAX writer, batch 8):

- the threefry permutation bitwise ``jax.random.permutation``;
- ``train_batches`` bitwise the reference's over three epochs, from step
  0 and from a step past an epoch boundary, and the same telemetry;
- the budget functions, the 8 GB CPU fallback and the size gate's
  message equal to the reference's;
- ``_eval_cache_for`` admitting and refusing as the reference's does;
- a cached ``predict_split`` bitwise the streamed one, and a ``fit``
  under ``data.loader=hbm`` (one val read for all its evals) resumed
  bitwise the uninterrupted one;
- the records ``chip_smoke.py`` phase 18 (c) loads, bitwise the digests
  recorded from the reference's ``load_split_numpy``.

Tolerance 0 throughout: indices, pixels and the probabilities of the same
rows through the same forward."""

import dataclasses
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import hbm_pipeline as jax_hbm
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu_torch import configs, models, train_lib, trainer
from jama16_retina_tpu_torch.data import hbm_pipeline, pipeline, threefry
from jama16_retina_tpu_torch.models import init
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

SIZE = 32
BATCH = 8
N_TRAIN = 20
STEPS_PER_EPOCH = N_TRAIN // BATCH
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("splits"))
    for split, n, seed in (("train", N_TRAIN, 1), ("val", 10, 2)):
        jax_tfrecord.write_synthetic_split(root, split, n, SIZE, num_shards=3,
                                           seed=seed, encoding="raw")
    return root


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Fresh default registries in both packages, and the no-limit warning
    latches reset."""
    regs = obs_registry.Registry(), jax_registry.Registry()
    prev = (obs_registry.set_default_registry(regs[0]),
            jax_registry.set_default_registry(regs[1]))
    hbm_pipeline._WARNED_NO_BYTES_LIMIT = False
    jax_hbm._WARNED_NO_BYTES_LIMIT = False
    yield regs
    obs_registry.set_default_registry(prev[0])
    jax_registry.set_default_registry(prev[1])


def _data_cfgs(*items):
    base = ["model.image_size=32", f"data.batch_size={BATCH}",
            f"eval.batch_size={BATCH}", *items]
    return (configs.override(configs.get_config("smoke"), base),
            jax_configs.override(jax_configs.get_config("smoke"), base))


@pytest.mark.parametrize("n", [1, 7, 1626, 100_000])
@pytest.mark.parametrize("epoch", [0, 1, 7])
@pytest.mark.parametrize("seed", [0, 1, 42, 12345])
def test_threefry_permutation_is_jax(seed, epoch, n):
    """One round of sort keys up to n = 1625, two from 1626 on."""
    want = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.key(seed), epoch), n))
    got = threefry.epoch_permutation(seed, epoch, n)
    np.testing.assert_array_equal(got, want)


def test_threefry_split_and_bits_are_jax():
    k = jax.random.key(3)
    assert threefry.split(threefry.key(3), 3) == [
        tuple(int(v) for v in row)
        for row in np.asarray(jax.random.key_data(jax.random.split(k, 3)))]
    np.testing.assert_array_equal(
        threefry.random_bits(threefry.key(3), 9),
        np.asarray(jax.random.bits(k, (9,))))
    assert threefry.fold_in(threefry.key(5), 2) == tuple(
        int(v) for v in np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.key(5), 2))))


@pytest.mark.parametrize("skip", [0, STEPS_PER_EPOCH + 1])
def test_train_batches_are_the_reference(data_dir, skip,
                                         _fresh_registries):
    """Three epochs of batches from ``skip`` on, and the loader's
    telemetry, in both packages."""
    cfg, jcfg = _data_cfgs()
    steps = 3 * STEPS_PER_EPOCH - skip
    port = hbm_pipeline.train_batches(data_dir, "train", cfg.data, SIZE,
                                      seed=3, skip_batches=skip,
                                      device="cpu")
    ref = jax_hbm.train_batches(data_dir, "train", jcfg.data, SIZE, seed=3,
                                skip_batches=skip)
    for _ in range(steps):
        got, want = next(port), next(ref)
        assert got["image"].dtype == torch.uint8
        assert got["grade"].dtype == torch.int32
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        np.testing.assert_array_equal(got["grade"].numpy(),
                                      np.asarray(want["grade"]))
    port.close()
    ref.close()
    snaps = [r.snapshot() for r in _fresh_registries]
    for s in snaps:
        assert s["gauges"]["data.hbm.resident_rows"] == N_TRAIN
        assert s["counters"]["data.hbm.gather_batches"] == steps
        assert s["counters"]["data.decode.records"] == N_TRAIN
    timed = "data.decode.busy_s"
    assert ({k: v for k, v in snaps[0]["counters"].items() if k != timed}
            == {k: v for k, v in snaps[1]["counters"].items() if k != timed})
    assert snaps[0]["counters"][timed] > 0


def test_budget_functions_and_the_gate_are_the_reference(data_dir, caplog):
    """Both packages take the 8 GB fallback on the CPU (warned once), an
    override wins, and a split over the budget is refused with the same
    message."""
    for kw in ({}, {"max_fraction": 0.25}, {"budget_base_bytes": 10**9}):
        assert hbm_pipeline.hbm_budget_bytes(device="cpu", **kw) == \
            jax_hbm.hbm_budget_bytes(**kw)
    assert hbm_pipeline.hbm_budget_bytes(device="cpu") == int(
        0.6 * 8 * 1024**3)
    assert sum("no memory limit" in r.getMessage()
               for r in caplog.records) == 1
    for size in (32, 299):
        assert hbm_pipeline.row_bytes(size) == jax_hbm.row_bytes(size)
        assert hbm_pipeline.dataset_bytes(7, size) == jax_hbm.dataset_bytes(
            7, size)
        for kw in ({}, {"budget_bytes": 10**6}, {"n_devices": 4},
                   {"budget_base_bytes": 5 * 10**6}):
            assert hbm_pipeline.resident_row_capacity(
                size, device="cpu", **kw) == jax_hbm.resident_row_capacity(
                    size, **kw)
    for n, base in ((10, 0), (10**6, 0), (20, 10**4), (20, 10**6)):
        assert hbm_pipeline.fits_in_hbm(
            n, SIZE, budget_base_bytes=base, device="cpu") == \
            jax_hbm.fits_in_hbm(n, SIZE, budget_base_bytes=base)
    cfg, jcfg = _data_cfgs("data.hbm_budget_bytes=100000")
    errors = []
    for stream in (hbm_pipeline.train_batches(data_dir, "train", cfg.data,
                                              SIZE, device="cpu"),
                   jax_hbm.train_batches(data_dir, "train", jcfg.data,
                                         SIZE)):
        with pytest.raises(ValueError) as e:
            next(stream)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "exceeds the HBM-resident budget" in errors[0]


def test_mesh_is_refused_naming_its_item(data_dir):
    cfg, _ = _data_cfgs()
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        next(hbm_pipeline.train_batches(data_dir, "train", cfg.data, SIZE,
                                        mesh=object(), device="cpu"))


@pytest.mark.parametrize("loader,base,reserved", [
    ("tfdata", 0, 0), ("hbm", 0, 0), ("hbm", 10**5, 0),
    ("hbm", 4 * 10**5, 0), ("hbm", 4 * 10**5, 10**4)])
def test_eval_cache_admission_is_the_reference(data_dir, loader, base,
                                               reserved):
    """val at 32 px, batch 8: 16 padded rows, 49,152 bytes, against 10 %
    of 0.6 of the budget base, the caches already held counted."""
    cfg, jcfg = _data_cfgs(f"data.loader={loader}",
                           f"data.hbm_budget_bytes={base}")
    assert trainer._eval_cache_bytes(cfg, data_dir, "val") == \
        jax_trainer._eval_cache_bytes(jcfg, data_dir, "val") == 16 * 32 * 32 * 3
    got = trainer._eval_cache_for(cfg, data_dir, "val",
                                  reserved_bytes=reserved, device="cpu")
    want = jax_trainer._eval_cache_for(jcfg, data_dir, "val",
                                       reserved_bytes=reserved)
    assert got == want


def test_cached_predict_split_is_the_streamed_one(data_dir, monkeypatch):
    """The first call fills the cache (one read of the split), later
    calls read nothing and score the same rows: bitwise the streamed
    grades, names and probabilities, padding trimmed."""
    cfg, _ = _data_cfgs("data.loader=hbm")
    state = train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model), 0),
        torch.device("cpu"))
    step = train_lib.make_eval_step(cfg, state, "cpu")

    def fn(images):
        return step(images)[None]

    streamed = trainer.predict_split(cfg, fn, data_dir, "val")
    reads = []
    real = pipeline.eval_batches
    monkeypatch.setattr(pipeline, "eval_batches",
                        lambda *a: reads.append(a) or real(*a))
    cache = trainer._eval_cache_for(cfg, data_dir, "val", device="cpu")
    assert cache == []
    for _ in range(3):
        got = trainer.predict_split(cfg, fn, data_dir, "val", cache=cache,
                                    device="cpu")
        assert len(got[1][0]) == 10
        for g, w in zip(got, streamed):
            np.testing.assert_array_equal(g, w)
    assert len(reads) == 1 and len(cache) == 2
    assert all(c[0].dtype == torch.uint8 and c[0].shape[0] == BATCH
               for c in cache)


def _fit_cfg(steps, *items):
    cfg, _ = _data_cfgs("data.loader=hbm", f"train.steps={steps}",
                        "train.eval_every=2", "train.log_every=1", *items)
    return cfg


def test_hbm_fit_resumes_bitwise(data_dir, tmp_path, monkeypatch):
    """6 steps in one run against 3 then a resume to 6 (steps past the
    epoch boundaries at 2 and 4; a constant learning rate, so that the
    shorter run's schedule is the longer one's): the same eval records
    and bitwise checkpoints; each run reads val once for all its
    evals."""
    reads = []
    real = pipeline.eval_batches
    monkeypatch.setattr(pipeline, "eval_batches",
                        lambda *a: reads.append(a) or real(*a))
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    const = "train.lr_schedule=constant"
    trainer.fit(_fit_cfg(6, const), data_dir, full, device="cpu")
    assert len(reads) == 1
    trainer.fit(_fit_cfg(3, const), data_dir, cut, device="cpu")
    trainer.fit(_fit_cfg(6, const, "train.resume=true"), data_dir, cut,
                device="cpu")
    assert len(reads) == 3

    def evals(wd):
        return [(r["step"], r["val_auc"])
                for r in read_jsonl(os.path.join(wd, "metrics.jsonl"))
                if r["kind"] == "eval"]

    # The cut run also evaluates at its last step, 3.
    assert evals(full) == [e for e in evals(cut) if e[0] != 3]
    assert [k["kind"] for k in read_jsonl(os.path.join(cut, "metrics.jsonl"))
            ].count("resume") == 1
    a = ckpt_lib.Checkpointer(full).restore(6)
    b = ckpt_lib.Checkpointer(cut).restore(6)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ensemble_parallel_fit_reads_hbm_batches_and_caches_val(
        data_dir, tmp_path, monkeypatch):
    """The stacked ensemble fit takes the same loader dispatch and val cache:
    two members, 4 steps, evals at 2 and 4 from one read of val."""
    reads = []
    real = pipeline.eval_batches
    monkeypatch.setattr(pipeline, "eval_batches",
                        lambda *a: reads.append(a) or real(*a))
    cfg = dataclasses.replace(
        _fit_cfg(4), train=dataclasses.replace(
            _fit_cfg(4).train, ensemble_size=2, ensemble_parallel=True,
            ensemble_parallel_force=True))
    res = trainer.fit_ensemble(cfg, data_dir, str(tmp_path), device="cpu")
    assert [r["member"] for r in res] == [0, 1]
    assert len(reads) == 1
    recs = [r for r in read_jsonl(str(tmp_path / "metrics.jsonl"))
            if r["kind"] == "eval"]
    assert [r["step"] for r in recs] == [2, 4]


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_phase_18_jpeg_records_load_as_the_recorded_digests(tmp_path):
    """The JPEG records of ``chip_smoke.write_jpeg_splits`` (the 317-px
    ones resized by INTER_LINEAR) decode to the digests
    ``tests/make_torch_fixtures.py hbm`` recorded from the reference's
    ``load_split_numpy``, which chip_smoke holds the card machine's host
    to."""
    import chip_smoke

    with open(os.path.join(HERE, "data", "jpeg", "hbm_load.json")) as f:
        want = json.load(f)
    jdir, _ = chip_smoke.write_jpeg_splits(tmp_path)
    for split, entry in sorted(want.items()):
        images, grades = hbm_pipeline.load_split_numpy(
            str(jdir), split, entry["image_size"], workers=2)
        assert images.shape[0] == entry["n"]
        assert (_sha(images), _sha(grades)) == (entry["images"],
                                                entry["grades"]), split


def test_quarantine_in_the_hbm_loader_fires_the_alert(data_dir, tmp_path):
    """A corrupt read of record 4 at one decode thread: one
    ``decode_error``, record 5 resident in its place, and the
    ``data_quarantine`` rule (``obs.quarantine_alert_per_s``, no longer
    refused) firing at the next flush."""
    from jama16_retina_tpu_torch.obs import alerts as obs_alerts
    from jama16_retina_tpu_torch.obs import export as obs_export
    from jama16_retina_tpu_torch.obs import faultinject

    cfg, _ = _data_cfgs("data.loader=hbm", "data.decode_workers=1",
                        "obs.quarantine_alert_per_s=0.001")
    configs.check_supported(cfg, training=True)
    clean, _ = hbm_pipeline.load_split_numpy(data_dir, "train", SIZE)
    reg = obs_registry.default_registry()
    reg.counter("data.quarantined")  # rate() needs it in the first flush
    snap = obs_export.Snapshotter(workdir=str(tmp_path), every_s=0)
    snap.alerts = obs_alerts.manager_for(cfg, str(tmp_path))
    snap.flush()
    faultinject.arm({"tfrecord.read": {"kind": "corrupt", "on_calls": [5]}})
    try:
        images, _ = hbm_pipeline.load_split_numpy(data_dir, "train", SIZE,
                                                  workers=1)
    finally:
        faultinject.disarm()
    counters = reg.snapshot()["counters"]
    snap.close()
    assert counters["data.quarantined"] == 1
    assert counters["data.quarantined.decode_error"] == 1
    np.testing.assert_array_equal(images[4], clean[5])
    np.testing.assert_array_equal(np.delete(images, 4, 0),
                                  np.delete(clean, 4, 0))
    alerts = [r["reason"] for r in read_jsonl(str(tmp_path / "metrics.jsonl"))
              if r["kind"] == "alert" and r["state"] == "firing"]
    assert alerts == ["data_quarantine"]
