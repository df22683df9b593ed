"""The port's raw-shard transcode and loader (``data/rawshard.py``,
``python -m jama16_retina_tpu_torch.transcode_shards``) against the JAX
package's on the CPU (a JPEG split of 48 records at 32 px written by the
JAX writer, shards of 16 records, batch 8):

- the ``.npy`` shard files byte-identical to JAX ``transcode_split``'s,
  and the manifests equal once the seal's ``env`` is taken out;
- each package reading the other's shards;
- a resume from durable shards (a torn pair rebuilt, the rest reused);
- the refusals, the reference's messages with the port's command;
- a corrupt shard substituted as the reference substitutes it;
- the loader's batches bitwise the reference's at partial residency;
- the CLI's JSON lines, and a ``fit`` from ``rawshard`` whose metrics
  equal a ``fit`` from ``tiered``.

Tolerance 0 throughout: file bytes, pixels, grades, counts, losses and
AUCs are compared for equality."""

import contextlib
import glob
import io
import json
import os
import shutil

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu.data import rawshard as jax_rawshard
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu_torch import configs, trainer, transcode_shards
from jama16_retina_tpu_torch.data import hbm_pipeline, rawshard
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

SIZE = 32
N = 48
SHARD = 16
ROW = hbm_pipeline.row_bytes(SIZE)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rawshard"))
    jax_tfrecord.write_synthetic_split(root, "train", N, SIZE, num_shards=3,
                                       seed=1, encoding="jpeg")
    jax_tfrecord.write_synthetic_split(root, "val", 16, SIZE, num_shards=2,
                                       seed=2, encoding="raw")
    return root


@pytest.fixture(scope="module")
def shard_dirs(data_dir, tmp_path_factory):
    """(the port's shards, the reference's) of the train split."""
    out = tmp_path_factory.mktemp("shards")
    port, ref = str(out / "port"), str(out / "ref")
    rawshard.transcode_split(data_dir, "train", out_dir=port,
                             image_size=SIZE, shard_records=SHARD, workers=2)
    jax_rawshard.transcode_split(data_dir, "train", out_dir=ref,
                                 image_size=SIZE, shard_records=SHARD,
                                 workers=2)
    return port, ref


def _manifest(d: str) -> dict:
    with open(rawshard.manifest_path(d, "train")) as f:
        m = json.load(f)
    del m["__seal__"]["env"]
    return m


def test_shards_and_manifest_are_the_references(shard_dirs):
    port, ref = shard_dirs
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ref, "*")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(port, "*")))
    assert len([n for n in names if n.endswith(".npy")]) == 2 * (N // SHARD)
    for name in names:
        if name.endswith(".npy"):
            with open(os.path.join(port, name), "rb") as a, \
                    open(os.path.join(ref, name), "rb") as b:
                assert a.read() == b.read(), name
    assert _manifest(port) == _manifest(ref)
    assert _manifest(port)["__seal__"]["schema"] == "rawshard.manifest"


def test_each_package_reads_the_others_shards(data_dir, shard_dirs):
    port, ref = shard_dirs
    splits = (rawshard.RawShardSplit(ref, "train", image_size=SIZE,
                                     source_dir=data_dir),
              jax_rawshard.RawShardSplit(port, "train", image_size=SIZE,
                                         source_dir=data_dir))
    dec = rawshard.RawShardDecoder(splits[0], workers=2,
                                   registry=obs_registry.Registry())
    jdec = jax_rawshard.RawShardDecoder(splits[1], workers=2,
                                        registry=jax_registry.Registry())
    for a, b in zip(dec.decode_range(0, N), jdec.decode_range(0, N)):
        np.testing.assert_array_equal(a, b)
    for i in (0, SHARD - 1, SHARD, N - 1):
        got, want = splits[0].row(i), splits[1].row(i)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["grade"] == want["grade"]
    dec.close()
    jdec.close()


def test_transcode_resumes_from_durable_shards(data_dir, shard_dirs,
                                               tmp_path):
    """A torn last shard (its images file gone, the manifest trimmed to
    the durable prefix) and a first shard grown by a byte: both pairs are
    rebuilt, the rest reused, and the files are the reference's again."""
    out = str(tmp_path / "resume")
    shutil.copytree(shard_dirs[0], out)
    names = sorted(glob.glob(os.path.join(out, "*.npy")))
    mtimes = {p: os.stat(p).st_mtime_ns for p in names}
    with open(rawshard.manifest_path(out, "train")) as f:
        m = json.load(f)
    victim = m["shards"].pop()
    os.unlink(os.path.join(out, victim["images"]))
    with open(rawshard.manifest_path(out, "train"), "w") as f:
        json.dump(m, f)
    grown = os.path.join(out, m["shards"][0]["images"])
    with open(grown, "ab") as f:
        f.write(b"x")
    rawshard.transcode_split(data_dir, "train", out_dir=out,
                             image_size=SIZE, shard_records=SHARD)
    rebuilt = {victim["images"], victim["grades"],
               m["shards"][0]["images"], m["shards"][0]["grades"]}
    for p in names:
        if os.path.basename(p) not in rebuilt:
            assert os.stat(p).st_mtime_ns == mtimes[p], p
    for p in glob.glob(os.path.join(shard_dirs[1], "*.npy")):
        with open(p, "rb") as a, open(
                os.path.join(out, os.path.basename(p)), "rb") as b:
            assert a.read() == b.read(), p
    assert _manifest(out) == _manifest(shard_dirs[1])


def _refusal(lib, *args, **kw) -> "tuple[type, str]":
    with pytest.raises((ValueError, FileNotFoundError)) as e:
        lib.RawShardSplit(*args, **kw)
    return type(e.value), str(e.value)


def test_refusals_are_the_references_with_the_port_command(
        data_dir, shard_dirs, tmp_path):
    """Missing, wrong format, incomplete, wrong size, stale source: the
    reference's error type and message, the transcode command the
    port's."""
    port = shard_dirs[0]

    def as_port(msg: str) -> str:
        return msg.replace("python scripts/transcode_shards.py",
                           rawshard.TRANSCODE_CMD).replace(
            "scripts/transcode_shards.py", rawshard.TRANSCODE_CMD)

    stale = str(tmp_path / "stale")
    jax_tfrecord.write_synthetic_split(stale, "train", N, SIZE, num_shards=3,
                                       seed=9, encoding="jpeg")
    cases = [((str(tmp_path / "none"), "train"), {"image_size": SIZE}),
             ((port, "train"), {"image_size": 64}),
             ((port, "train"), {"image_size": SIZE, "source_dir": stale})]
    for bad_key, bad in (("format", "other"), ("num_records", N + 1)):
        d = str(tmp_path / f"bad_{bad_key}")
        shutil.copytree(port, d)
        with open(rawshard.manifest_path(d, "train")) as f:
            m = json.load(f)
        m[bad_key] = bad
        del m["__seal__"]  # an unsealed manifest loads; its values decide
        with open(rawshard.manifest_path(d, "train"), "w") as f:
            json.dump(m, f)
        cases.append(((d, "train"), {"image_size": SIZE}))
    for args, kw in cases:
        got = _refusal(rawshard, *args, **kw)
        want = _refusal(jax_rawshard, *args, **kw)
        assert got == (want[0], as_port(want[1]))
        assert "jama16_retina_tpu_torch.transcode_shards" in got[1]
    rawshard.RawShardSplit(port, "train", image_size=SIZE,
                           source_dir=str(tmp_path / "gone"))


def test_corrupt_shard_is_substituted_as_the_reference(shard_dirs,
                                                       tmp_path):
    """A shard whose header claims another shape at the same size: its
    rows are quarantined and each replaced by the next readable record,
    in both packages alike; without the quarantine the read raises."""
    out = str(tmp_path / "torn")
    shutil.copytree(shard_dirs[0], out)
    e = _manifest(out)["shards"][1]
    p = os.path.join(out, e["images"])
    with open(p, "rb") as f:
        raw = f.read()
    # The header's padding keeps its length.
    torn = raw.replace(b"(16, 32, 32, 3), }", b"(8, 64, 32, 3), } ")
    assert torn != raw and len(torn) == len(raw)
    with open(p, "wb") as f:
        f.write(torn)
    got = []
    for lib, reg in ((rawshard, obs_registry.Registry()),
                     (jax_rawshard, jax_registry.Registry())):
        dec = lib.RawShardDecoder(lib.RawShardSplit(out, "train",
                                                    image_size=SIZE),
                                  workers=1, registry=reg)
        got.append((dec.decode_batch(range(SHARD - 2, 2 * SHARD + 2)),
                    reg.snapshot()["counters"]))
        dec.close()
    (batch, counts), (want, want_counts) = got
    for k in ("image", "grade"):
        np.testing.assert_array_equal(batch[k], want[k])
    assert counts["data.quarantined.decode_error"] == \
        want_counts["data.quarantined.decode_error"] == SHARD
    assert counts["data.quarantined"] == want_counts["data.quarantined"]
    healthy = rawshard.RawShardSplit(shard_dirs[0], "train")
    np.testing.assert_array_equal(batch["image"][2],
                                  healthy.row(2 * SHARD)["image"])
    strict = rawshard.RawShardDecoder(
        rawshard.RawShardSplit(out, "train", image_size=SIZE), workers=1,
        registry=obs_registry.Registry(), quarantine=False)
    with pytest.raises(ValueError, match="shape"):
        strict.decode_batch([SHARD])
    strict.close()


def test_rawshard_batches_are_the_references(data_dir, shard_dirs):
    """Partial residency (20 rows), from a skip past the first epoch
    boundary: the port's loader over the reference's shards and the
    reference's loader over the port's, the same batches."""
    items = ["model.image_size=32", "data.batch_size=8",
             f"data.tiered_resident_bytes={20 * ROW}",
             "data.decode_workers=2"]
    cfg = configs.override(configs.get_config("smoke"), items + [
        f"data.rawshard_dir={shard_dirs[1]}"])
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), items + [
        f"data.rawshard_dir={shard_dirs[0]}"])
    port = rawshard.train_batches(data_dir, "train", cfg.data, SIZE, seed=2,
                                  skip_batches=5, device="cpu")
    ref = jax_rawshard.train_batches(data_dir, "train", jcfg.data, SIZE,
                                     seed=2, skip_batches=5)
    for _ in range(8):
        got, want = next(port), next(ref)
        for k in ("image", "grade"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    port.close()
    ref.close()


def test_cli_prints_the_references_json_lines(data_dir, tmp_path):
    """The same flags and one JSON line per split; a second run reuses
    every shard and prints the same lines."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_transcode_shards",
        os.path.join(REPO, "scripts", "transcode_shards.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    lines = []
    for main, out in ((transcode_shards.main, "port"), (jax_cli.main, "ref"),
                      (transcode_shards.main, "port")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--data_dir", data_dir, "--splits", "train,val",
                       "--out_dir", str(tmp_path / out), "--image_size",
                       "32", "--shard_records", "16"])
        assert rc == 0
        lines.append(buf.getvalue().replace(str(tmp_path / out), "OUT"))
    assert lines[0] == lines[1] == lines[2]
    assert [json.loads(x)["num_shards"] for x in lines[0].splitlines()] == \
        [3, 1]


def test_rawshard_fit_equals_the_tiered_fit(data_dir, tmp_path):
    """6 steps at partial residency (18 rows), evals at 3 and 6 from the
    val cache: the same losses and AUCs from either loader."""
    rawshard.transcode_split(data_dir, "train", image_size=SIZE,
                             shard_records=SHARD)
    common = ["model.image_size=32", "data.batch_size=8",
              "eval.batch_size=8", "train.steps=6", "train.eval_every=3",
              "train.log_every=2", "train.lr_schedule=constant",
              f"data.tiered_resident_bytes={18 * ROW}"]

    def run(loader):
        cfg = configs.override(configs.get_config("smoke"),
                               [f"data.loader={loader}", *common])
        configs.check_supported(cfg, training=True)
        wd = str(tmp_path / loader)
        trainer.fit(cfg, data_dir, wd, seed=6, device="cpu")
        recs = read_jsonl(os.path.join(wd, "metrics.jsonl"))
        return ({r["step"]: r["loss"] for r in recs if r["kind"] == "train"},
                {r["step"]: r["val_auc"] for r in recs
                 if r["kind"] == "eval"})

    tiered = run("tiered")
    assert sorted(tiered[0]) == [2, 4, 6] and sorted(tiered[1]) == [3, 6]
    assert run("rawshard") == tiered
