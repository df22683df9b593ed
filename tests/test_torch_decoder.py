"""The port's record index, one-record decode and parallel decoder with
its poison quarantine (``data/grain_pipeline.py``) against the JAX
package's on the CPU, on shards written by the JAX writer (raw and JPEG,
32-48 px), and ``preprocess/imgproc.resize_linear`` against OpenCV's
INTER_LINEAR. Every comparison is bitwise (tolerance 0): the pixels are
integers and the counts are counts.

The poison drills arm the ``tfrecord.read`` fault plan of each package
in turn, at one decode thread (call ordinals are deterministic only
there), and compare the substitute rows and the ``data.quarantined``
counters."""

import os
import pickle

import cv2
import numpy as np
import pytest

from jama16_retina_tpu.data import grain_pipeline as jax_grain
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.obs import faultinject as jax_fi
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu_torch.data import grain_pipeline, tfrecord
from jama16_retina_tpu_torch.obs import faultinject as fi
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.preprocess import imgproc
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

SIZE = 32
N = 12
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
# (module, faultinject, registry module) of each package.
PKGS = {"port": (grain_pipeline, fi, obs_registry),
        "jax": (jax_grain, jax_fi, jax_registry)}
QUARANTINE = ("data.quarantined", "data.quarantined.decode_error",
              "data.quarantined.read_error")


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    fi.disarm()
    jax_fi.disarm()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Raw records at 32 and 48 px, JPEG records at 32 px, and a split of
    the committed EXIF-rotated photo and a 299-px render as JPEG records,
    each in 3 shards."""
    root = tmp_path_factory.mktemp("records")
    out = {}
    for name, size, enc in (("raw32", SIZE, "raw"), ("raw48", 48, "raw"),
                            ("jpeg32", SIZE, "jpeg")):
        d = str(root / name)
        jax_tfrecord.write_synthetic_split(d, "train", N, size, num_shards=3,
                                           seed=4, encoding=enc)
        out[name] = d
    d = str(root / "photos")
    blobs = [open(os.path.join(FIXTURES, f), "rb").read()
             for f in ("exif6.jpg", "fundus299_0.jpg", "small_420.jpg")]
    tfrecord.write_example_shards(
        (tfrecord.make_jpeg_example(b, i % 5, f"p{i}")
         for i, b in enumerate(blobs)), d, "train", 3)
    out["photos"] = d
    return out


def _index(pkg, d):
    return PKGS[pkg][0].TFRecordIndex(tfrecord.list_split(d, "train"))


@pytest.mark.parametrize("name", ["raw32", "jpeg32", "photos"])
def test_index_extents_and_reads_equal_the_reference(shards, name):
    port, ref = _index("port", shards[name]), _index("jax", shards[name])
    assert len(port) == len(ref)
    assert port._extents == ref._extents
    assert all(port.read(i) == ref.read(i) for i in range(len(ref)))
    port2 = pickle.loads(pickle.dumps(port))
    assert port2.read(len(ref) - 1) == ref.read(len(ref) - 1)


@pytest.mark.parametrize("name,size", [
    ("raw32", SIZE), ("raw32", 24), ("raw48", SIZE), ("jpeg32", SIZE),
    ("jpeg32", 45), ("photos", 64), ("photos", 299)])
def test_decode_example_is_the_reference(shards, name, size):
    """Raw and JPEG records, at their stored size and resized (OpenCV's
    INTER_LINEAR), the EXIF orientation applied as ``cv2.imdecode``
    applies it."""
    index = _index("port", shards[name])
    for i in range(len(index)):
        payload = index.read(i)
        got = grain_pipeline._decode_example(payload, size)
        want = jax_grain._decode_example(payload, size)
        assert got["image"].shape == (size, size, 3)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["grade"] == want["grade"]
        assert got["grade"].dtype == want["grade"].dtype


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_decoder_is_the_reference(shards, workers):
    for name in ("raw48", "jpeg32"):
        decs = {pkg: PKGS[pkg][0].ParallelDecoder(
            _index(pkg, shards[name]), SIZE, workers=workers,
            registry=PKGS[pkg][2].Registry()) for pkg in PKGS}
        try:
            got, want_range = (decs[p].decode_range(0, N)
                               for p in ("port", "jax"))
            for g, w in zip(got, want_range):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
            wrapped = [decs[p].decode_range(N - 2, N + 5, n=N)
                       for p in ("port", "jax")]
            for g, w in zip(*wrapped):
                np.testing.assert_array_equal(g, w)
            ids = [5, 0, 11, 5, 3]
            got, want = (decs[p].decode_batch(ids) for p in ("port", "jax"))
            for k in ("image", "grade"):
                np.testing.assert_array_equal(got[k], want[k])
            assert decs["port"]._registry.snapshot()["counters"][
                "data.decode.records"] == N + 7 + len(ids)
            # Resized between calls, the pool gives the same rows.
            decs["port"].set_workers(4 - workers)
            assert decs["port"]._registry.snapshot()["gauges"][
                "data.decode.workers"] == 4 - workers
            for g, w in zip(decs["port"].decode_range(0, N), want_range):
                np.testing.assert_array_equal(g, w)
        finally:
            for d in decs.values():
                d.close()


def _drill(pkg, d, plan, quarantine=True):
    """(images, grades, counters) of one decode of the split under
    ``plan``, at one thread, with a fresh default registry (the retry
    counters go there)."""
    mod, faults, regmod = PKGS[pkg]
    reg = regmod.Registry()
    prev = regmod.set_default_registry(reg)
    faults.arm(plan)
    try:
        dec = mod.ParallelDecoder(_index(pkg, d), SIZE, workers=1,
                                  registry=reg, quarantine=quarantine)
        images, grades = dec.decode_range(0, N)
    finally:
        faults.disarm()
        regmod.set_default_registry(prev)
    counters = reg.snapshot()["counters"]
    return images, grades, {k: counters.get(k, 0) for k in (
        *QUARANTINE, "io.retries.tfrecord.read")}


PLANS = {
    "corrupt": {"tfrecord.read": {"kind": "corrupt", "on_calls": [4]}},
    "truncate": {"tfrecord.read": {"kind": "truncate", "on_calls": [7]}},
    "read_error": {"tfrecord.read": {"kind": "error", "error": "OSError",
                                     "on_calls": [3, 4, 5, 6]}},
    "bitflip": {"tfrecord.read": {"kind": "bitflip", "on_calls": [2]}},
    "last_record": {"tfrecord.read": {"kind": "corrupt",
                                      "on_calls": [N]}},
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("name", ["raw32", "jpeg32"])
def test_poison_quarantine_is_the_reference(shards, plan, name):
    """The same substitute rows and the same counts in both packages: a
    payload that fails to parse or decode is a ``decode_error``, a read
    that fails all 4 attempts a ``read_error``; the last record's
    substitute wraps to record 0. One flipped bit mid-payload is a pixel
    of a raw record, kept as damaged (no CRC check), as the reference
    keeps it."""
    got = _drill("port", shards[name], PLANS[plan])
    want = _drill("jax", shards[name], PLANS[plan])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    clean = _drill("port", shards[name], {})
    if plan == "read_error":
        assert got[2]["data.quarantined.read_error"] == 1
        assert got[2]["io.retries.tfrecord.read"] == 3
    elif plan == "bitflip":
        assert got[2]["data.quarantined"] == 0
        changed = np.any(got[0] != clean[0], axis=(1, 2, 3))
        assert changed.tolist() == [i == 1 for i in range(N)]
    else:
        assert got[2]["data.quarantined.decode_error"] == 1
    if plan in ("corrupt", "truncate", "read_error", "last_record"):
        bad = {"corrupt": 3, "truncate": 6, "read_error": 2,
               "last_record": N - 1}[plan]
        np.testing.assert_array_equal(got[0][bad],
                                      clean[0][(bad + 1) % N])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_quarantine_off_raises_and_a_destroyed_split_raises(shards, pkg):
    with pytest.raises(Exception) as e:
        _drill(pkg, shards["raw32"], PLANS["corrupt"], quarantine=False)
    assert not isinstance(e.value, OSError)
    every = {"tfrecord.read": {"kind": "corrupt", "every": 1}}
    with pytest.raises(ValueError, match="every record in the split"):
        _drill(pkg, shards["raw32"], every)


def test_resolve_decode_workers_is_the_reference():
    for n in (0, 1, 3, 16):
        assert (grain_pipeline.resolve_decode_workers(n)
                == jax_grain.resolve_decode_workers(n))


@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_is_opencv(seed):
    """``cv2.resize(INTER_LINEAR)`` of uint8 images, up and down, with the
    2x downscale (OpenCV's INTER_AREA route) and 1-pixel edges, under
    OpenCV's default dispatch and without its optimizations."""
    rng = np.random.default_rng(seed)
    shapes = [(317, 317, 299, 299), (64, 64, 32, 32), (1, 7, 3, 3),
              (33, 1, 8, 8), (40, 52, 64, 64)]
    shapes += [tuple(int(v) for v in rng.integers(1, 160, 4))
               for _ in range(12)]
    before = cv2.useOptimized()
    try:
        for optimized in (True, False):
            cv2.setUseOptimized(optimized)
            for h, w, oh, ow in shapes:
                src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                np.testing.assert_array_equal(
                    imgproc.resize_linear(src, ow, oh),
                    cv2.resize(src, (ow, oh), interpolation=cv2.INTER_LINEAR),
                    err_msg=f"{(h, w)} -> {(oh, ow)}, optimized={optimized}")
    finally:
        cv2.setUseOptimized(before)
