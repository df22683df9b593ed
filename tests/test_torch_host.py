"""The port's serving host stage without OpenCV (``preprocess/imgproc.py``,
``preprocess/fundus.py``, ``serve/host.py``) against OpenCV and the JAX
host stage on the CPU, and the metric names the port's engine, host
stage and pipeline publish against the JAX package's.

Tolerances, each stated where it is asserted: ``INTER_AREA``, grey and
Laplacian bitwise; ``INTER_CUBIC`` bitwise OpenCV with its optimizations
off (run in a subprocess: the switch is process-global) and within 1
level of OpenCV's default; the Gaussian blur within 1e-4; a canvas that
is downscaled bitwise the JAX host stage's, an upscaled one within 1
level, ``ben_graham`` within 1 level of the reference's enhancement of
the same canvas; gradability within 1e-3 where the canvas moved by a
level."""

import glob
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.data import pipeline as jax_pipeline
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.preprocess import fundus as jax_fundus
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import host as jax_host
from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.data import pipeline
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.preprocess import fundus, imgproc
from jama16_retina_tpu_torch.serve import host
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from torch_parity import random_flat, stacked_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
# Photos the fundus stage downscales (INTER_AREA, bitwise) at 299 px.
DOWNSCALED = ("fundus1024.jpg", "fundus317_1.jpg", "fundus317_3.jpg")


def _rng_image(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("h,w,fx", [
    (96, 96, 68 / 96), (77, 61, 0.52), (90, 120, 44 / 120),
    (299, 299, 0.7123), (1024, 1024, 0.3148),
    (96, 96, 0.5), (97, 99, 0.5), (100, 101, 1 / 3), (64, 64, 0.25),
    (103, 94, 0.25)])
def test_resize_area_is_opencvs_bitwise(h, w, fx):
    img = _rng_image(h, w, seed=h + w)
    want = cv2.resize(img, None, fx=fx, fy=fx, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(imgproc.resize_area(img, fx), want)


_CUBIC_GENERIC = r"""
import sys
import cv2
import numpy as np
from jama16_retina_tpu_torch.preprocess import imgproc
cv2.setUseOptimized(False)
for h, w, fx in ((64, 64, 4.8837), (37, 53, 1.7), (200, 180, 1.33),
                 (96, 96, 3.6633), (29, 31, 2.25), (5, 3, 1.9)):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    want = cv2.resize(img, None, fx=fx, fy=fx, interpolation=cv2.INTER_CUBIC)
    got = imgproc.resize_cubic(img, fx)
    if not np.array_equal(got, want):
        raise SystemExit(f"{(h, w, fx)}: {int((got != want).sum())} differ")
print("OK")
"""


def test_resize_cubic_is_opencvs_generic_path_bitwise():
    """Bitwise ``cv2.resize(INTER_CUBIC)`` with ``cv2.setUseOptimized(
    False)``, in a subprocess (the switch is process-global)."""
    out = subprocess.run([sys.executable, "-c", _CUBIC_GENERIC], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout
    assert out.stdout.strip() == "OK"


@pytest.mark.parametrize("h,w,fx", [(64, 64, 4.8837), (200, 180, 1.33),
                                    (299, 299, 1.05)])
def test_resize_cubic_is_within_one_level_of_opencvs_default(h, w, fx):
    img = _rng_image(h, w, seed=7)
    want = cv2.resize(img, None, fx=fx, fy=fx, interpolation=cv2.INTER_CUBIC)
    got = imgproc.resize_cubic(img, fx)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"INTER_CUBIC {h}x{w} by {fx}: {100 * np.mean(diff > 0):.2f} % "
          f"of values differ from OpenCV's default, by at most "
          f"{diff.max()}")
    assert got.shape == want.shape and diff.max() <= 1


def test_grey_and_laplacian_are_opencvs_bitwise():
    img = _rng_image(41, 57)
    grey = imgproc.rgb2gray(img)
    np.testing.assert_array_equal(grey, cv2.cvtColor(img,
                                                     cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(imgproc.laplacian_f32(grey),
                                  cv2.Laplacian(grey, cv2.CV_32F))


@pytest.mark.parametrize("sigma", [9.966, 2.13, 1.0])
def test_gaussian_blur_is_within_1e4_of_opencv(sigma):
    img = _rng_image(299, 299, seed=3).astype(np.float32)
    want = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
    got = imgproc.gaussian_blur_f32(img, sigma)
    assert got.dtype == np.float32
    assert float(np.max(np.abs(got - want))) <= 1e-4


@pytest.mark.parametrize("seed", range(3))
def test_ben_graham_is_within_one_level_of_the_reference(seed):
    canvas = jax_fundus.resize_and_center_fundus(
        cv2.imdecode(np.fromfile(os.path.join(
            FIXTURES, f"fundus299_{seed}.jpg"), np.uint8), 1)[..., ::-1])
    want = jax_fundus.ben_graham_enhance(canvas)
    got = fundus.ben_graham_enhance(canvas)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _photos():
    return sorted(p for p in glob.glob(os.path.join(FIXTURES, "*"))
                  if not p.endswith(".json"))


@pytest.mark.parametrize("ben_graham", [False, True])
def test_host_stage_matches_the_jax_host_stage(ben_graham, tmp_path):
    """Same kept rows in the same order; canvases bitwise where the fundus
    is downscaled, within 1 level where it is upscaled (``ben_graham``:
    checked on the downscaled ones, since it multiplies a level by 4);
    the EXIF-rotated photo rotated as OpenCV rotates it."""
    paths = _photos()
    want = jax_host.preprocess_paths(paths, 299, ben_graham=ben_graham,
                                     workers=2, registry=JaxRegistry())
    got = host.preprocess_paths(paths, 299, ben_graham=ben_graham,
                                workers=3, registry=Registry())
    assert got.kept == want.kept == paths and got.skipped == []
    for p, g, w, qg, qw in zip(paths, got.images, want.images,
                               got.qualities, want.qualities):
        diff = np.abs(g.astype(int) - w.astype(int)).max()
        if os.path.basename(p) in DOWNSCALED:
            assert diff <= (1 if ben_graham else 0), p
            assert qg == qw, p
        else:
            assert ben_graham or diff <= 1, p
            assert abs(qg - qw) <= 1e-3, p


def test_host_stage_canvases_match_the_manifest():
    """The port's canvases are the ones ``make_torch_fixtures.py``
    recorded (``chip_smoke.py`` holds the card machine's host to the same
    digests)."""
    import hashlib

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    paths = _photos()
    got = host.preprocess_paths(paths, 299, workers=2, registry=Registry())
    for p, canvas in zip(got.kept, got.images):
        want = manifest[os.path.basename(p)].get("canvas299")
        if want is not None:
            assert hashlib.sha256(canvas.tobytes()).hexdigest() == want, p


def test_rejects_are_counted_as_the_reference_counts_them(tmp_path):
    (tmp_path / "junk.jpeg").write_bytes(b"not a jpeg")
    cv2.imwrite(str(tmp_path / "blank.png"), np.zeros((40, 40, 3),
                                                      np.uint8))
    dot = np.zeros((200, 200, 3), np.uint8)
    dot[100:103, 100:103] = 200
    cv2.imwrite(str(tmp_path / "dot.png"), dot)
    paths = sorted(str(p) for p in tmp_path.iterdir())
    jreg, reg = JaxRegistry(), Registry()
    want = jax_host.preprocess_paths(paths, 64, workers=1, registry=jreg)
    got = host.preprocess_paths(paths, 64, workers=1, registry=reg)
    assert got.skipped == want.skipped and len(got.skipped) == 3
    jsnap, snap = jreg.snapshot(), reg.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert {m.name: m.help for m in reg._metrics.values()} == {
        n: jsnap["help"].get(n, "") for n in snap["counters"]}


def _names(snapshot: dict) -> set:
    return {(kind, n) for kind in ("counters", "gauges", "histograms")
            for n in snapshot[kind]}


@pytest.mark.parametrize("extra", [[], ["serve.fused_preprocess=true",
                                        "serve.dtype=bf16"]])
def test_engine_publishes_the_references_metric_names(extra):
    """One request through each package's engine: the same metric names,
    but ``serve.bucket_compiles_b{N}`` (the compile cache, ROADMAP item
    9) and the reference's ``device.compile.*`` ledger of its bf16
    transform (``obs/device.py``, item 11, part 4). The shared help
    strings are equal."""
    o = ["model.image_size=32", "model.compute_dtype=float32",
         "serve.max_batch=4", "serve.bucket_sizes=4", *extra]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), o)
    flat = random_flat(jax_models.build(jcfg.model), (2, 32, 32, 3), seed=1)
    jreg, reg = JaxRegistry(), Registry()
    images = _rng_image(6, 32 * 32, seed=2).reshape(6, 32, 32, 3)
    jax_engine.ServingEngine(
        jcfg, model=jax_models.build(jcfg.model),
        state=stacked_state([flat]), registry=jreg).probs(images)
    cfg = configs.override(configs.get_config("smoke"), o)
    sd = convert.flax_to_torch(flat, models.build(cfg.model))
    ServingEngine(cfg, state_dicts=[sd], device="cpu",
                  registry=reg).probs(images)
    jsnap = jreg.snapshot()
    want = {n for n in _names(jsnap)
            if not n[1].startswith(("serve.bucket_compiles_b", "device."))}
    assert _names(reg.snapshot()) == want
    helps = {m.name: m.help for m in reg._metrics.values()}
    for name, text in jsnap["help"].items():
        if name in helps:
            assert helps[name] == text, name


@pytest.mark.parametrize("input_stats", [True, False])
def test_fused_rows_count_the_rows_the_quality_monitor_reads(tmp_path,
                                                             input_stats):
    """On the fused path with the quality monitor on, both engines count
    ``serve.preprocess.fused_rows`` for exactly the rows whose input
    statistics the monitor bins: all of a request's rows under a profile
    with reference histograms, none (and no counter) under one without.
    The reference runs its fused pass for them; the port reads B4's sums
    from the forward. Tolerance: equal counters."""
    from jama16_retina_tpu.obs import quality as jax_quality

    images = _rng_image(6, 32 * 32, seed=5).reshape(6, 32, 32, 3)
    profile = jax_quality.save_profile(
        str(tmp_path / "profile.json"), jax_quality.build_profile(
            np.linspace(0, 1, 8), stat_values=(
                jax_quality.input_stat_values(images) if input_stats
                else None)))
    o = ["model.image_size=32", "model.compute_dtype=float32",
         "serve.max_batch=4", "serve.bucket_sizes=4",
         "serve.fused_preprocess=true", "obs.quality.enabled=true",
         f"obs.quality.profile_path={profile}"]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), o)
    flat = random_flat(jax_models.build(jcfg.model), (2, 32, 32, 3), seed=1)
    jreg, reg = JaxRegistry(), Registry()
    jax_engine.ServingEngine(
        jcfg, model=jax_models.build(jcfg.model),
        state=stacked_state([flat]), registry=jreg).probs(images)
    cfg = configs.override(configs.get_config("smoke"), o)
    sd = convert.flax_to_torch(flat, models.build(cfg.model))
    ServingEngine(cfg, state_dicts=[sd], device="cpu",
                  registry=reg).probs(images)
    name = "serve.preprocess.fused_rows"
    got = reg.snapshot()["counters"].get(name)
    assert got == jreg.snapshot()["counters"].get(name)
    assert got == (6.0 if input_stats else None)


def test_fused_rows_and_the_prefetch_gauge_take_the_reference_names():
    jreg, reg = JaxRegistry(), Registry()
    rows = _rng_image(3, 8 * 8, seed=4).reshape(3, 8, 8, 3)
    jax_host.prepare_images(rows, fused=True, registry=jreg)
    host.prepare_images(rows, fused=True, device="cpu", registry=reg)
    assert reg.snapshot()["counters"] == jreg.snapshot()["counters"] == {
        "serve.preprocess.fused_rows": 3.0}
    assert reg._metrics["serve.preprocess.fused_rows"].help == \
        jreg.snapshot()["help"]["serve.preprocess.fused_rows"]

    batches = [{"image": torch.zeros(2, 4, 4, 3, dtype=torch.uint8)}
               for _ in range(4)]
    with pipeline.DevicePrefetch(iter(batches), "cpu", size=2) as it:
        assert len(list(it)) == 4
    gauge = obs_registry.default_registry()._metrics["data.prefetch.depth"]
    from jama16_retina_tpu.obs import registry as jax_obs_registry

    list(jax_pipeline.device_prefetch(iter([{"x": np.zeros(2)}]), size=1))
    jgauge = jax_obs_registry.default_registry().snapshot()
    assert gauge.help == jgauge["help"]["data.prefetch.depth"]
    assert gauge.value == 0.0
