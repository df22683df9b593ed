"""The port's predict CLI (``python -m jama16_retina_tpu_torch.predict``)
against the JAX package's host stage and serving engine: same kept and
skipped rows in the same order, the same JSONL row schema, and
probabilities within 1e-5 of the JAX engine on the JAX host stage's
canvases (float32 models; rows print probabilities rounded to 6
decimals)."""

import json

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.data import synthetic
from jama16_retina_tpu.obs.registry import Registry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import host as jax_host
from jama16_retina_tpu_torch import predict
from jama16_retina_tpu_torch.serve import host
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import random_flat, stacked_state

OVERRIDES = ["model.image_size=64", "model.compute_dtype=float32"]
BATCH = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("port_predict")
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), OVERRIDES)
    model = jax_models.build(jcfg.model)
    flats = [random_flat(model, (2, 64, 64, 3), seed=30 + m) for m in range(2)]
    ckdir = root / "ckpt"
    for m, flat in enumerate(flats):
        ckpt_lib.save_member(str(ckdir / f"member_{m:02d}"), flat)
    imgdir = root / "imgs"
    imgdir.mkdir()
    for i in range(6):
        img = synthetic.render_fundus(np.random.default_rng(i), i % 5,
                                      synthetic.SynthConfig(image_size=96))
        cv2.imwrite(str(imgdir / f"eye_{i}.jpeg"), img[..., ::-1])
    (imgdir / "junk.jpeg").write_bytes(b"not a jpeg")
    return jcfg, flats, str(ckdir), str(imgdir)


def _run(capsys, args):
    code = predict.main(args)
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.strip()]
    return code, rows


def test_predict_rows_match_jax_host_and_engine(setup, capsys):
    jcfg, flats, ckdir, imgdir = setup
    args = [f"--checkpoint_dir={ckdir}", f"--images={imgdir}",
            "--config=smoke", "--device=cpu", "--threshold=0.5",
            f"--batch_size={BATCH}", "--host_workers=2"]
    for o in OVERRIDES:
        args += ["--set", o]
    code, rows = _run(capsys, args)
    assert code == 0

    paths = predict._expand([imgdir])
    pre = jax_host.preprocess_paths(paths, 64, workers=2, registry=Registry())
    errors = [r for r in rows if "error" in r]
    scored = [r for r in rows if "error" not in r]
    assert [(r["image"], r["error"]) for r in errors] == pre.skipped
    assert rows[:len(errors)] == errors  # skipped rows print first
    assert [r["image"] for r in scored] == pre.kept and len(pre.kept) == 6

    port_pre = host.preprocess_paths(paths, 64, workers=3)
    np.testing.assert_array_equal(port_pre.images, pre.images)

    ecfg = jcfg.replace(serve=jax_configs.ServeConfig(
        max_batch=BATCH, bucket_sizes=(BATCH,)))
    ref = jax_engine.ServingEngine(
        ecfg, model=jax_models.build(ecfg.model), state=stacked_state(flats),
        registry=Registry())
    want = ref.probs(pre.images)
    got = np.array([r["prob"] for r in scored])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for r, q, p in zip(scored, pre.qualities, want):
        assert set(r) == {"image", "prob", "referable", "threshold",
                          "quality", "n_models"}
        assert r["quality"] == round(q, 4)
        assert r["referable"] == (r["prob"] >= 0.5)
        assert r["threshold"] == 0.5 and r["n_models"] == 2


def test_predict_strict_exit_2_and_empty_glob_error(setup, capsys, tmp_path):
    _, _, ckdir, imgdir = setup
    base = [f"--checkpoint_dir={ckdir}", "--config=smoke", "--device=cpu",
            "--set", "model.image_size=64"]
    code, rows = _run(capsys, base + [f"--images={imgdir}", "--strict",
                                      "--min_quality=0.5"])
    assert code == 2
    assert all("gradable" in r for r in rows if "error" not in r)
    with pytest.raises(FileNotFoundError, match="matched nothing"):
        predict.main(base + [f"--images={tmp_path}/*.jpeg"])
    code, rows = _run(capsys, base + [f"--images={imgdir}/junk.jpeg"])
    assert code == 1 and rows == [{"image": f"{imgdir}/junk.jpeg",
                                   "error": "unreadable"}]


def test_predict_serving_knobs_reach_the_engine(setup, capsys, tmp_path):
    """``--set serve.dtype=int8 --set serve.member_parallel=true`` serves
    the rows the JAX int8 engine serves (1e-5); with a canary pinned to
    other scores and ``serve.dtype_canary_max_dev=0`` under
    ``obs.quality``, the engine's construction gate refuses the batch."""
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.serve.quantize import DtypeRejected

    jcfg, flats, ckdir, imgdir = setup
    base = [f"--checkpoint_dir={ckdir}", f"--images={imgdir}",
            "--config=smoke", "--device=cpu", f"--batch_size={BATCH}",
            "--set", "serve.dtype=int8"]
    for o in OVERRIDES:
        base += ["--set", o]
    code, rows = _run(capsys, base + ["--set", "serve.member_parallel=true"])
    assert code == 0
    pre = host.preprocess_paths(predict._expand([imgdir]), 64)
    ecfg = jcfg.replace(serve=jax_configs.ServeConfig(
        max_batch=BATCH, bucket_sizes=(BATCH,), dtype="int8"))
    want = jax_engine.ServingEngine(
        ecfg, model=jax_models.build(ecfg.model), state=stacked_state(flats),
        registry=Registry()).probs(pre.images)
    got = np.array([r["prob"] for r in rows if "error" not in r])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    canary = quality.save_canary(str(tmp_path / "c"), pre.images[:2],
                                 np.zeros(2))
    with pytest.raises(DtypeRejected, match="golden canary"):
        predict.main(base + ["--set", "obs.quality.enabled=true",
                             "--set", f"obs.quality.canary_path={canary}",
                             "--set", "serve.dtype_canary_max_dev=0"])
