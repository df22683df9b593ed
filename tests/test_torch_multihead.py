"""The 5-class ICDR head (``model.head=multi``, the ``icdr5`` preset) of
the port against the JAX package on the CPU: the loss with and without
label smoothing, three train steps, the serving engine's [k, n, 5]
probabilities, the predict CLI's rows, ``fit``'s val AUC on the
referable probability, and ``evaluate_checkpoints`` with its
``save_probs`` CSV. Everything runs in float32 on the ``smoke`` preset's
``tiny_cnn`` at 64 px with five outputs."""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import synthetic as jax_synthetic
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.eval import metrics as jax_metrics
from jama16_retina_tpu.obs.registry import Registry
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import host as jax_host
from jama16_retina_tpu_torch import (configs, evaluate, models, predict,
                                     train_lib, trainer)
from jama16_retina_tpu_torch.data import synthetic
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (flat_optax_state, random_flat, stacked_state,
                          variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI = ["model.head=multi", "model.image_size=64",
         "model.compute_dtype=float32"]


def _configs(*extra):
    sets = MULTI + list(extra)
    return (jax_configs.override(jax_configs.get_config("smoke"), sets),
            configs.override(configs.get_config("smoke"), sets))


def _port(module, flat):
    module.load_state_dict(convert.flax_to_torch(flat, module))
    return module


def _close(got: dict, want: dict, atol: float):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _flat(tree) -> dict:
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(a) for k, a in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("head", ["multi", "binary"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_head_loss_matches_optax(head, smoothing):
    """Softmax cross entropy against ``optax.smooth_labels`` targets (the
    multi head) and the sigmoid BCE (binary), within 1e-6."""
    rng = np.random.default_rng(int(10 * smoothing) + len(head))
    logits = rng.normal(0, 3, (16, 5 if head == "multi" else 1)).astype(
        np.float32)
    grades = rng.integers(0, 5, 16).astype(np.int32)
    want = jax_train_lib._head_loss(
        jnp.asarray(logits),
        jax_train_lib._labels_from_grades(jnp.asarray(grades), head), head,
        smoothing, None)
    got = train_lib._head_loss(
        torch.from_numpy(logits),
        train_lib._labels_from_grades(torch.from_numpy(grades), head), head,
        smoothing)
    assert abs(float(got) - float(want)) <= 1e-6


def test_aux_loss_takes_the_head():
    """The aux head's loss is the same 5-class loss at ``aux_weight``."""
    cfg = configs.get_config("icdr5")
    assert cfg.model.head == "multi" and cfg.train.label_smoothing == 0.1
    rng = np.random.default_rng(3)
    logits, aux = (torch.from_numpy(rng.normal(size=(8, 5)).astype(
        np.float32)) for _ in range(2))
    grades = torch.from_numpy(rng.integers(0, 5, 8))
    labels = train_lib._labels_from_grades(grades, "multi")
    want = (train_lib._head_loss(logits, labels, "multi", 0.1)
            + 0.4 * train_lib._head_loss(aux, labels, "multi", 0.1))
    assert torch.equal(train_lib.loss_fn(logits, aux, grades, cfg), want)


@pytest.mark.parametrize("form", ["preset", "fused"])
def test_multi_train_step_matches_jax_for_three_steps(form):
    """Three steps of the 5-class ``tiny_cnn`` (label smoothing 0.1,
    dropout 0, augmentation off) against ``make_train_step``, in each
    step form: the loss per step (1e-5), then the params and statistics
    (2e-5) and the Adam moments and counts (1e-5; measured 3.9e-8).

    The learning rate is 0, so every step takes the head's gradient at
    the same params and the moments sum three of them. With any update,
    the trajectories part: at a peak of 1e-5 the moments of one step from
    a shared state differed by 8.9e-5 in one conv1 channel (a ReLU gate
    that rounding decides), and at the smoke preset's 3e-3 Adam's first
    normalized updates of gradients that rounding decides moved params by
    3e-5 to 1e-3 at four seeds of four (ROADMAP.md Queue C). Augmentation
    is off: its 1-ulp differences move such gradients too. The update
    rule and the augment in the loop are pinned by the binary head's
    three-step test in ``test_torch_train.py``."""
    jcfg, cfg = _configs(
        "model.dropout_rate=0.0", "train.label_smoothing=0.1",
        "train.steps=10", "train.lr_schedule=constant",
        "train.learning_rate=0.0", "data.augment=false",
        "data.use_pallas=true" if form == "preset"
        else "train.use_pallas_fused=true")
    jmodel = jax_models.build(jcfg.model)
    flat = random_flat(jmodel, (2, 64, 64, 3), seed=21)
    v = variables(flat)
    tx = jax_train_lib.make_optimizer(jcfg.train)
    jstate = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    jstep = jax_train_lib.make_train_step(jcfg, jmodel, tx, donate=False)
    state = train_lib.create_state(cfg, _port(models.build(cfg.model), flat),
                                   "cpu")
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=4)
    jbatch = {"image": jnp.asarray(images), "grade": jnp.asarray(grades)}
    batch = {"image": torch.from_numpy(images),
             "grade": torch.from_numpy(grades)}
    for s in range(3):
        jstate, m = jstep(jstate, jbatch, jax.random.key(0))
        loss = train_lib.train_step(state, batch, cfg)
        assert abs(float(loss) - float(m["loss"])) <= 1e-5, s
    want = {**{"params/" + k: a for k, a in _flat(jstate.params).items()},
            **{"batch_stats/" + k: a
               for k, a in _flat(jstate.batch_stats).items()}}
    _close(convert.torch_to_flax(state.model), want, atol=2e-5)
    opt = convert.port_to_optax("adamw", train_lib.moments(state),
                                int(state.count), int(state.sched_count))
    want_opt = flat_optax_state(jstate.opt_state, "adamw")
    assert int(opt["adam/count"]) == int(want_opt["adam/count"]) == 3
    _close(opt, want_opt, atol=1e-5)


@pytest.fixture(scope="module")
def multi_members(tmp_path_factory):
    """k=2 five-class ``tiny_cnn`` members as Flax trees and port member
    dirs."""
    jcfg, _ = _configs()
    model = jax_models.build(jcfg.model)
    flats = [random_flat(model, (2, 64, 64, 3), seed=40 + m) for m in range(2)]
    root = tmp_path_factory.mktemp("multi_members")
    for m, flat in enumerate(flats):
        ckpt_lib.save_member(str(root / f"member_{m:02d}"), flat)
    return flats, str(root)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_engine_multi_probs_match_jax_engine(multi_members, tta):
    """[k, n, 5] member probabilities (flip-TTA averaging the softmax of
    the 4 views) and the float64 member mean [n, 5] within 1e-5; rows sum
    to 1."""
    flats, root = multi_members
    jcfg, cfg = _configs("serve.max_batch=8", f"eval.tta={tta}")
    images = np.random.default_rng(5).integers(0, 256, (11, 64, 64, 3),
                                               np.uint8)
    ref = jax_engine.ServingEngine(jcfg, model=jax_models.build(jcfg.model),
                                   state=stacked_state(flats),
                                   registry=Registry())
    engine = ServingEngine(cfg, ckpt_lib.discover_member_dirs(root),
                           device="cpu")
    got = engine.member_probs(images)
    assert got.shape == (2, 11, 5)
    np.testing.assert_allclose(got, ref.member_probs(images), rtol=0,
                               atol=1e-5)
    mean = engine.probs(images)
    assert mean.dtype == np.float64 and mean.shape == (11, 5)
    np.testing.assert_allclose(mean, ref.probs(images), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_predict_multi_rows_match_the_reference(multi_members, tmp_path,
                                                capsys):
    """``--config=icdr5``-style rows: ``prob`` is P(grade >= 2) of the
    ensemble mean, ``grade_probs`` the 5 probabilities rounded to 6
    places, ``predicted_grade`` their argmax, as the root ``predict.py``
    writes them, within 1e-5 of the JAX engine on the JAX host stage."""
    import cv2

    flats, root = multi_members
    for i in range(4):
        img = jax_synthetic.render_fundus(
            np.random.default_rng(i), i % 5,
            jax_synthetic.SynthConfig(image_size=96))
        cv2.imwrite(str(tmp_path / f"eye_{i}.png"), img[..., ::-1])
    args = [f"--checkpoint_dir={root}", f"--images={tmp_path}",
            "--config=icdr5", "--device=cpu", "--threshold=0.5",
            "--batch_size=4", "--set", "model.arch=tiny_cnn",
            "--set", "model.aux_head=false"]
    for o in MULTI[1:]:
        args += ["--set", o]
    assert predict.main(args) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.strip()]
    pre = jax_host.preprocess_paths(predict._expand([str(tmp_path)]), 64,
                                    workers=2, registry=Registry())
    jcfg, _ = _configs("serve.max_batch=4", "serve.bucket_sizes=4")
    want = jax_engine.ServingEngine(
        jcfg, model=jax_models.build(jcfg.model), state=stacked_state(flats),
        registry=Registry()).probs(pre.images)
    assert [r["image"] for r in rows] == pre.kept and len(rows) == 4
    for r, w in zip(rows, want):
        assert list(r) == ["image", "prob", "grade_probs", "predicted_grade",
                           "referable", "threshold", "quality", "n_models"]
        ref = float(jax_metrics.referable_probs_from_multiclass(w))
        assert abs(r["prob"] - ref) <= 1e-5
        np.testing.assert_allclose(r["grade_probs"], w, rtol=0, atol=1e-5)
        assert r["grade_probs"] == [round(x, 6) for x in r["grade_probs"]]
        assert r["predicted_grade"] == int(np.argmax(w))
        assert r["referable"] == (r["prob"] >= 0.5) and r["n_models"] == 2


@pytest.fixture(scope="module")
def exported_multi(tmp_path_factory):
    """A five-class member trained by the JAX ``fit`` on raw splits and
    exported to the port: (data dir, JAX member dir, port member dir)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import export_torch_member
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("eval_multi")
    data = str(root / "data")
    for split, n, seed in (("train", 16, 1), ("val", 12, 2), ("test", 14, 3)):
        jax_tfrecord.write_synthetic_split(data, split, n, 64, num_shards=2,
                                           seed=seed, encoding="raw")
    jcfg, _ = _configs("train.steps=2", "train.eval_every=2")
    jax_trainer.fit(jcfg, data, str(root / "jax"))
    written = export_torch_member.export(jcfg, str(root / "jax"),
                                         str(root / "port"))
    return data, str(root / "jax"), written[0]


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_evaluate_multi_matches_the_reference(exported_multi, tmp_path):
    """``evaluate_checkpoints`` of the five-class member on ``test`` with
    thresholds and a temperature from ``val``: the report (accuracy,
    quadratic weighted kappa, AUC and operating points on P(grade >= 2),
    transferred points, calibration) within 1e-6 of the JAX one, and the
    ``save_probs`` CSV's columns and values within 1e-5 (6 decimals)."""
    data, jax_dir, port_dir = exported_multi
    jcfg, cfg = _configs()
    want = jax_trainer.evaluate_checkpoints(
        jcfg, data, [jax_dir], threshold_split="val", calibrate=True,
        save_probs=str(tmp_path / "jax.csv"))
    got = trainer.evaluate_checkpoints(
        cfg, data, [port_dir], threshold_split="val", calibrate=True,
        save_probs=str(tmp_path / "port.csv"), device="cpu")
    assert {"accuracy", "quadratic_weighted_kappa", "auc",
            "operating_points_transferred", "calibration"} <= set(got)
    want["probs_file"] = got["probs_file"]

    def close(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                close(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                close(a, b)
        elif isinstance(w, float) and np.isfinite(w):
            assert abs(g - w) <= 1e-6
        else:
            assert g == w

    close(got, want)
    rows_g, rows_w = _csv(tmp_path / "port.csv"), _csv(tmp_path / "jax.csv")
    assert list(rows_g[0]) == list(rows_w[0]) == [
        "name", "grade", "quality", "prob_referable",
        *[f"prob_grade_{c}" for c in range(5)]]
    assert len(rows_g) == len(rows_w) == 14
    for g, w in zip(rows_g, rows_w):
        assert (g["name"], g["grade"], g["quality"]) == (
            w["name"], w["grade"], w["quality"])
        for k in list(w)[3:]:
            assert abs(float(g[k]) - float(w[k])) <= 1e-5, k


def test_evaluate_cli_takes_icdr5_by_name(exported_multi, capsys):
    """``python -m jama16_retina_tpu_torch.evaluate --config=icdr5`` (cut
    to the five-class ``tiny_cnn`` at 64 px) prints the same report as
    ``evaluate_checkpoints`` as its last line."""
    data, _, port_dir = exported_multi
    args = ["--config=icdr5", f"--data_dir={data}",
            f"--checkpoint_dir={port_dir}", "--device=cpu"]
    for item in ("model.arch=tiny_cnn", *MULTI[1:]):
        args += ["--set", item]
    assert evaluate.main(args) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, cfg = _configs()
    want = trainer.evaluate_checkpoints(cfg, data, [port_dir], device="cpu")
    assert {"accuracy", "quadratic_weighted_kappa"} <= set(last)
    assert last["accuracy"] == want["accuracy"]
    assert last["auc"] == want["auc"] and last["n_models"] == 1


def test_fit_multi_tracks_val_auc_on_the_referable_probability(
        exported_multi, tmp_path):
    """The port's ``fit`` of the five-class head on the same splits: its
    eval record's ``val_auc`` is the AUC of P(grade >= 2) of the eval
    params on ``val``, recomputed here from the saved member."""
    data, _, _ = exported_multi
    _, cfg = _configs("train.steps=2", "train.eval_every=2")
    res = trainer.fit(cfg, data, str(tmp_path), device="cpu")
    evals = [r for r in read_jsonl(str(tmp_path / trainer.METRICS_FILE))
             if r["kind"] == "eval"]
    assert [r["step"] for r in evals] == [2] and res["best_step"] == 2
    engine = ServingEngine(cfg, [str(tmp_path)], device="cpu")
    grades, probs, _ = trainer.predict_split(cfg, engine.member_probs, data,
                                             "val")
    assert probs.shape == (1, 12, 5)
    auc = jax_metrics.roc_auc(
        (grades >= 2).astype(np.float64),
        jax_metrics.referable_probs_from_multiclass(probs[0]))
    assert abs(evals[0]["val_auc"] - auc) <= 1e-9
