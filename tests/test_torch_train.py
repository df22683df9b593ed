"""The port's train path against the JAX package on the CPU: train-mode
ConvBN, the Inception-v3 train forward and backward, three steps of the
``smoke`` train step in both step forms, the knobs it refuses, a short
``fit`` with each run knob it once refused, and the
``python -m jama16_retina_tpu_torch.train`` CLI.

Both sides start from the same numpy weights (``torch_parity``) and see
the same uint8 batches and augment draws (the JAX draws, injected through
``augment_params``); dropout is 0 and everything is float32. Tolerances
are stated at each test with what was measured.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu.data import augment as jax_augment
from jama16_retina_tpu.models import common as jax_common
from jama16_retina_tpu.models import inception_v3 as jax_inception
from jama16_retina_tpu_torch import configs, models, train_lib, trainer
from jama16_retina_tpu_torch.data import synthetic
from jama16_retina_tpu_torch.models import common, convert, inception_v3
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import (flat_optax_state, random_flat, to_nchw, to_nhwc,
                          torch_threads, variables)

F32 = jnp.float32


def _port(module, flat):
    module.load_state_dict(convert.flax_to_torch(flat, module))
    return module


def _flax_grads(tree) -> dict:
    """Flat ``params/...`` numpy dict of a Flax params-shaped tree."""
    return {"params/" + k: np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def _port_grads(module) -> dict:
    return convert.torch_to_flax(
        {k: p.grad for k, p in module.named_parameters()})


def _stats(mutated) -> dict:
    return {"batch_stats/" + k: np.asarray(v) for k, v in
            flatten_dict(mutated["batch_stats"], sep="/").items()}


def _port_stats(module) -> dict:
    return {k: v for k, v in convert.torch_to_flax(module).items()
            if k.startswith("batch_stats/")}


def _close(got: dict, want: dict, atol: float, rtol: float = 0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("kernel,strides,padding", [
    ((3, 3), (1, 1), "SAME"), ((3, 3), (2, 2), "VALID"), ((1, 7), (1, 1),
                                                          "SAME")])
def test_train_convbn_matches_flax(kernel, strides, padding):
    """Outputs, the input, kernel and bias grads, and the new running mean
    and biased variance, float32. Bounds 2e-5 (outputs of unit scale
    after normalization; the two sum the batch moments in different
    orders) and 1e-6 on the running statistics."""
    flax_mod = jax_common.ConvBN(16, kernel, strides, padding, dtype=F32)
    shape = (4, 9, 9, 8)
    flat = random_flat(flax_mod, shape, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 1.0, shape).astype(np.float32)
    v = variables(flat)

    def f(params, x):
        return flax_mod.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])

    y, vjp, mutated = jax.vjp(f, v["params"], jnp.asarray(x), has_aux=True)
    cot = rng.normal(size=y.shape).astype(np.float32)
    g_params, g_x = vjp(jnp.asarray(cot))

    mod = _port(common.ConvBN(8, 16, kernel, strides, padding,
                              dtype=torch.float32), flat)
    xt = to_nchw(x).requires_grad_(True)
    yt = mod(xt, train=True)
    yt.backward(to_nchw(cot))
    np.testing.assert_allclose(to_nhwc(yt), np.asarray(y), rtol=0, atol=2e-5)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(g_x), rtol=0,
                               atol=2e-5)
    _close(_port_grads(mod), _flax_grads(g_params), atol=2e-5, rtol=1e-5)
    _close(_port_stats(mod), _stats(mutated), atol=1e-6)


def _grad_gap(got: dict, want: dict) -> "tuple[float, float, dict]":
    """(||got - want|| / ||want|| over every gradient leaf, cosine, and
    that relative L2 per leaf)."""
    keys = sorted(want)
    assert sorted(got) == keys
    a = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    b = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    per_leaf = {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k])
                         / np.linalg.norm(want[k].astype(np.float64)))
                for k in keys}
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))), per_leaf)


def _flax_inception_train(flat, x, grades, dtype):
    """The JAX package's Inception-v3 train forward and gradient (aux on,
    dropout 0) in ``dtype``: (loss, logits, aux, flat new statistics,
    flat gradient). The heads are float32 whatever ``dtype`` is, as the
    Flax module makes them."""
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=True,
                                         dropout_rate=0.0, dtype=dtype)
    v = variables({k: a.astype(dtype) for k, a in flat.items()})
    aux_weight = jax_configs.get_config("eyepacs_binary").model.aux_weight

    def f(params):
        (logits, aux), mutated = flax_mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x, dtype), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        labels = jax_train_lib._labels_from_grades(jnp.asarray(grades),
                                                   "binary")
        loss = jax_train_lib._head_loss(logits, labels, "binary", 0.0, None)
        loss = loss + aux_weight * jax_train_lib._head_loss(
            aux, labels, "binary", 0.0, None)
        return loss, (logits, aux, mutated)

    (loss, (logits, aux, mutated)), g = jax.jit(
        jax.value_and_grad(f, has_aux=True))(v["params"])
    return (float(loss), np.asarray(logits), np.asarray(aux), _stats(mutated),
            _flax_grads(g))


@pytest.fixture(scope="module")
def inception_139():
    """Batch 2 at 139 px (the smallest size the aux head fits): weights,
    images, grades, and the JAX train forward and gradient in float64,
    the reference both of the port's dtypes are held to."""
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=True,
                                         dropout_rate=0.0, dtype=F32)
    flat = random_flat(flax_mod, (2, 139, 139, 3), seed=8)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 139, 139, 3)).astype(
        np.float32)
    grades = np.array([1, 3], np.int32)
    with jax.enable_x64(True):
        f64 = _flax_inception_train(flat, x, grades, jnp.float64)
    return {"flat": flat, "x": x, "grades": grades, "f64": f64}


def _port_inception_train(case, dtype):
    """The port's Inception-v3 train forward and backward on the case, in
    ``dtype`` with float32 heads: (loss, logits, aux, model)."""
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.image_size=139", "model.compute_dtype=float32",
        "model.dropout_rate=0.0"])
    model = inception_v3.InceptionV3(num_classes=1, aux_head=True,
                                     dropout_rate=0.0, dtype=dtype,
                                     image_size=139)
    model = _port(model, case["flat"]).to(dtype)
    model.Logits.float()
    model.AuxLogits.Logits.float()
    logits, aux = model(to_nchw(case["x"]).to(dtype), train=True)
    loss = train_lib.loss_fn(logits, aux, torch.from_numpy(case["grades"]),
                             cfg)
    loss.backward()
    return loss.item(), logits.detach().numpy(), aux.detach().numpy(), model


def test_inception_v3_139px_train_forward_and_grads_match_flax(inception_139):
    """Batch 2 at 139 px, aux on, dropout 0, the port in float32 against
    the JAX package in float64 (its heads float32): loss, logits, aux
    logits, every updated running statistic and the gradient.

    The float32 train gradient of the whole network is ill-conditioned
    at this size: BatchNorm's fast variance ``E[x^2] - E[x]^2`` cancels
    over maps of 3x3 (and 1x1 in the aux head), so a float32 gradient
    (the port's here) lies a few per cent from the float64 one, where the
    same port in float64 lies within 3e-8 (the next test). So the float32
    gradient is held by relative L2 <= 8 % and cosine >= 0.995 over all
    leaves (measured 3.2 %, 0.9995) and relative L2 <= 20 % in every leaf
    (worst measured 5.1 %, ``Mixed_6c/Branch_1_Conv2d_0a_1x1/bn/bias``).
    Forward values: loss 1e-3 (measured 4.3e-5), logits 1e-3 (4.0e-5),
    aux logits 5e-3 (4.1e-4: its BatchNorms see 2 values per channel),
    running statistics atol 1e-4 and rtol 1e-3."""
    loss, logits, aux, stats, grads = inception_139["f64"]
    got_loss, got_logits, got_aux, model = _port_inception_train(
        inception_139, torch.float32)
    np.testing.assert_allclose(got_loss, loss, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_logits, logits, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_aux, aux, rtol=0, atol=5e-3)
    _close(_port_stats(model), stats, atol=1e-4, rtol=1e-3)
    rel, cos, per_leaf = _grad_gap(_port_grads(model), grads)
    assert rel <= 0.08 and cos >= 0.995, (rel, cos)
    worst = max(per_leaf, key=per_leaf.get)
    assert per_leaf[worst] <= 0.2, (worst, per_leaf[worst])


def test_inception_v3_139px_train_grads_match_flax_per_leaf_in_float64(
        inception_139):
    """The same case with the port in float64 too (the heads stay float32
    on both sides, as the Flax module makes them), where the BatchNorm
    cancellation of the float32 test costs nothing:
    every gradient leaf within 1e-6 relative L2 of the JAX one (worst
    measured 3.1e-8, the float32 rounding of the port's gradient on its
    way to numpy), so a fault confined to one small leaf (an aux head
    conv, one branch of a block, a pool's backward) cannot hide in the
    global norm. Loss and logits 1e-6, running statistics rtol 1e-6."""
    loss, logits, aux, stats, grads = inception_139["f64"]
    got_loss, got_logits, got_aux, model = _port_inception_train(
        inception_139, torch.float64)
    np.testing.assert_allclose(got_loss, loss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_logits, logits, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_aux, aux, rtol=0, atol=1e-6)
    _close(_port_stats(model), stats, atol=1e-7, rtol=1e-6)
    _, _, per_leaf = _grad_gap(_port_grads(model), grads)
    assert len(per_leaf) == 196
    worst = max(per_leaf, key=per_leaf.get)
    assert per_leaf[worst] <= 1e-6, (worst, per_leaf[worst])


def _smoke_pair(form: str):
    """(JAX cfg, port cfg) of the smoke preset in float32 with dropout 0,
    in one step form: ``preset`` (B1 + plain AdamW) or ``fused`` (B2 +
    B3)."""
    sets = ["model.compute_dtype=float32", "model.dropout_rate=0.0",
            "train.steps=10", "train.lr_schedule=warmup_cosine",
            "train.weight_decay=0.01", "train.ema_decay=0.9"]
    sets += (["data.use_pallas=true"] if form == "preset"
             else ["train.use_pallas_fused=true"])
    return (jax_configs.override(jax_configs.get_config("smoke"), sets),
            configs.override(configs.get_config("smoke"), sets))


@pytest.mark.parametrize("form", ["preset", "fused"])
def test_smoke_train_step_matches_jax_for_three_steps(form):
    """Three steps of ``train_lib.train_step`` against
    ``make_train_step``: the loss per step, the schedule value, and after
    the third step the params and batch statistics, Adam moments and
    counts, and the EMA shadow. Measured gaps: loss 1.3e-6, params and
    statistics 4.8e-6, moments 3.0e-6, EMA 4.1e-7. At step 1 Adam's
    update is ``lr * sign(g)``, so a gradient near 0 whose sign differs
    between the frameworks would move a parameter by 2 lr (6e-3 here);
    none did at these seeds, so no entry is excluded."""
    jcfg, cfg = _smoke_pair(form)
    jmodel = jax_models.build(jcfg.model)
    flat = random_flat(jmodel, (2, 64, 64, 3), seed=12)
    v = variables(flat)
    tx = jax_train_lib.make_optimizer(jcfg.train)
    jstate = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        ema_params=jax.tree.map(jnp.copy, v["params"]))
    jstep = jax_train_lib.make_train_step(jcfg, jmodel, tx, donate=False)
    base_key = jax.random.key(0)

    state = train_lib.create_state(cfg, _port(models.build(cfg.model), flat),
                                   "cpu")
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=3)
    jbatch = {"image": jnp.asarray(images), "grade": jnp.asarray(grades)}
    batch = {"image": torch.from_numpy(images),
             "grade": torch.from_numpy(grades)}
    schedule = train_lib.make_schedule(cfg.train)
    for s in range(3):
        # The draws the JAX step makes inside (train_lib.py:440-447).
        aug_key, _ = jax.random.split(jax.random.fold_in(base_key, s))
        drawn = jax_augment._draw_params(aug_key, 8, jcfg.data)
        lr = float(schedule(state.sched_count))
        want_lr = float(jax_train_lib.make_schedule(jcfg.train)(s))
        assert abs(lr - want_lr) <= 2.0**-22 * jcfg.train.learning_rate
        jstate, m = jstep(jstate, jbatch, base_key)
        loss = train_lib.train_step(
            state, batch, cfg,
            augment_params={k: torch.from_numpy(np.array(a))
                            for k, a in drawn.items()})
        assert abs(float(loss) - float(m["loss"])) <= 1e-5, s

    assert state.step == int(jstate.step) == 3
    want = {**_flax_grads(jstate.params),
            **_stats({"batch_stats": jstate.batch_stats})}
    _close(convert.torch_to_flax(state.model), want, atol=2e-5)
    opt = convert.port_to_optax("adamw", train_lib.moments(state),
                                int(state.count), int(state.sched_count))
    want_opt = flat_optax_state(jstate.opt_state, "adamw")
    assert int(opt["adam/count"]) == int(want_opt["adam/count"]) == 3
    assert int(opt["schedule/count"]) == int(want_opt["schedule/count"]) == 3
    _close(opt, want_opt, atol=1e-5)
    ema = {k: v for k, v in
           convert.torch_to_flax(train_lib.eval_params(state)).items()
           if k.startswith("params/")}
    _close(ema, _flax_grads(jstate.ema_params), atol=2e-6)


@pytest.mark.parametrize("item,exc", [
    ("train.use_pallas_fused=true,train.optimizer=sgdm", ValueError),
    ("train.use_pallas_fused=true,train.gradient_clip_norm=1.0", ValueError),
    ("train.optimizer=adagrad", ValueError),
    # Distillation is ported: a teacher that is not there is refused
    # before the run writes anything.
    ("train.distill_from=/x", FileNotFoundError),
    ("model.stem_s2d=true", NotImplementedError),
    ("model.remat_stem=true", NotImplementedError),
    ("train.dtype=fp16", ValueError),
    ("train.lr_schedule=step", ValueError),
])
def test_train_refuses_knobs_it_cannot_honour(item, exc, tmp_path):
    cfg = configs.override(configs.get_config("smoke"), item.split(","))
    with pytest.raises(exc):
        trainer.fit_synthetic(cfg, str(tmp_path), 8, device="cpu")
    assert not os.path.exists(tmp_path / trainer.METRICS_FILE)


@pytest.mark.parametrize("item", [
    "model.head=multi", "train.optimizer=sgdm", "train.optimizer=lamb",
    "train.gradient_clip_norm=1.0", "train.ensemble_size=2"])
def test_train_runs_knobs_it_once_refused(item, knob_data, tmp_path):
    """Knobs refused until they were ported now train on ``smoke``:
    ``model.head=multi`` (the 5-class head builds with five outputs),
    the optimizers sgdm and lamb and the gradient clip (a
    ``fit_synthetic`` step on the CPU writes its train record and a
    servable member, with the family's state), and
    ``train.ensemble_size=2`` (``fit_ensemble`` trains both members, one
    after another, into ``member_00`` and ``member_01``). Their parity
    with the reference is held in ``tests/test_torch_optimizers.py`` and
    ``tests/test_torch_ensemble_parallel.py``."""
    cfg = configs.override(configs.get_config("smoke"), [
        item, "train.steps=1", "train.log_every=1", "train.eval_every=1"])
    if item == "train.ensemble_size=2":
        with torch_threads(1):
            res = trainer.fit_ensemble(cfg, knob_data[0], str(tmp_path),
                                       device="cpu")
        assert [r["member"] for r in res] == [0, 1]
        assert all(r["best_step"] == 1 for r in res)
        assert sorted(os.listdir(tmp_path)) == ["member_00", "member_01"]
        return
    if item == "model.head=multi":
        assert models.build(cfg.model).Logits.out_features == 5
    with torch_threads(1):
        res = trainer.fit_synthetic(cfg, str(tmp_path), 8, device="cpu")
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])
    assert os.path.exists(tmp_path / trainer.METRICS_FILE)
    probs = ServingEngine(cfg, [str(tmp_path)], device="cpu").probs(
        np.zeros((2, 64, 64, 3), np.uint8))
    assert probs.shape == ((2, 5) if item == "model.head=multi" else (2,))


@pytest.fixture(scope="module")
def knob_data(tmp_path_factory):
    """Raw 64 px train/val splits for the run-knob fits, and a donor fit
    for ``train.init_from``."""
    from jama16_retina_tpu_torch.data import tfrecord

    root = tmp_path_factory.mktemp("knobs")
    data = str(root / "data")
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        tfrecord.write_synthetic_split(data, split, n, 64, num_shards=2,
                                       seed=seed, encoding="raw")
    donor = str(root / "donor")
    with torch_threads(1):
        trainer.fit(configs.override(configs.get_config("smoke"), [
            "train.steps=2", "train.eval_every=2"]), data, donor,
            device="cpu")
    return data, donor


@pytest.mark.parametrize("item", [
    "train.dtype=bf16", "train.accum_steps=2", "train.async_save=true",
    "train.eval_overlap=true", "train.init_from=DONOR"])
def test_fit_trains_with_each_run_knob(item, knob_data, tmp_path):
    """The five knobs refused until they were ported (item 6, and the
    warm start of item 5): a 4-step ``fit`` on the CPU with each one
    writes its eval records and checkpoints, with float32 masters and
    moments in the saved state. Their parity with the reference is held
    in ``tests/test_torch_trainknobs.py``."""
    data, donor = knob_data
    cfg = configs.override(configs.get_config("smoke"), [
        item.replace("DONOR", donor), "train.steps=4", "train.eval_every=2",
        "train.log_every=2"])
    with torch_threads(1):
        res = trainer.fit(cfg, data, str(tmp_path), device="cpu")
    recs = [json.loads(line) for line in
            (tmp_path / trainer.METRICS_FILE).read_text().splitlines()]
    assert sorted(r["step"] for r in recs if r["kind"] == "eval") == [2, 4]
    assert res["best_auc"] is not None and res["best_step"] in (2, 4)
    warm = [r for r in recs if r["kind"] == "warm_start"]
    assert warm == ([] if "DONOR" not in item else [
        {"kind": "warm_start", "t": warm[0]["t"], "init_from": donor}])
    saved = ckpt_lib.Checkpointer(str(tmp_path)).restore(4)
    assert int(saved["step"]) == 4
    assert all(v.dtype == np.float32 for k, v in saved.items()
               if k.startswith(("params/", "adam/mu/", "adam/nu/")))


@pytest.mark.parametrize("item", [
    "train.ensemble_manual_data=true", "parallel.member_axis_size=2",
    "data.loader=served", "parallel.serve_devices=2"])
def test_unported_reference_fields_name_their_roadmap_item(item):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.check_supported(
            configs.override(configs.get_config("smoke"), [item]),
            training=True)


def test_serving_ignores_train_knobs():
    cfg = configs.override(configs.get_config("smoke"),
                           ["train.distill_from=/x", "train.dtype=bf16",
                            "train.ensemble_size=2"])
    configs.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="fit_ensemble"):
        configs.check_supported(cfg, training=True)


def test_presets_take_the_jax_values():
    """Every preset of the JAX package, field for field (the ``serve``
    section and the port's own fields, ``configs.PORT_FIELDS``, aside);
    the trainable ones pass
    ``check_supported``, and ``ensemble10`` is refused by one ``fit``
    (``fit_ensemble`` trains its members in turn)."""
    assert set(configs.PRESETS) == set(jax_configs.PRESETS)
    for name in ("icdr5", "resnet50", "efficientnet_b4", "messidor2_eval",
                 "eyepacs_binary", "eyepacs_binary_quality", "smoke"):
        configs.check_supported(configs.get_config(name), training=True)
    with pytest.raises(NotImplementedError, match="fit_ensemble"):
        configs.check_supported(configs.get_config("ensemble10"),
                                training=True)
    for name in configs.PRESETS:
        jcfg, cfg = jax_configs.get_config(name), configs.get_config(name)
        for section in ("model", "data", "train", "eval"):
            ours = getattr(cfg, section)
            for f in dataclasses.fields(ours):
                if (section, f.name) in configs.PORT_FIELDS:
                    continue
                assert getattr(ours, f.name) == getattr(
                    getattr(jcfg, section), f.name), (name, section, f.name)


def test_train_cli_on_cpu_writes_metrics_and_a_servable_member(
        tmp_path, capsys):
    from jama16_retina_tpu_torch import train

    wd = tmp_path / "run"
    assert train.main(["--config=smoke", "--synthetic=16", "--device=cpu",
                       f"--workdir={wd}", "--set", "train.steps=3",
                       "--set", "train.log_every=1"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["config"] == "smoke" and last["results"]["steps"] == 3
    recs = [json.loads(line) for line in
            (wd / trainer.METRICS_FILE).read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(set(r) == {"kind", "t", "step", "loss"}
               and r["kind"] == "train" and np.isfinite(r["loss"])
               for r in recs)
    engine = ServingEngine(configs.get_config("smoke"), [str(wd)],
                           device="cpu")
    images, _ = synthetic.make_dataset(3, synthetic.SynthConfig(
        image_size=64), seed=5)
    probs = engine.probs(images)
    assert probs.shape == (3,) and np.all((probs >= 0) & (probs <= 1))
    # --data_dir with --synthetic writes raw splits there, trains on them
    # with evals on val, and writes best/ and latest/.
    data, ck = tmp_path / "data", tmp_path / "ck"
    assert train.main(["--config=smoke", "--synthetic=12", "--device=cpu",
                       f"--data_dir={data}", f"--workdir={ck}", "--set",
                       "train.steps=4", "--set", "train.eval_every=2"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["results"]["best_step"] in (2, 4)
    assert 0.0 <= last["results"]["best_auc"] <= 1.0
    assert sorted(os.listdir(data)) == sorted(
        f"{s}-0000{i}-of-00004.tfrecord" for s in ("test", "train", "val")
        for i in range(4))
    evals = [json.loads(line) for line in
             (ck / trainer.METRICS_FILE).read_text().splitlines()
             if json.loads(line)["kind"] == "eval"]
    assert [r["step"] for r in evals] == [2, 4]
    assert os.listdir(ck / "latest") == ["4"] and os.listdir(ck / "best")
    assert ServingEngine(configs.get_config("smoke"), [str(ck)],
                         device="cpu").probs(images).shape == (3,)


def test_ensemble10_trains_its_members_in_turn_through_the_cli(
        tmp_path, capsys):
    """``--config=ensemble10`` (cut to ``tiny_cnn`` at 64 px and one step
    a member): ``trainer.fit_ensemble`` trains the 10 members one after
    another into ``member_00``..``member_09`` with seeds 0..9; one
    ``fit`` of the preset raises."""
    from jama16_retina_tpu_torch import train

    data, ck = tmp_path / "data", tmp_path / "ck"
    sets = ["model.arch=tiny_cnn", "model.image_size=64",
            "model.aux_head=false", "train.steps=1", "train.eval_every=1",
            "data.batch_size=4", "eval.batch_size=8"]
    args = ["--config=ensemble10", "--synthetic=8", "--device=cpu",
            f"--data_dir={data}", f"--workdir={ck}"]
    for item in sets:
        args += ["--set", item]
    with torch_threads(1):
        assert train.main(args) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["config"] == "ensemble10"
    assert [r["member"] for r in last["results"]] == list(range(10))
    assert sorted(os.listdir(ck)) == [f"member_{m:02d}" for m in range(10)]
    for m in range(10):
        with open(ck / f"member_{m:02d}" / "run_meta.json") as f:
            assert json.load(f)["seed"] == m
    cfg = configs.override(configs.get_config("ensemble10"), sets)
    with pytest.raises(NotImplementedError, match="fit_ensemble"):
        trainer.fit(cfg, str(data), str(tmp_path / "one"), device="cpu")


def test_train_cli_defaults_to_the_card_and_raises_without_one(
        tmp_path, monkeypatch):
    from jama16_retina_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config=smoke", "--synthetic=4",
                    f"--workdir={tmp_path}"])
