"""Distillation in the port (``train.distill_from``) against the JAX
package on the CPU: the soft-target loss of both heads with and without
the aux head (1e-7), one train step's loss and gradient on a batch with
soft targets against ``make_train_step`` at accumulation 1 and 2, the
teacher's soft targets against ``trainer._distill_stream`` for the same
members exported to the port (1e-6), and the port's ``fit`` with a
teacher: its ``distill`` record and a resume bitwise the uninterrupted
run. Without a ``soft`` key the step is the hard-label step: soft targets
equal to the hard labels reproduce it bitwise. The member-parallel driver
refuses ``distill_from``, since the reference's stacked step never reads
it. Models run in float32 on the ``smoke`` preset's ``tiny_cnn`` at 64 px
(1 output, or 5 with the multi head)."""

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
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.parallel import mesh as jax_mesh
from jama16_retina_tpu.utils import checkpoint as jax_ckpt
from jama16_retina_tpu_torch import configs, models, train_lib, trainer
from jama16_retina_tpu_torch.data import pipeline, synthetic
from jama16_retina_tpu_torch.models import convert, init
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import flat_optax_state, random_flat, variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = ["model.image_size=64", "model.compute_dtype=float32"]


def _configs(*extra):
    sets = F32 + list(extra)
    return (jax_configs.override(jax_configs.get_config("smoke"), sets),
            configs.override(configs.get_config("smoke"), sets))


def _soft(rng, n, head):
    if head == "binary":
        return rng.uniform(0.0, 1.0, n).astype(np.float32)
    p = rng.uniform(0.1, 1.0, (n, 5))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("head", ["binary", "multi"])
def test_distill_loss_matches_the_jax_loss(head, aux):
    rng = np.random.default_rng(len(head) + aux)
    c = 5 if head == "multi" else 1
    logits, aux_logits = (rng.normal(0, 3, (16, c)).astype(np.float32)
                          for _ in range(2))
    soft = _soft(rng, 16, head)
    want = jax_train_lib._distill_loss(jnp.asarray(logits),
                                       jnp.asarray(soft), head)
    if aux:
        want = want + 0.4 * jax_train_lib._distill_loss(
            jnp.asarray(aux_logits), jnp.asarray(soft), head)
    _, cfg = _configs(f"model.head={head}")
    got = train_lib.loss_fn(
        torch.from_numpy(logits),
        torch.from_numpy(aux_logits) if aux else None,
        torch.zeros(16, dtype=torch.int64), cfg, torch.from_numpy(soft))
    assert abs(float(got) - float(want)) <= 1e-7


@pytest.mark.parametrize("head", ["binary", "multi"])
def test_soft_targets_equal_to_the_labels_are_the_hard_step(head):
    """The step with no soft key is the hard-label step, and soft
    targets equal to its labels (no smoothing) give it bitwise: loss,
    gradients and the BatchNorm statistics after the step."""
    _, cfg = _configs(f"model.head={head}", "train.label_smoothing=0.0")
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=4)
    batch = {"image": torch.from_numpy(images),
             "grade": torch.from_numpy(grades)}
    labels = train_lib._labels_from_grades(batch["grade"], head)
    soft = (labels if head == "binary"
            else torch.nn.functional.one_hot(labels, 5).float())
    runs = []
    for b in (batch, {**batch, "soft": soft}):
        state = train_lib.create_state(
            cfg, init.init_flax_default(models.build(cfg.model), 0),
            "cpu")
        loss, grads = train_lib.compute_grads(state, b, cfg)
        runs.append((loss, grads, state.model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def _jax_state(jcfg, flat):
    v = variables(flat)
    tx = jax_train_lib.make_optimizer(jcfg.train)
    return tx, jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_soft_step_matches_the_jax_step(accum):
    """One step on a batch with soft targets (dropout 0, augmentation
    off, learning rate 0, so the update leaves the params and the Adam
    moments hold the gradient) against ``make_train_step``: the loss
    within 1e-6, mu = 0.1 g within 1e-7 and nu within 1e-6; the
    BatchNorm statistics within test_torch_multihead's 2e-5 (the float32
    batch variance differs by up to 1.7e-6)."""
    sets = ("model.dropout_rate=0.0", "train.lr_schedule=constant",
            "train.learning_rate=0.0", "data.augment=false",
            f"train.accum_steps={accum}")
    jcfg, cfg = _configs(*sets)
    jmodel = jax_models.build(jcfg.model)
    flat = random_flat(jmodel, (2, 64, 64, 3), seed=23)
    tx, jstate = _jax_state(jcfg, flat)
    jstep = jax_train_lib.make_train_step(jcfg, jmodel, tx, donate=False)
    model = models.build(cfg.model)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    state = train_lib.create_state(cfg, model, "cpu")
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=5)
    soft = _soft(np.random.default_rng(6), 8, "binary")
    jstate, m = jstep(jstate, {"image": jnp.asarray(images),
                               "grade": jnp.asarray(grades),
                               "soft": jnp.asarray(soft)},
                      jax.random.key(0))
    loss = train_lib.train_step(state, {
        "image": torch.from_numpy(images), "grade": torch.from_numpy(grades),
        "soft": torch.from_numpy(soft)}, cfg)
    assert abs(float(loss) - float(m["loss"])) <= 1e-6
    opt = convert.port_to_optax("adamw", train_lib.moments(state),
                                int(state.count), int(state.sched_count))
    want = flat_optax_state(jstate.opt_state, "adamw")
    for k in want:
        tol = 1e-7 if "/mu/" in k else 1e-6
        np.testing.assert_allclose(opt[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    stats = {k: v for k, v in convert.torch_to_flax(state.model).items()
             if k.startswith("batch_stats/")}
    for k, v in stats.items():
        path = k.split("/")[1:]
        node = jstate.batch_stats
        for p in path:
            node = node[p]
        np.testing.assert_allclose(v, np.asarray(node), rtol=0, atol=2e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """k=2 JAX member checkpoints (seeded inits) exported to the port,
    raw TFRecord splits, and the JAX config: (jax root, port root, data
    dir, jcfg)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import export_torch_member
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("distill")
    jcfg, _ = _configs()
    model = jax_models.build(jcfg.model)
    for m in range(2):
        state, _ = jax_train_lib.create_state(jcfg, model,
                                              jax.random.key(70 + m))
        ck = jax_ckpt.Checkpointer(str(root / "jax" / f"member_{m:02d}"))
        ck.save(1, jax.device_get(state), {"val_auc": 0.5})
        ck.wait()
        ck.close()
    export_torch_member.export(jcfg, str(root / "jax"), str(root / "port"))
    data = str(root / "data")
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        jax_tfrecord.write_synthetic_split(data, split, n, 64, num_shards=2,
                                           seed=seed, encoding="raw")
    return str(root / "jax"), str(root / "port"), data, jcfg


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_teacher_soft_targets_match_the_jax_distill_stream(teacher, tta):
    jax_root, port_root, _, _ = teacher
    jcfg, cfg = _configs(f"eval.tta={tta}")
    jcfg = jax_configs.override(jcfg, [f"train.distill_from={jax_root}"])
    cfg = configs.override(cfg, [f"train.distill_from={port_root}"])
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=9)
    stream = jax_trainer._distill_stream(
        jcfg, jax_models.build(jcfg.model),
        iter([{"image": images, "grade": grades}]), jax_mesh.make_mesh(1))
    want = next(stream)["soft"]
    got = trainer._distill_teacher(cfg, torch.device("cpu"))(
        torch.from_numpy(images))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_fit_distills_and_resumes_bitwise(teacher, tmp_path, monkeypatch):
    _, port_root, data, _ = teacher
    _, cfg = _configs("train.steps=4", "train.eval_every=2",
                      "train.log_every=1", f"train.distill_from={port_root}")
    full = trainer.fit(cfg, data, str(tmp_path / "full"), device="cpu")
    recs = read_jsonl(str(tmp_path / "full" / "metrics.jsonl"))
    assert [r["distill_from"] for r in recs if r["kind"] == "distill"] == [
        port_root]
    hard = trainer.fit(configs.override(cfg, ["train.distill_from="]), data,
                       str(tmp_path / "hard"), device="cpu")
    losses = [[r["loss"] for r in read_jsonl(str(tmp_path / wd
                                                 / "metrics.jsonl"))
               if r["kind"] == "train"] for wd in ("full", "hard")]
    assert losses[0] != losses[1]
    del hard
    real = pipeline.train_batches

    def two_batches(*args, **kwargs):
        it = real(*args, **kwargs)
        yield next(it)
        yield next(it)
        raise KeyboardInterrupt("preempted")

    with monkeypatch.context() as m:
        # Dies fetching step 3's batch; the preemption save writes
        # latest/2.
        m.setattr(pipeline, "train_batches", two_batches)
        with pytest.raises(KeyboardInterrupt):
            trainer.fit(cfg, data, str(tmp_path / "cut"), device="cpu")
    assert ckpt_lib.Checkpointer(str(tmp_path / "cut")).latest_step == 2
    resumed = trainer.fit(configs.override(cfg, ["train.resume=true"]), data,
                          str(tmp_path / "cut"), device="cpu")
    assert resumed == full
    recs = read_jsonl(str(tmp_path / "cut" / "metrics.jsonl"))
    assert [r["kind"] for r in recs].count("distill") == 2
    a = ckpt_lib.Checkpointer(str(tmp_path / "full")).restore(4)
    b = ckpt_lib.Checkpointer(str(tmp_path / "cut")).restore(4)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_synthetic_distills(teacher, tmp_path):
    _, port_root, _, _ = teacher
    _, cfg = _configs("train.steps=2", "train.log_every=1",
                      "data.batch_size=4")
    runs = [trainer.fit_synthetic(
        configs.override(cfg, [f"train.distill_from={d}"]),
        str(tmp_path / str(i)), 8, device="cpu")
        for i, d in enumerate((port_root, ""))]
    assert runs[0]["logged_losses"] != runs[1]["logged_losses"]


def test_member_parallel_refuses_distill_from(teacher, tmp_path):
    _, port_root, data, _ = teacher
    _, cfg = _configs("train.ensemble_size=2", "train.ensemble_parallel=true",
                      "train.ensemble_parallel_force=true",
                      f"train.distill_from={port_root}")
    with pytest.raises(ValueError, match="distill_from"):
        trainer.fit_ensemble(cfg, data, str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)
