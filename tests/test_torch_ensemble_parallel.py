"""Member-parallel ensemble training (``train_lib.EnsembleState`` /
``ensemble_train_step`` / ``make_ensemble_eval_step`` and
``trainer.fit_ensemble_parallel``) against the JAX package's
``make_ensemble_train_step`` and against the port's members stepped in
turn, on the CPU at ``tiny_cnn`` size (the counterpart of
``tests/test_ensemble_parallel.py``). Tolerances are stated at each test
with what was measured."""

import dataclasses
import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import augment as jax_augment
from jama16_retina_tpu_torch import configs, models, train_lib, trainer
from jama16_retina_tpu_torch.data import synthetic, tfrecord
from jama16_retina_tpu_torch.models import convert, init
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import (flat_optax_state, one_torch_thread,  # noqa: F401
                          random_flat, variables)


def _batch(n: int = 8, seed: int = 3):
    images, grades = synthetic.make_dataset(
        n, synthetic.SynthConfig(image_size=64), seed=seed)
    return images, grades, {"image": torch.from_numpy(images),
                            "grade": torch.from_numpy(grades)}


def _flat_model(state: train_lib.TrainState) -> dict:
    return convert.torch_to_flax(state.model)


@pytest.mark.parametrize("family,clip", [("adamw", 0.0), ("lamb", 1.0),
                                         ("sgdm", 1.0)])
def test_stacked_step_matches_jax_make_ensemble_train_step(family, clip):
    """k=2 ``tiny_cnn`` members (float32, dropout 0, B1's plain version)
    stepped 3 times by ``ensemble_train_step`` with each member's JAX
    augment draws against ``make_ensemble_train_step`` (no mesh) and
    against the port's single-model ``train_step`` on the same member
    and draws.

    The stacking's own error, against the single step: losses within
    1e-5 (measured 1.2e-7), each member's params and batch statistics
    within 1e-5 relative L2 over the tree (measured 1.6e-7), its
    optimizer state within 1e-4 (measured 6.5e-6). Against JAX, the
    stacked member may be at most 1e-5 farther than the single step is,
    in every loss and in the tree, and the counts are equal. The single
    step's own distance from JAX is held within 1e-4 in the loss and
    1e-3 in the tree: member 0 stays within 1e-6 in both, but member 1's
    weights and draws make the float32 train gradient ill-conditioned
    (ROADMAP Queue C): measured 1.4e-5 in adamw's step-3 loss and 1.4e-4
    in its tree (Adam's first update is ``lr * sign(g)``), 2.0e-5 in
    LAMB's tree, and 2.4e-3 in sgdm's momentum trace, equally for the
    stacked and the single form. The clip's global norm and LAMB's trust
    ratios are per member: pooled over both members they would move
    every leaf."""
    sets = ["model.compute_dtype=float32", "model.dropout_rate=0.0",
            "train.steps=10", "train.lr_schedule=warmup_cosine",
            "train.weight_decay=0.01", "data.use_pallas=true",
            f"train.optimizer={family}", f"train.gradient_clip_norm={clip}",
            "train.ensemble_size=2", "train.ensemble_parallel=true"]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), sets)
    cfg = configs.override(configs.get_config("smoke"), sets)
    jmodel = jax_models.build(jcfg.model)
    seeds = [0, 1]
    flats = [random_flat(jmodel, (2, 64, 64, 3), seed=12 + m)
             for m in seeds]
    tx = jax_train_lib.make_optimizer(jcfg.train)
    members = []
    for flat in flats:
        v = variables(flat)
        members.append(jax_train_lib.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"])))
    jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    jstep = jax_train_lib.make_ensemble_train_step(jcfg, jmodel, tx,
                                                   donate=False)
    keys = jax_train_lib.stack_member_keys(seeds)

    def port_state(flat):
        model = models.build(cfg.model)
        model.load_state_dict(convert.flax_to_torch(flat, model))
        return train_lib.create_state(cfg, model, "cpu")

    state = train_lib.stack_states([port_state(f) for f in flats], seeds,
                                   "cpu")
    singles = [port_state(f) for f in flats]
    single_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, ensemble_size=1, ensemble_parallel=False))
    images, grades, batch = _batch()
    jbatch = {"image": jnp.asarray(images), "grade": jnp.asarray(grades)}
    for s in range(3):
        drawn = []
        for m in seeds:
            aug_key, _ = jax.random.split(jax.random.fold_in(keys[m], s))
            d = jax_augment._draw_params(aug_key, 8, jcfg.data)
            drawn.append({k: torch.from_numpy(np.array(a))
                          for k, a in d.items()})
        jstate, out = jstep(jstate, jbatch, keys)
        losses = train_lib.ensemble_train_step(state, batch, cfg,
                                               augment_params=drawn)
        assert losses.shape == (2,)
        for m, single in enumerate(singles):
            loss = float(train_lib.train_step(single, batch, single_cfg,
                                              augment_params=drawn[m]))
            want_loss = float(out["loss"][m])
            assert abs(loss - float(losses[m])) <= 1e-5, (s, m)
            assert abs(float(losses[m]) - want_loss) <= (
                abs(loss - want_loss) + 1e-5), (s, m)
            assert abs(loss - want_loss) <= 1e-4, (s, m)
    assert state.step == 3
    for m in seeds:
        member = train_lib.unstack_member(state, m)
        jm = jax_train_lib.unstack_member(jstate, m)
        want = {**{"params/" + k: np.asarray(a) for k, a in
                   _flatten(jm.params).items()},
                **{"batch_stats/" + k: np.asarray(a) for k, a in
                   _flatten(jm.batch_stats).items()}}
        got = _flat_model(member)
        assert set(got) == set(want)
        single = _flat_model(singles[m])
        assert _rel_l2(got, single, sorted(want)) <= 1e-5, m
        single_gap = _rel_l2(single, want, sorted(want))
        assert _rel_l2(got, want, sorted(want)) <= single_gap + 1e-5, m
        assert single_gap <= 1e-3, m
        got_opt, single_opt = (convert.port_to_optax(
            family, train_lib.moments(st),
            None if st.count is None else int(st.count),
            int(st.sched_count)) for st in (member, singles[m]))
        want_opt = flat_optax_state(jm.opt_state, family)
        assert set(got_opt) == set(want_opt)
        counts = [k for k in want_opt if k.endswith("count")]
        for k in counts:
            assert int(got_opt[k]) == int(want_opt[k]) == 3, k
        leaves = sorted(set(want_opt) - set(counts))
        assert _rel_l2(got_opt, single_opt, leaves) <= 1e-4, m


def _rel_l2(got: dict, want: dict, keys) -> float:
    """||got - want|| / ||want|| over the leaves ``keys`` together."""
    diff = sum(np.sum(np.square(got[k].astype(np.float64) - want[k]))
               for k in keys)
    norm = sum(np.sum(np.square(np.asarray(want[k], np.float64)))
               for k in keys)
    return float(np.sqrt(diff / norm))


def _flatten(tree) -> dict:
    from flax.traverse_util import flatten_dict

    return flatten_dict(tree, sep="/")


@pytest.mark.parametrize("items", [
    ("train.optimizer=adamw", "train.ema_decay=0.9"),
    ("train.optimizer=rmsprop", "train.gradient_clip_norm=0.5"),
    ("train.optimizer=lamb", "train.accum_steps=2"),
    ("train.optimizer=sgdm", "train.dtype=bf16"),
])
def test_stacked_step_matches_members_stepped_in_turn(items):
    """k=3 members (the smoke preset: dropout 0.2, B1's plain version)
    stepped 3 times stacked against each member stepped in turn by
    ``train_step`` with its own seed: the same draws (augment, and
    dropout through ``models.common.Draws``), so the losses within 1e-5
    (measured 1.2e-7) and every param, statistic and EMA leaf within
    1e-4 absolute (measured 1.9e-5, adamw) after the third step;
    float-equivalent, not bitwise (the stacked convolutions are grouped
    convolutions). The EMA shadow and counts follow."""
    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "data.use_pallas=true",
        "train.steps=10", "train.weight_decay=0.01", *items])
    seeds = [4, 5, 6]
    state = train_lib.create_ensemble_state(cfg, seeds, "cpu")
    singles = [train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model), s),
        "cpu") for s in seeds]
    _, _, batch = _batch()
    for _ in range(3):
        losses = train_lib.ensemble_train_step(state, batch, cfg)
        for m, single in enumerate(singles):
            mcfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                         seed=seeds[m]))
            loss = train_lib.train_step(single, batch, mcfg)
            assert abs(float(loss) - float(losses[m])) <= 1e-5, m
    for m, single in enumerate(singles):
        got = train_lib.state_to_flat(train_lib.unstack_member(state, m))
        want = train_lib.state_to_flat(single)
        assert set(got) == set(want)
        assert int(got["step"]) == 3 and int(got["schedule/count"]) == 3
        for k in want:
            if k.startswith(("params/", "batch_stats/", "ema/")):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-4, err_msg=k)


@pytest.mark.parametrize("head", ["binary", "multi"])
def test_ensemble_eval_step_matches_single_eval(head):
    """One vmapped eval of k=2 members against each member's own
    ``make_eval_step``: within rtol 2e-5, atol 1e-6 (the reference's own
    bound; measured 6e-8), [k, B] or [k, B, 5]."""
    cfg = configs.override(configs.get_config("smoke"),
                           [f"model.head={head}"])
    state = train_lib.create_ensemble_state(cfg, [5, 6], "cpu")
    images, _, _ = _batch()
    probs = train_lib.make_ensemble_eval_step(cfg, state, "cpu")(images)
    assert probs.shape == ((2, 8) if head == "binary" else (2, 8, 5))
    for m in range(2):
        solo = train_lib.make_eval_step(
            cfg, train_lib.unstack_member(state, m), "cpu")(images)
        np.testing.assert_allclose(probs[m], solo, rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ens") / "data")
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        tfrecord.write_synthetic_split(d, split, n, 64, num_shards=2,
                                       seed=seed, encoding="raw")
    return d


def _cfg(*items):
    return configs.override(configs.get_config("smoke"), [
        "train.ensemble_size=2", "train.ensemble_parallel=true",
        "train.ensemble_parallel_force=true", "train.lr_schedule=constant",
        "train.steps=4", "train.eval_every=2", "train.log_every=2", *items])


def _records(workdir, kind):
    return [r for r in read_jsonl(os.path.join(workdir,
                                               trainer.METRICS_FILE))
            if r["kind"] == kind]


def _saved(workdir, m, step):
    return ckpt_lib.Checkpointer(
        ckpt_lib.member_dir(workdir, m)).restore(step)


def _same_checkpoints(a, b, step):
    for m in range(2):
        x, y = _saved(a, m, step), _saved(b, m, step)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=(m, k))


@pytest.mark.parametrize("items", [(), ("train.async_save=true",),
                                   ("train.eval_overlap=true",)])
def test_fit_ensemble_parallel_end_to_end(data_dir, tmp_path, items):
    """``fit_ensemble`` with the force routes to the stacked driver: the
    sequential layout (``member_NN/{best,latest}``, each member's
    ``run_meta.json`` pinning seed + m), eval records with
    ``val_auc_per_member`` and ``ensemble_val_auc``, train records with
    ``loss_per_member``, and ``evaluate_checkpoints`` scores the members
    as it scores a sequential ensemble. Async saves and overlapped evals
    give the same eval records and bitwise the same checkpoints."""
    wd = str(tmp_path / "run")
    res = trainer.fit_ensemble(_cfg(*items), data_dir, wd, device="cpu")
    assert [r["member"] for r in res] == [0, 1]
    assert all(r["best_step"] in (2, 4) for r in res)
    # telemetry.prom: the run's Snapshotter, as the reference's writes.
    assert sorted(os.listdir(wd)) == [".member_parallel", "member_00",
                                      "member_01", trainer.METRICS_FILE,
                                      "telemetry.prom"]
    for m in range(2):
        mdir = ckpt_lib.member_dir(wd, m)
        with open(os.path.join(mdir, "run_meta.json")) as f:
            assert json.load(f)["seed"] == m
        assert os.listdir(os.path.join(mdir, "latest")) == ["4"]
        assert os.listdir(os.path.join(mdir, "best"))
    evals = _records(wd, "eval")
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        assert len(r["val_auc_per_member"]) == 2
        assert 0.0 <= r["ensemble_val_auc"] <= 1.0
    trains = _records(wd, "train")
    assert [len(r["loss_per_member"]) for r in trains] == [2, 2]
    report = trainer.evaluate_checkpoints(
        _cfg(), data_dir, ckpt_lib.discover_member_dirs(wd), split="val",
        device="cpu")
    assert report["n_models"] == 2 and 0.0 <= report["auc"] <= 1.0
    if items:
        base = str(tmp_path / "base")
        trainer.fit_ensemble(_cfg(), data_dir, base, device="cpu")
        assert [(r["step"], r["val_auc_per_member"]) for r in evals] == [
            (r["step"], r["val_auc_per_member"])
            for r in _records(base, "eval")]
        _same_checkpoints(wd, base, 4)


def test_resume_matches_an_uninterrupted_run(data_dir, tmp_path):
    """2 steps, then ``train.resume`` to 4: a ``resume`` record at 2, the
    eval replay intact, and every member's step-4 checkpoint bitwise the
    uninterrupted run's."""
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    trainer.fit_ensemble(_cfg(), data_dir, full, device="cpu")
    trainer.fit_ensemble(_cfg("train.steps=2"), data_dir, cut, device="cpu")
    trainer.fit_ensemble(_cfg("train.resume=true"), data_dir, cut,
                         device="cpu")
    assert [r["step"] for r in _records(cut, "resume")] == [2]
    assert [r["val_auc_per_member"] for r in _records(cut, "eval")] == [
        r["val_auc_per_member"] for r in _records(full, "eval")]
    _same_checkpoints(full, cut, 4)


def test_resume_recovers_from_a_torn_save(data_dir, tmp_path, caplog):
    """Member 1 misses the step-4 save (a crash between the members'
    saves): resume rolls both back to 2, the newest step both hold,
    deletes member 0's step 4, and ends bitwise where the uninterrupted
    run ended. Members at different steps in a workdir without the
    member-parallel marker (a sequential ensemble's) are refused."""
    full, torn = str(tmp_path / "full"), str(tmp_path / "torn")
    trainer.fit_ensemble(_cfg(), data_dir, full, device="cpu")
    trainer.fit_ensemble(_cfg(), data_dir, torn, device="cpu")
    m1 = ckpt_lib.member_dir(torn, 1)
    for sub in ("best", "latest"):
        shutil.rmtree(os.path.join(m1, sub, "4"), ignore_errors=True)
    seq = str(tmp_path / "seq")
    shutil.copytree(torn, seq)
    os.remove(os.path.join(seq, trainer.MEMBER_PARALLEL_MARKER))
    with caplog.at_level(logging.WARNING, logger=trainer.__name__):
        trainer.fit_ensemble(_cfg("train.resume=true"), data_dir, torn,
                             device="cpu")
    assert "rolling back to the newest common step 2" in caplog.text
    assert [r["step"] for r in _records(torn, "resume")] == [2]
    _same_checkpoints(full, torn, 4)
    with pytest.raises(ValueError, match="not a member-parallel workdir"):
        trainer.fit_ensemble(_cfg("train.resume=true"), data_dir, seq,
                             device="cpu")


def test_refusals(data_dir, tmp_path):
    """A workdir whose member pins a foreign seed, ``train.init_from``
    and ``train.use_pallas_fused`` are refused before any training, as
    the reference refuses them."""
    wd = str(tmp_path / "ck")
    mdir = ckpt_lib.member_dir(wd, 1)
    os.makedirs(mdir)
    with open(os.path.join(mdir, "run_meta.json"), "w") as f:
        json.dump({"seed": 999, "config": "smoke"}, f)
    with pytest.raises(ValueError, match="differently seeded"):
        trainer.fit_ensemble(_cfg("train.resume=true"), data_dir, wd,
                             device="cpu")
    with pytest.raises(ValueError, match="diversity collapse"):
        trainer.fit_ensemble(_cfg("train.init_from=/x"), data_dir,
                             str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="single-model step path"):
        trainer.fit_ensemble(_cfg("train.use_pallas_fused=true"), data_dir,
                             str(tmp_path / "b"), device="cpu")
    with pytest.raises(ValueError, match="single-model step path"):
        train_lib.create_ensemble_state(
            _cfg("train.use_pallas_fused=true"), [0, 1], "cpu")
    assert not os.path.exists(tmp_path / "a" / trainer.METRICS_FILE)


def test_one_device_trains_members_in_turn_without_the_force(
        data_dir, tmp_path, caplog):
    """``train.ensemble_parallel`` without ``ensemble_parallel_force``
    on one device logs the reason and trains the members one after
    another (each member's own ``metrics.jsonl``, no marker), as the
    reference does on a one-device mesh."""
    wd = str(tmp_path / "run")
    with caplog.at_level(logging.WARNING, logger=trainer.__name__):
        res = trainer.fit_ensemble(
            _cfg("train.ensemble_parallel_force=false", "train.steps=2"),
            data_dir, wd, device="cpu")
    assert "train.ensemble_parallel disabled" in caplog.text
    assert [r["member"] for r in res] == [0, 1]
    assert not os.path.exists(os.path.join(wd, trainer.MEMBER_PARALLEL_MARKER))
    for m in range(2):
        assert os.path.exists(os.path.join(ckpt_lib.member_dir(wd, m),
                                           trainer.METRICS_FILE))


def test_member_best_tracking_replay_matches_the_reference(tmp_path):
    """Resume's per-member replay of ``val_auc_per_member`` (first record
    per step, none past the restored step) against the JAX package's."""
    with open(tmp_path / trainer.METRICS_FILE, "w") as f:
        for step, aucs in ((10, [0.6, 0.5]), (20, [0.605, 0.7]),
                           (20, [0.605, 0.7]), (30, [0.7, 0.69]),
                           (40, [0.69, 0.71]), (50, [0.9, 0.9])):
            f.write(json.dumps({"kind": "eval", "step": step,
                                "val_auc_per_member": aucs}) + "\n")
    cfg = configs.override(configs.get_config("smoke"),
                           ["train.min_delta=0.01"])
    jcfg = jax_configs.override(jax_configs.get_config("smoke"),
                                ["train.min_delta=0.01"])
    got = trainer._reconstruct_member_tracking(str(tmp_path), 40, cfg,
                                               [None, None])
    want = jax_trainer._reconstruct_best_tracking(str(tmp_path), 40, jcfg,
                                                  [None, None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [30, 20]
