"""The port's ``trainer.fit`` against the JAX package's on the CPU, on raw
TFRecord splits written by the JAX writer (``smoke`` preset, tiny_cnn at
64 px): the early-stopping and save-cadence rules equal the reference's,
a fit logs the reference's records with its keys, early stopping fires at
the eval the rule names, a resumed run reproduces the uninterrupted one
exactly (the same eval records and bitwise parameters), the seed in
``run_meta.json`` wins on resume, and a changed ``train.ema_decay`` on
resume raises."""

import dataclasses
import json
import os

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu_torch import configs, trainer
from jama16_retina_tpu_torch.data import pipeline
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl

KINDS = ("config", "train", "eval", "early_stop", "resume")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("splits"))
    for split, n, seed in (("train", 20, 1), ("val", 10, 2), ("test", 10, 3)):
        jax_tfrecord.write_synthetic_split(root, split, n, 64, num_shards=3,
                                           seed=seed, encoding="raw")
    return root


def _cfg(*items):
    return configs.override(configs.get_config("smoke"), [
        "train.steps=6", "train.eval_every=2", "train.log_every=2", *items])


def _records(workdir, kinds=KINDS):
    return [r for r in read_jsonl(os.path.join(workdir, "metrics.jsonl"))
            if r["kind"] in kinds]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_best_tracking_update_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    aucs = np.round(rng.uniform(0.5, 0.9, 12), 2)  # ties included
    got = want = (-np.inf, 0, 0)
    for i, auc in enumerate(aucs):
        for min_delta in (0.0, 0.02):
            g = trainer._best_tracking_update(auc, *got, i + 1, min_delta)
            w = jax_trainer._best_tracking_update(auc, *want, i + 1,
                                                  min_delta)
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        got, want = g, w


class _Best:
    """A checkpointer stand-in that only knows its best (step, AUC)."""

    def __init__(self, info):
        self.info = info

    def best_info(self):
        return self.info


@pytest.mark.parametrize("history", [True, False])
def test_best_tracking_replay_matches_the_reference(tmp_path, history):
    """Resume's replay of metrics.jsonl (first record per step, none past
    the restored step), and without a history the best checkpoint's
    (step, AUC) with patience from the eval cadence."""
    cfg = _cfg("train.min_delta=0.01", "train.eval_every=10")
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), [
        "train.min_delta=0.01", "train.eval_every=10"])
    if history:
        with open(tmp_path / "metrics.jsonl", "w") as f:
            for step, auc in ((10, 0.6), (20, 0.605), (20, 0.605),
                              (30, 0.7), (40, 0.69), (50, 0.9)):
                f.write(json.dumps({"kind": "eval", "step": step,
                                    "val_auc": auc}) + "\n")
            f.write("{torn\n")
    got = trainer._reconstruct_best_tracking(str(tmp_path), 40, cfg,
                                             _Best((20, 0.65)))
    want = jax_trainer._reconstruct_best_tracking(str(tmp_path), 40, jcfg,
                                                  [_Best((20, 0.65))])
    assert got == (float(want[0][0]), int(want[1][0]), int(want[2][0]))
    assert got == ((0.7, 30, 1) if history else (0.65, 20, 2))


@pytest.mark.parametrize("every,first", [(1, True), (2, True), (3, False),
                                         (3, True)])
def test_save_due_matches_the_reference(every, first):
    items = [f"train.save_every_evals={every}",
             f"train.save_first_eval={str(first).lower()}",
             "train.steps=23", "train.eval_every=3"]
    cfg = configs.override(configs.get_config("smoke"), items)
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), items)
    for step in range(3, 26):
        assert trainer._save_due(cfg, step) == jax_trainer._save_due(
            jcfg, step), step


def test_fit_logs_the_reference_records_and_stops_early(data_dir, tmp_path):
    """Patience 1 and min_delta 1: the first eval (step 2) sets the best,
    the second (step 4) cannot beat it by 1 and stops the run, in both
    packages."""
    items = ["train.steps=8", "train.eval_every=2", "train.log_every=2",
             "train.early_stop_patience=1", "train.min_delta=1.0"]
    jres = jax_trainer.fit(
        jax_configs.override(jax_configs.get_config("smoke"), items),
        data_dir, str(tmp_path / "jax"))
    res = trainer.fit(configs.override(configs.get_config("smoke"), items),
                      data_dir, str(tmp_path / "port"), device="cpu")
    assert set(res) == set(jres) == {"best_auc", "best_step",
                                     "stopped_early"}
    assert res["stopped_early"] and jres["stopped_early"]
    assert res["best_step"] == jres["best_step"] == 2
    want, got = _records(str(tmp_path / "jax")), _records(
        str(tmp_path / "port"))
    assert [(r["kind"], r.get("step")) for r in got] == [
        (r["kind"], r.get("step")) for r in want] == [
        ("config", None), ("train", 2), ("eval", 2), ("train", 4),
        ("eval", 4), ("early_stop", 4)]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["kind"]
    assert got[-1]["best_step"] == 2
    ck = ckpt_lib.Checkpointer(str(tmp_path / "port"))
    # The first eval and the stopping eval saved.
    assert ck.latest_step == 4 and ck.all_steps() == {2, 4}
    with open(tmp_path / "port" / "run_meta.json") as f:
        assert json.load(f) == {"seed": 0, "config": "smoke"}


@pytest.mark.parametrize("patience,stop_step", [(2, 6), (3, None)])
def test_early_stop_fires_at_the_eval_the_rule_names(data_dir, tmp_path,
                                                     patience, stop_step):
    cfg = _cfg(f"train.early_stop_patience={patience}", "train.min_delta=1")
    res = trainer.fit(cfg, data_dir, str(tmp_path), device="cpu")
    stops = _records(str(tmp_path), ("early_stop",))
    assert res["stopped_early"] == (stop_step is not None)
    assert [r["step"] for r in stops] == ([stop_step] if stop_step else [])
    evals = _records(str(tmp_path), ("eval",))
    assert [r["since_best"] for r in evals] == list(range(len(evals)))


def _interrupt_after(monkeypatch, n_batches):
    real = pipeline.train_batches

    def stream(*args, **kwargs):
        it = real(*args, **kwargs)
        for _ in range(n_batches):
            yield next(it)
        raise KeyboardInterrupt("preempted")

    monkeypatch.setattr(pipeline, "train_batches", stream)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_resume_reproduces_the_uninterrupted_run(data_dir, tmp_path,
                                                 monkeypatch, ema):
    cfg = _cfg(f"train.ema_decay={ema}")
    full = trainer.fit(cfg, data_dir, str(tmp_path / "full"), device="cpu")
    with monkeypatch.context() as m:
        # Dies fetching step 6's batch, after the eval at 4 and step 5;
        # the preemption save writes latest/ at step 5.
        _interrupt_after(m, 5)
        with pytest.raises(KeyboardInterrupt):
            trainer.fit(cfg, data_dir, str(tmp_path / "cut"), device="cpu")
    assert ckpt_lib.Checkpointer(str(tmp_path / "cut")).latest_step == 5
    assert [(r["step"], r["saved"]) for r in read_jsonl(
        os.path.join(tmp_path / "cut", "metrics.jsonl"))
        if r["kind"] == "preempt_save"] == [(5, True)]
    resumed = trainer.fit(configs.override(cfg, ["train.resume=true"]),
                          data_dir, str(tmp_path / "cut"), device="cpu")
    assert resumed == full
    (res,) = _records(str(tmp_path / "cut"), ("resume",))
    at4 = [r for r in _records(str(tmp_path / "full"), ("eval",))
           if r["step"] == 4][0]
    assert (res["step"], res["best_auc"], res["since_best"]) == (
        5, at4["best_auc"], at4["since_best"])

    def evals(wd):
        return [{k: r[k] for k in ("step", "val_auc", "best_auc",
                                   "since_best")}
                for r in _records(wd, ("eval",))]

    assert evals(str(tmp_path / "cut")) == evals(str(tmp_path / "full"))
    losses = {r["step"]: r["loss"] for r in _records(str(tmp_path / "cut"),
                                                     ("train",))}
    assert losses == {r["step"]: r["loss"] for r in _records(
        str(tmp_path / "full"), ("train",))}
    a = ckpt_lib.Checkpointer(str(tmp_path / "full")).restore(6)
    b = ckpt_lib.Checkpointer(str(tmp_path / "cut")).restore(6)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_meta_seed_wins_on_resume(data_dir, tmp_path):
    wd = str(tmp_path)
    trainer.fit(_cfg("train.steps=2", "train.seed=3"), data_dir, wd,
                device="cpu")
    trainer.fit(_cfg("train.steps=4", "train.seed=7", "train.resume=true"),
                data_dir, wd, device="cpu")
    configs_logged = _records(wd, ("config",))
    assert [r["seed"] for r in configs_logged] == [3, 3]
    # A fresh (not resumed) run in the same workdir takes its own seed and
    # rotates the old log away.
    trainer.fit(_cfg("train.steps=2", "train.seed=7"), data_dir, wd,
                device="cpu")
    assert [r["seed"] for r in _records(wd, ("config",))] == [7]
    assert os.path.exists(os.path.join(wd, "metrics.jsonl.prev"))


def test_ema_mismatch_on_resume_raises(data_dir, tmp_path):
    trainer.fit(_cfg("train.steps=2"), data_dir, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="ema"):
        trainer.fit(_cfg("train.steps=4", "train.ema_decay=0.9",
                         "train.resume=true"),
                    data_dir, str(tmp_path), device="cpu")


def test_fit_ensemble_trains_seeded_members(data_dir, tmp_path):
    cfg = _cfg("train.steps=2", "train.ensemble_size=2", "train.seed=5")
    res = trainer.fit_ensemble(cfg, data_dir, str(tmp_path), device="cpu")
    assert [r["member"] for r in res] == [0, 1]
    dirs = ckpt_lib.discover_member_dirs(str(tmp_path))
    assert [os.path.basename(d) for d in dirs] == ["member_00", "member_01"]
    seeds = [json.load(open(os.path.join(d, "run_meta.json")))["seed"]
             for d in dirs]
    assert seeds == [5, 6]
    a, b = (ckpt_lib.load_member(d) for d in dirs)
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_unported_loader_raises_before_training(data_dir, tmp_path):
    cfg = dataclasses.replace(
        _cfg(), data=dataclasses.replace(_cfg().data, loader="served"))
    with pytest.raises(NotImplementedError, match="Queue A item 11, part 5"):
        trainer.fit(cfg, data_dir, str(tmp_path), device="cpu")
    assert not os.path.exists(tmp_path / "metrics.jsonl")
