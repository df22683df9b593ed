"""The port's evaluate path against the JAX package's on the CPU: members
trained by the JAX ``trainer.fit_ensemble`` (``smoke`` preset, a few
steps, on raw splits the JAX writer made) are exported by
``scripts/export_torch_member.py`` and scored by the port's
``evaluate_checkpoints``; its probabilities must be within 1e-5 of the
JAX ``evaluate_checkpoints``' ``save_probs`` CSV (which rounds to 1e-6)
and its AUC and operating points within 1e-6, for one member and for the
k=2 average. Both sides evaluate in float32. The port's evaluate CLI
prints the same report as its last line."""

import csv
import json
import math
import os
import sys

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu_torch import configs, evaluate, trainer
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = ["model.compute_dtype=float32"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(data dir, JAX ensemble root, exported port root)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import export_torch_member
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("eval")
    data = str(root / "data")
    for split, n, seed in (("train", 16, 1), ("val", 12, 2), ("test", 14, 3)):
        jax_tfrecord.write_synthetic_split(data, split, n, 64, num_shards=3,
                                           seed=seed, encoding="raw")
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), [
        "train.steps=4", "train.eval_every=2", "train.ensemble_size=2",
        "train.ema_decay=0.5"])
    jax_trainer.fit_ensemble(jcfg, data, str(root / "jax"))
    written = export_torch_member.export(
        jax_configs.override(jcfg, F32), str(root / "jax"),
        str(root / "port"))
    assert [os.path.basename(d) for d in written] == ["member_00",
                                                      "member_01"]
    return data, str(root / "jax"), str(root / "port")


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _close(got, want, atol):
    """Nested reports equal in structure, numbers within ``atol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
    elif isinstance(want, float):
        assert (math.isinf(want) and got == want) or abs(got - want) <= atol
    else:
        assert got == want


@pytest.mark.parametrize("members", [["member_00"], ["member_00",
                                                     "member_01"]])
def test_port_scores_exported_jax_members_like_the_reference(
        exported, tmp_path, members):
    data, jax_root, port_root = exported
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), F32)
    cfg = configs.override(configs.get_config("smoke"), F32)
    want = jax_trainer.evaluate_checkpoints(
        jcfg, data, [os.path.join(jax_root, m) for m in members],
        threshold_split="val", save_probs=str(tmp_path / "jax.csv"))
    got = trainer.evaluate_checkpoints(
        cfg, data, [os.path.join(port_root, m) for m in members],
        threshold_split="val", save_probs=str(tmp_path / "port.csv"),
        device="cpu")
    want_rows, got_rows = _csv(tmp_path / "jax.csv"), _csv(
        tmp_path / "port.csv")
    assert [(r["name"], r["grade"], r["quality"]) for r in got_rows] == [
        (r["name"], r["grade"], r["quality"]) for r in want_rows]
    diff = max(abs(float(g["prob_referable"]) - float(w["prob_referable"]))
               for g, w in zip(got_rows, want_rows))
    assert diff <= 1e-5
    want["probs_file"] = got["probs_file"]
    _close(got, want, atol=1e-6)
    assert got["n_models"] == len(members) and got["n_examples"] == 14


def test_evaluate_cli_prints_the_report_last(exported, capsys):
    data, _, port_root = exported
    cfg = configs.override(configs.get_config("smoke"), F32)
    want = trainer.evaluate_checkpoints(
        cfg, data, ckpt_lib.discover_member_dirs(port_root), device="cpu")
    assert evaluate.main(["--config=smoke", "--set",
                          "model.compute_dtype=float32",
                          f"--data_dir={data}",
                          f"--checkpoint_dir={port_root}",
                          "--device=cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(want))
    assert want["n_models"] == 2


def test_evaluate_refuses_what_it_cannot_honour(exported):
    data, _, port_root = exported
    cfg = configs.get_config("smoke")
    dirs = [os.path.join(port_root, "member_00")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.evaluate_checkpoints(cfg, data, dirs, backend="tf",
                                     device="cpu")
    with pytest.raises(ValueError, match="threshold_split"):
        trainer.evaluate_checkpoints(cfg, data, dirs, calibrate=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="eval set itself"):
        trainer.evaluate_checkpoints(cfg, data, dirs, threshold_split="test",
                                     device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        trainer.evaluate_checkpoints(cfg, data, [], device="cpu")


@pytest.mark.parametrize("split", ["val", "test"])
def test_profile_out_gives_the_jax_profile(exported, tmp_path, split):
    """``evaluate_checkpoints(profile_out=)`` on the exported k=2 ensemble
    against the JAX ``evaluate_checkpoints`` on its checkpoints: the same
    score and input-statistic histograms, base rate, counts and meta,
    and thresholds within 1e-6 (the scores' agreement); the port's
    profile loads in the JAX package and the JAX one in the port."""
    from jama16_retina_tpu.obs import quality as jax_quality
    from jama16_retina_tpu_torch.obs import quality

    data, jax_root, port_root = exported
    members = ["member_00", "member_01"]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), F32)
    cfg = configs.override(configs.get_config("smoke"), F32)
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "p.json")
    jax_trainer.evaluate_checkpoints(
        jcfg, data, [os.path.join(jax_root, m) for m in members],
        split=split, profile_out=want_path)
    report = trainer.evaluate_checkpoints(
        cfg, data, [os.path.join(port_root, m) for m in members],
        split=split, profile_out=got_path, device="cpu")
    assert report["profile_out"] == got_path
    # Each package reads the other's artifact.
    want = quality.load_profile(want_path)
    got = jax_quality.load_profile(got_path)
    thresholds = got.pop("thresholds")
    want_thresholds = want.pop("thresholds")
    assert got == want
    assert len(thresholds) == 2
    _close(thresholds, want_thresholds, atol=1e-6)
    assert got["n_examples"] == {"val": 12, "test": 14}[split]
    assert sum(got["input_stats"]["std"]) == got["n_examples"]


def test_exported_member_is_the_jax_eval_tree(exported):
    """params.npz holds the EMA shadow (the run carried one) as params,
    beside the batch statistics, under the keys the port model reads."""
    _, jax_root, port_root = exported
    from jama16_retina_tpu import models as jax_models
    from jama16_retina_tpu import train_lib as jax_train_lib
    from flax.traverse_util import flatten_dict

    jcfg = jax_configs.get_config("smoke")
    state = jax_trainer.restore_for_eval(
        jcfg, jax_models.build(jcfg.model),
        os.path.join(jax_root, "member_01"))
    assert state.ema_params is not None
    flat = ckpt_lib.load_member(os.path.join(port_root, "member_01"))
    want = {f"params/{k}": v for k, v in flatten_dict(
        jax_train_lib.eval_params(state), sep="/").items()}
    want.update({f"batch_stats/{k}": v for k, v in flatten_dict(
        state.batch_stats, sep="/").items()})
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]), k)
    sd = trainer.restore_for_eval(configs.get_config("smoke"),
                                  os.path.join(port_root, "member_01"))
    assert len(sd) == len(flat)
