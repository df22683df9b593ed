"""The port's ``Checkpointer`` and train-state flattening on the CPU: a
saved state restores bitwise (with and without the EMA shadow), ``best/``
keeps the top ``max_to_keep`` steps by val AUC and ``latest/`` only the
newest step, with the reference ``Checkpointer``'s meanings for
``best_step``, ``best_info``, ``latest_step``, ``all_steps``,
``delete_newer_than``, ``save_latest`` and ``saved_with_ema``; a leftover
temporary directory is ignored."""

import json
import os

import numpy as np
import pytest
import torch

from jama16_retina_tpu_torch import configs, models, train_lib
from jama16_retina_tpu_torch.data import synthetic
from jama16_retina_tpu_torch.models import convert, init
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib


def _cfg(ema: float):
    return configs.override(configs.get_config("smoke"), [
        f"train.ema_decay={ema}", "train.steps=10"])


def _state(cfg, seed=0):
    return train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model), seed), "cpu")


def _trained(cfg, steps=2):
    state = _state(cfg)
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=1)
    batch = {"image": torch.from_numpy(images),
             "grade": torch.from_numpy(grades)}
    for _ in range(steps):
        train_lib.train_step(state, batch, cfg)
    return state


def _assert_same_state(a, b):
    assert a.step == b.step
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)
    for k in a.mu:
        assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k],
                                                              b.nu[k])
    assert torch.equal(a.count, b.count)
    assert torch.equal(a.sched_count, b.sched_count)
    assert (a.ema is None) == (b.ema is None)
    if a.ema is not None:
        for k in a.ema:
            assert torch.equal(a.ema[k], b.ema[k])


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_save_and_restore_is_bitwise(tmp_path, ema):
    cfg = _cfg(ema)
    state = _trained(cfg)
    ck = ckpt_lib.Checkpointer(str(tmp_path), max_to_keep=2)
    ck.save(2, train_lib.state_to_flat(state), {"val_auc": 0.5})
    assert ck.saved_with_ema() is (ema > 0)
    assert sorted(os.listdir(tmp_path / "latest" / "2")) == [
        ckpt_lib.META_FILE, ckpt_lib.STATE_FILE]
    fresh = train_lib.load_state_flat(_state(cfg, seed=9), ck.restore(2))
    _assert_same_state(state, fresh)
    assert int(fresh.count) == int(fresh.sched_count) == 2
    # The member a checkpoint dir serves: the eval params (the shadow when
    # carried) and the batch statistics.
    member = ckpt_lib.load_member(str(tmp_path))
    want = convert.torch_to_flax(train_lib.eval_params(state))
    assert set(member) == set(want)
    for k in want:
        np.testing.assert_array_equal(member[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="EMA shadow"):
        train_lib.load_state_flat(_state(_cfg(0.9 if ema == 0 else 0.0)),
                                  ck.restore(2))


def test_best_keeps_top_k_by_val_auc_and_latest_keeps_the_newest(tmp_path):
    ck = ckpt_lib.Checkpointer(str(tmp_path), max_to_keep=2)
    flat = {"params/w": np.zeros(3, np.float32), "step": np.asarray(0)}
    aucs = {1: 0.6, 2: 0.8, 3: 0.7, 4: 0.8, 5: 0.5, 6: 0.9}
    for step, auc in aucs.items():
        ck.save(step, {**flat, "step": np.asarray(step)}, {"val_auc": auc})
        assert ck.latest_step == step
        assert sorted(os.listdir(tmp_path / "latest")) == [str(step)]
    # Step 3 (0.7) drops step 1; step 4 (0.8) enters above 0.7; step 5
    # (0.5) does not enter; step 6 (0.9) drops step 2 (0.8 tied with 4:
    # the earlier step goes first).
    assert sorted(os.listdir(tmp_path / "best")) == ["4", "6"]
    assert ck.best_step == 6 and ck.best_info() == (6, 0.9)
    assert ck.all_steps() == {4, 6}
    assert int(ck.restore()["step"]) == 6
    assert int(ck.restore(4)["step"]) == 4
    ck.delete_newer_than(4)
    assert ck.all_steps() == {4} and ck.latest_step is None
    assert ck.save_latest(7, flat) and not ck.save_latest(7, flat)
    assert ck.latest_step == 7 and ck.best_step == 4
    meta = json.loads((tmp_path / "latest" / "7" / "meta.json").read_text())
    assert meta == {"step": 7, "val_auc": None, "has_ema": False}


def test_ties_at_full_retention_do_not_enter_best(tmp_path):
    ck = ckpt_lib.Checkpointer(str(tmp_path), max_to_keep=1)
    flat = {"params/w": np.zeros(1, np.float32)}
    ck.save(1, flat, {"val_auc": 0.7})
    ck.save(2, flat, {"val_auc": 0.7})
    assert ck.best_step == 1 and ck.latest_step == 2


@pytest.mark.parametrize("links", [True, False])
def test_best_shares_the_bytes_written_to_latest(tmp_path, monkeypatch,
                                                 links):
    if not links:  # a file system without hard links: best/ gets copies
        def no_link(src, dst):
            raise OSError("hard links not supported")
        monkeypatch.setattr(ckpt_lib.os, "link", no_link)
    ck = ckpt_lib.Checkpointer(str(tmp_path), max_to_keep=1)
    ck.save(3, {"params/w": np.arange(4, dtype=np.float32)},
            {"val_auc": 0.6})
    best, latest = (tmp_path / d / "3" / ckpt_lib.STATE_FILE
                    for d in ("best", "latest"))
    assert os.path.samefile(best, latest) == links
    assert best.read_bytes() == latest.read_bytes()
    ck.save(4, {"params/w": np.ones(4, np.float32)}, {"val_auc": 0.5})
    assert ck.latest_step == 4 and ck.best_step == 3
    np.testing.assert_array_equal(ck.restore()["params/w"], np.arange(4))
    assert json.loads((best.parent / "meta.json").read_text()) == {
        "step": 3, "val_auc": 0.6, "has_ema": False}


def test_leftover_temporary_directory_is_ignored(tmp_path):
    ck = ckpt_lib.Checkpointer(str(tmp_path))
    ck.save(3, {"params/w": np.ones(2, np.float32)}, {"val_auc": 0.4})
    for d in ("best", "latest"):
        junk = tmp_path / d / ".tmp-5-abcd"
        junk.mkdir()
        (junk / ckpt_lib.STATE_FILE).write_bytes(b"torn")
    assert ck.all_steps() == {3} and ck.latest_step == 3
    assert ck.best_step == 3
    np.testing.assert_array_equal(ck.restore()["params/w"], np.ones(2))


def test_missing_and_unreadable_checkpoints_raise(tmp_path):
    ck = ckpt_lib.Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore()
    assert not os.path.exists(tmp_path / "best")  # reading creates nothing
    ck.save(2, {"params/w": np.ones(2, np.float32)}, {"val_auc": 0.4})
    (tmp_path / "best" / "2" / ckpt_lib.STATE_FILE).write_bytes(b"torn")
    with pytest.raises(ckpt_lib.CheckpointError, match="step 2"):
        ck.restore(2)
    with pytest.raises(FileNotFoundError, match="no params.npz"):
        ckpt_lib.load_member(str(tmp_path / "nothing"))


@pytest.mark.parametrize("aucs", [
    (0.6, 0.8, 0.7, 0.8, 0.5, 0.9),
    (0.5, 0.5, 0.5, 0.4),
    (0.9, 0.1, 0.2, 0.3, 0.95, 0.2),
])
def test_retention_matches_the_reference_checkpointer(tmp_path, aucs):
    """The same val-AUC sequence through the JAX package's orbax
    ``Checkpointer`` and the port's: the same steps kept, the same best
    and latest."""
    from jama16_retina_tpu.utils import checkpoint as jax_ckpt

    jck = jax_ckpt.Checkpointer(str(tmp_path / "jax"), max_to_keep=2)
    ck = ckpt_lib.Checkpointer(str(tmp_path / "port"), max_to_keep=2)
    for step, auc in enumerate(aucs, start=1):
        tree = {"w": np.full(2, step, np.float32)}
        jck.save(step, tree, {"val_auc": auc})
        jck.wait()
        ck.save(step, tree, {"val_auc": auc})
        assert ck.all_steps() == jck.all_steps(), step
        assert ck.best_step == jck.best_step, step
        assert ck.best_info() == jck.best_info(), step
        assert ck.latest_step == jck.latest_step, step
    jck.close()
