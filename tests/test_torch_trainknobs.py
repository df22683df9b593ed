"""The trainer's run knobs of the port against the JAX package on the CPU
(``smoke``: tiny_cnn at 64 px, or 16 px records for the stream): bf16
master weights and the fp32 curve gate, gradient accumulation, the
prefetching train stream, async saves, overlapped evals, the warm start
and the preemption save, and a port ``fit`` following a JAX ``fit``'s
val-AUC trajectory from one init over one batch order.

Both frameworks get the same numpy weights (``torch_parity``) and the
same uint8 batches; augment is off and dropout 0 wherever the two are
compared. Each tolerance is stated at its test with what was measured.
"""

import itertools
import json
import multiprocessing
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu_torch import configs, models, train_lib, trainer
from jama16_retina_tpu_torch.data import pipeline, tfrecord
from jama16_retina_tpu_torch.data import readers as readers_lib
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, relative_l2_per_leaf, variables

PARITY = ["data.augment=false", "model.dropout_rate=0.0"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Raw 64 px train (16) and val (8) splits."""
    root = str(tmp_path_factory.mktemp("knob_splits"))
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        tfrecord.write_synthetic_split(root, split, n, 64, num_shards=2,
                                       seed=seed, encoding="raw")
    return root


def _cfg(*items):
    return configs.override(configs.get_config("smoke"), [
        "train.steps=4", "train.eval_every=2", "train.log_every=2", *items])


def _records(workdir, kind):
    return [r for r in read_jsonl(os.path.join(workdir, "metrics.jsonl"))
            if r["kind"] == kind]


def _evals(workdir):
    return [(r["step"], r["val_auc"]) for r in _records(workdir, "eval")]


# ---------------------------------------------------------------------------
# bf16 master weights and accumulation against the JAX step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_weights():
    cfg = configs.get_config("smoke")
    flat = random_flat(jax_models.build(jax_configs.get_config(
        "smoke").model), (1, 64, 64, 3), seed=3)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (8, 64, 64, 3), np.uint8)
    grade = np.array([0, 1, 2, 3, 4, 2, 0, 3], np.int32)
    return cfg, flat, {"image": image, "grade": grade}


def _port_state(cfg, flat):
    model = models.build(cfg.model)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    return train_lib.create_state(cfg, model, "cpu")


def _port_grads(cfg, flat, batch):
    """(loss, flat float64 gradient, flat new BN statistics) of one
    ``compute_grads`` of the port."""
    state = _port_state(cfg, flat)
    loss, grads = train_lib.compute_grads(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names = [k for k, _ in state.model.named_parameters()]
    assert all(g.dtype == torch.float32 for g in grads)
    flat_g = convert.torch_to_flax(dict(zip(names, grads)))
    stats = {k: v for k, v in convert.torch_to_flax(state.model).items()
             if k.startswith("batch_stats/")}
    return float(loss), flat_g, stats


def _jax_grads(items, flat, batch):
    """The same through JAX ``train_lib._step_impl``, compiled as written
    (``xla_allow_excess_precision`` off: on the CPU, XLA otherwise skips
    bf16 roundings the Flax module asks for)."""
    from flax.traverse_util import flatten_dict

    jcfg = jax_configs.override(jax_configs.get_config("smoke"), items)
    model = jax_models.build(jcfg.model)
    v = variables(flat)
    state = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=None)
    args = (state, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.key(0))
    fn = jax.jit(lambda s, b, k: jax_train_lib._step_impl(s, b, k, model,
                                                          jcfg))
    loss, _, stats, grads = fn.lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)
    flat_g = {"params/" + k: np.asarray(a)
              for k, a in flatten_dict(grads, sep="/").items()}
    flat_s = {"batch_stats/" + k: np.asarray(a)
              for k, a in flatten_dict(stats, sep="/").items()}
    return float(loss), flat_g, flat_s


def test_bf16_step_keeps_float32_masters_and_moves_the_loss_a_little(
        smoke_weights):
    """The bar of ``tests/test_mixedprec.py:72-103``: after a bf16 step
    every master, moment and EMA leaf is still float32, and the loss is
    within 0.05 of the fp32 step's on the same weights and batch, and not
    equal to it (measured 1.7e-5)."""
    cfg, flat, batch = smoke_weights
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = {}
    for dtype in ("fp32", "bf16"):
        c = configs.override(cfg, [f"train.dtype={dtype}",
                                   "train.ema_decay=0.9"])
        state = _port_state(c, flat)
        losses[dtype] = float(train_lib.train_step(state, batch, c))
        leaves = [*state.model.parameters(), *state.mu.values(),
                  *state.nu.values(), *state.ema.values()]
        assert all(t.dtype == torch.float32 for t in leaves)
    assert np.isfinite(losses["bf16"])
    assert abs(losses["bf16"] - losses["fp32"]) < 0.05
    assert losses["bf16"] != losses["fp32"]


def test_bf16_gradient_matches_the_jax_step(smoke_weights):
    """``train.dtype=bf16`` on the smoke preset (bf16 compute): the loss
    within 1e-3 and each leaf's gradient within 5 % relative L2 of
    ``_step_impl``'s (measured: loss 8.8e-5, worst leaf 1.7e-2; the fp32
    step at the same bf16 compute shows 1.5e-2 on its own: bf16
    activations, not the view, set the gap); the BN statistics within
    1e-4 (measured 1.9e-5). Both round the BN bias and the Dense head to
    bf16 and compute them in float32, as Flax does, so the view moves the
    gradient away from the fp32 step's."""
    cfg, flat, batch = smoke_weights
    items = [*PARITY, "train.dtype=bf16"]
    loss, grads, stats = _port_grads(configs.override(cfg, items), flat,
                                     batch)
    j_loss, j_grads, j_stats = _jax_grads(items, flat, batch)
    assert abs(loss - j_loss) <= 1e-3
    rel = relative_l2_per_leaf(grads, j_grads)
    assert max(rel.values()) <= 0.05, rel
    for k in j_stats:
        np.testing.assert_allclose(stats[k], j_stats[k], atol=1e-4,
                                   err_msg=k)
    fp32 = _port_grads(configs.override(cfg, PARITY), flat, batch)[1]
    assert any(not np.array_equal(grads[k], fp32[k]) for k in grads)


def test_bf16_view_rounds_where_flax_does(smoke_weights):
    """``train.dtype=bf16`` at float32 compute on both sides, so the bf16
    view of the params is the only rounding: the loss within 2e-7 and
    each leaf's gradient within 2e-4 relative L2 of ``_step_impl``'s
    (measured: loss 0, worst leaf 3.6e-5 in a conv kernel). Leaving one
    place unrounded in the port moves it past these bars (measured: the
    BN biases 3.5e-2, the head's kernel 3.5e-3, its bias 8.7e-4, the
    first conv 7.2e-2), and the float32 step sits 7.7e-2 away."""
    cfg, flat, batch = smoke_weights
    f32 = [*PARITY, "model.compute_dtype=float32"]
    items = [*f32, "train.dtype=bf16"]
    loss, grads, stats = _port_grads(configs.override(cfg, items), flat,
                                     batch)
    j_loss, j_grads, j_stats = _jax_grads(items, flat, batch)
    assert abs(loss - j_loss) <= 2e-7
    rel = relative_l2_per_leaf(grads, j_grads)
    assert set(rel) == set(j_grads) and max(rel.values()) <= 2e-4, rel
    for k in j_stats:
        np.testing.assert_allclose(stats[k], j_stats[k], atol=1e-6,
                                   err_msg=k)
    fp32 = _port_grads(configs.override(cfg, f32), flat, batch)[1]
    assert max(relative_l2_per_leaf(fp32, j_grads).values()) >= 1e-2


@pytest.mark.parametrize("accum,rows,tol", [(2, 8, 1e-4), (3, 6, 0.02)])
def test_accumulated_gradient_and_ghost_bn_match_the_jax_step(
        smoke_weights, accum, rows, tol):
    """``train.accum_steps`` 2 (micro-batches of 4) and 3 (of 2), float32
    compute. Against ``_step_impl``: the mean loss within 1e-6, each
    leaf's gradient within ``tol`` relative L2, and the running
    statistics after the micro-batches, in order, within 1e-6 (measured:
    2.2e-6 relative L2 at accum 2; 1.1e-2 at accum 3, in
    ``conv1/bn/bias``, where the first 2-image micro-batch alone, with no
    accumulation, already differs by 1.5e-2 between the two: over 2
    images a ReLU input within rounding of 0 flips; statistics 3.6e-7).
    Within the port, bitwise: the gradient is ``acc + g_i * (1 / accum)``
    over its own micro-batch gradients in order, as ``_step_impl``
    accumulates, and the statistics are those of the micro-batches run
    one after another."""
    cfg, flat, batch = smoke_weights
    batch = {k: v[:rows] for k, v in batch.items()}
    items = [*PARITY, "model.compute_dtype=float32"]
    acfg = configs.override(cfg, [*items, f"train.accum_steps={accum}"])
    loss, grads, stats = _port_grads(acfg, flat, batch)
    j_loss, j_grads, j_stats = _jax_grads(
        [*items, f"train.accum_steps={accum}"], flat, batch)
    assert abs(loss - j_loss) <= 1e-6
    rel = relative_l2_per_leaf(grads, j_grads)
    assert max(rel.values()) <= tol, rel
    for k in j_stats:
        np.testing.assert_allclose(stats[k], j_stats[k], atol=1e-6,
                                   err_msg=k)
    one = configs.override(cfg, items)
    state = _port_state(one, flat)
    names = [k for k, _ in state.model.named_parameters()]
    acc = [torch.zeros_like(p) for p in state.model.parameters()]
    micro = rows // accum
    for i in range(accum):
        _, g = train_lib.compute_grads(state, {
            k: torch.from_numpy(v[i * micro:(i + 1) * micro])
            for k, v in batch.items()}, one)
        acc = [a + gi * (1.0 / accum) for a, gi in zip(acc, g)]
    want = convert.torch_to_flax(dict(zip(names, acc)))
    assert all(np.array_equal(grads[k], want[k]) for k in want)
    chained = convert.torch_to_flax(state.model)
    assert all(np.array_equal(stats[k], chained[k]) for k in stats)


def test_accumulation_over_a_tiled_batch_equals_one_full_batch(
        smoke_weights):
    """N x micro = 1 x full: on a batch of one 2-image micro tiled 4
    times, every micro-batch has the full batch's BN moments, so the
    gradients of accum 1, 2 and 4 agree within 1e-6 absolute (float32;
    measured 1.5e-7) and the losses within 1e-6 (measured 0). A batch the count does not
    divide raises."""
    cfg, flat, batch = smoke_weights
    tiled = {k: np.concatenate([v[:2]] * 4) for k, v in batch.items()}
    base = configs.override(cfg, [*PARITY, "model.compute_dtype=float32"])
    full_loss, full, _ = _port_grads(base, flat, tiled)
    for accum in (2, 4):
        loss, grads, _ = _port_grads(configs.override(
            base, [f"train.accum_steps={accum}"]), flat, tiled)
        assert abs(loss - full_loss) <= 1e-6
        for k in full:
            np.testing.assert_allclose(grads[k], full[k], atol=1e-6,
                                       err_msg=(accum, k))
    with pytest.raises(ValueError, match="divide"):
        _port_grads(configs.override(base, ["train.accum_steps=3"]), flat,
                    tiled)


# ---------------------------------------------------------------------------
# The fp32 curve gate
# ---------------------------------------------------------------------------


def test_dtype_curve_gate_unit(tmp_path):
    """Mirrors ``tests/test_mixedprec.py:290``."""
    ref = tmp_path / "curve.jsonl"
    ref.write_text(json.dumps({"kind": "eval", "step": 10, "val_auc": 0.9,
                               "t": 0.0}) + "\n")
    cfg = configs.override(configs.get_config("smoke"), [
        "train.dtype=bf16", f"train.dtype_curve_ref={ref}",
        "train.dtype_curve_tol=0.05"])
    gate = trainer._DtypeCurveGate(cfg)
    gate.check(10, 0.93)
    gate.check(11, 0.0)  # an unpinned step has no opinion
    with pytest.raises(train_lib.DtypeCurveRejected, match="step 10"):
        gate.check(10, 0.80)
    trainer._DtypeCurveGate(configs.get_config("smoke")).check(10, 0.0)
    with pytest.raises(FileNotFoundError):
        trainer._DtypeCurveGate(configs.override(cfg, [
            "train.dtype_curve_ref=/nonexistent/curve.jsonl"]))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="no eval records"):
        trainer._DtypeCurveGate(configs.override(cfg, [
            f"train.dtype_curve_ref={empty}"]))


def test_fit_bf16_curve_gate_refusal_drill(data_dir, tmp_path, caplog):
    """Mirrors ``tests/test_mixedprec.py:312``: an fp32 run pins the
    curve; a bf16 run passes against it at a sane tolerance, and is
    refused against a wrong curve after the eval record is written and
    before the save. Without a ref, bf16 runs ungated, with a warning."""
    fp32 = str(tmp_path / "fp32")
    trainer.fit(_cfg(), data_dir, fp32, device="cpu")
    ref = os.path.join(fp32, "metrics.jsonl")
    res = trainer.fit(_cfg("train.dtype=bf16",
                           f"train.dtype_curve_ref={ref}",
                           "train.dtype_curve_tol=0.5"),
                      data_dir, str(tmp_path / "ok"), device="cpu")
    assert res["best_auc"] is not None
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "eval", "step": 2, "val_auc": 0.0,
                               "t": 0.0}) + "\n")
    refused = str(tmp_path / "refused")
    with pytest.raises(train_lib.DtypeCurveRejected, match="step 2"):
        trainer.fit(_cfg("train.dtype=bf16", f"train.dtype_curve_ref={bad}",
                         "train.dtype_curve_tol=0.01"),
                    data_dir, refused, device="cpu")
    assert [r["step"] for r in _records(refused, "eval")] == [2]
    assert ckpt_lib.Checkpointer(refused).all_steps() == set()
    with caplog.at_level("WARNING"):
        trainer.fit(_cfg("train.dtype=bf16", "train.steps=2"), data_dir,
                    str(tmp_path / "ungated"), device="cpu")
    assert "UNGATED" in caplog.text


# ---------------------------------------------------------------------------
# Async saves, eval overlap and the preemption save
# ---------------------------------------------------------------------------


def test_async_saver_latches_and_reraises_failures():
    """Mirrors ``tests/test_mixedprec.py:377``."""
    saver = ckpt_lib.AsyncSaver()
    order = []

    def boom():
        raise OSError("disk gone")

    saver.submit(lambda: order.append(1))
    saver.submit(boom)
    saver.submit(lambda: order.append(2))
    with pytest.raises(OSError, match="disk gone"):
        saver.drain()
    assert order == [1, 2]
    ran = threading.Event()
    saver.submit(boom)
    saver.submit(ran.set)
    ran.wait()
    with pytest.raises(OSError, match="disk gone"):
        saver.submit(lambda: None)  # latched, re-raised at the next submit
    saver.submit(lambda: order.append(3))
    saver.close()
    assert order == [1, 2, 3]
    with pytest.raises(RuntimeError, match="closed"):
        saver.submit(lambda: None)


def test_async_saved_workdir_resumes(data_dir, tmp_path):
    """Mirrors ``tests/test_mixedprec.py:363``: an async-saved workdir is
    a plain workdir, and its checkpoints equal the sync run's bitwise."""
    wd = str(tmp_path / "async")
    trainer.fit(_cfg("train.async_save=true"), data_dir, wd, device="cpu")
    sync = str(tmp_path / "sync")
    trainer.fit(_cfg(), data_dir, sync, device="cpu")
    a, b = (ckpt_lib.Checkpointer(w).restore(4) for w in (wd, sync))
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    res = trainer.fit(_cfg("train.async_save=true", "train.resume=true",
                           "train.steps=6"), data_dir, wd, device="cpu")
    assert [r["step"] for r in _records(wd, "resume")] == [4]
    assert res["best_auc"] is not None
    assert ckpt_lib.Checkpointer(wd).latest_step == 6


def _interrupt_after(monkeypatch, n_batches):
    real = pipeline.train_batches

    def stream(*args, **kwargs):
        it = real(*args, **kwargs)
        try:
            for _ in range(n_batches):
                yield next(it)
        finally:
            it.close()
        raise KeyboardInterrupt("preempted")

    monkeypatch.setattr(pipeline, "train_batches", stream)


@pytest.mark.parametrize("items", [(), ("train.async_save=true",),
                                   ("train.eval_overlap=true",)])
def test_keyboard_interrupt_saves_latest_and_resume_continues(
        data_dir, tmp_path, monkeypatch, items):
    """A ``KeyboardInterrupt`` raised by the stream when step 4's batch is
    fetched (steps 1-3 done, an eval at 2) leaves ``latest/`` at 3 and a
    ``preempt_save`` record at 3, through the saver when the run has one;
    resume continues from 3 and ends where the uninterrupted run ends."""
    cfg = _cfg("train.steps=6", *items)
    wd = str(tmp_path / "cut")
    with monkeypatch.context() as m:
        _interrupt_after(m, 3)
        with pytest.raises(KeyboardInterrupt):
            trainer.fit(cfg, data_dir, wd, device="cpu")
    # The preemption path does not wait for an overlapped eval; this test
    # does, so the resumed run replays its record.
    for t in threading.enumerate():
        if t.name == "eval-overlap":
            t.join()
    assert ckpt_lib.Checkpointer(wd).latest_step == 3
    assert [(r["step"], r["saved"]) for r in
            _records(wd, "preempt_save")] == [(3, True)]
    resumed = trainer.fit(configs.override(cfg, ["train.resume=true"]),
                          data_dir, wd, device="cpu")
    assert [r["step"] for r in _records(wd, "resume")] == [3]
    full = str(tmp_path / "full")
    assert resumed == trainer.fit(cfg, data_dir, full, device="cpu")
    assert _evals(wd) == _evals(full)


def test_a_failing_preemption_save_does_not_mask_the_exit(
        data_dir, tmp_path, monkeypatch, caplog):
    """The emergency save raising is logged; the interrupt still reaches
    the caller, and no ``preempt_save`` record claims a save."""
    def broken(self, step, flat):
        raise OSError("disk full")

    wd = str(tmp_path)
    with monkeypatch.context() as m:
        _interrupt_after(m, 3)
        m.setattr(ckpt_lib.Checkpointer, "save_latest", broken)
        with pytest.raises(KeyboardInterrupt):
            trainer.fit(_cfg("train.steps=6", "train.async_save=true"),
                        data_dir, wd, device="cpu")
    assert _records(wd, "preempt_save") == []
    assert "preemption save at step 3 failed: OSError: disk full" in (
        caplog.text)
    assert ckpt_lib.Checkpointer(wd).latest_step == 2


@pytest.mark.parametrize("items", [(), ("train.async_save=true",)])
def test_an_interrupt_inside_a_step_leaves_latest_as_it_was(
        data_dir, tmp_path, monkeypatch, items):
    """A ``KeyboardInterrupt`` raised by the optimizer in step 4, after it
    has updated half the parameters in place, saves nothing: ``latest/``
    stays at step 2's eval save, byte for byte, ``preempt_save`` records
    ``saved=false``, and resume from 2 ends where the uninterrupted run
    ends."""
    from jama16_retina_tpu_torch.ops import adamw

    cfg = _cfg("train.steps=6", *items)
    wd = str(tmp_path / "cut")
    real = adamw.adamw_reference
    calls = []

    def torn(params, grads, mu, nu, flags, *args):
        calls.append(1)
        if len(calls) < 4:
            return real(params, grads, mu, nu, flags, *args)
        half = len(params) // 2
        real(params[:half], grads[:half], mu[:half], nu[:half],
             flags[:half], *args)
        raise KeyboardInterrupt("preempted")

    def latest_bytes():
        root = os.path.join(wd, "latest")
        return {os.path.join(d, f): open(os.path.join(root, d, f),
                                         "rb").read()
                for d in os.listdir(root)
                for f in os.listdir(os.path.join(root, d))}

    with monkeypatch.context() as m:
        m.setattr(adamw, "adamw_reference", torn)
        before = {}
        real_save = ckpt_lib.Checkpointer.save

        def save(self, step, flat, metrics):
            real_save(self, step, flat, metrics)
            before.update(latest_bytes())

        m.setattr(ckpt_lib.Checkpointer, "save", save)
        with pytest.raises(KeyboardInterrupt):
            trainer.fit(cfg, data_dir, wd, device="cpu")
    assert sorted({k.split(os.sep)[0] for k in before}) == ["2"]
    assert latest_bytes() == before
    assert [(r["step"], r["saved"]) for r in
            _records(wd, "preempt_save")] == [(3, False)]
    resumed = trainer.fit(configs.override(cfg, ["train.resume=true"]),
                          data_dir, wd, device="cpu")
    assert [r["step"] for r in _records(wd, "resume")] == [2]
    full = str(tmp_path / "full")
    assert resumed == trainer.fit(cfg, data_dir, full, device="cpu")
    assert _evals(wd) == _evals(full)


def test_eval_overlap_records_equal_the_sync_run(data_dir, tmp_path):
    """Mirrors ``tests/test_mixedprec.py:340``: overlap changes when the
    eval results arrive, not what they are: the same (step, val AUC)
    records and bitwise the same checkpoints as the blocking run."""
    sync, ov = str(tmp_path / "sync"), str(tmp_path / "overlap")
    res_sync = trainer.fit(_cfg("train.steps=6"), data_dir, sync,
                           device="cpu")
    res_ov = trainer.fit(_cfg("train.steps=6", "train.eval_overlap=true"),
                         data_dir, ov, device="cpu")
    assert res_ov == res_sync
    assert _evals(ov) == _evals(sync) and len(_evals(ov)) == 3
    a, b = ckpt_lib.Checkpointer(sync), ckpt_lib.Checkpointer(ov)
    assert a.all_steps() == b.all_steps() and b.latest_step == 6
    for step in b.all_steps():
        x, y = a.restore(step), b.restore(step)
        assert all(np.array_equal(x[k], y[k]) for k in x), step


def test_eval_overlap_early_stop_fires_at_most_one_step_late(data_dir,
                                                             tmp_path):
    """Patience 1, min_delta 1: the sync run stops at its eval at 4; the
    overlapped run records the same stop and ends by step 5."""
    items = ["train.steps=8", "train.early_stop_patience=1",
             "train.min_delta=1.0", "train.log_every=1"]
    sync = trainer.fit(_cfg(*items), data_dir, str(tmp_path / "s"),
                       device="cpu")
    ov_dir = str(tmp_path / "o")
    ov = trainer.fit(_cfg(*items, "train.eval_overlap=true"), data_dir,
                     ov_dir, device="cpu")
    assert ov == sync and ov["stopped_early"]
    assert [r["step"] for r in _records(ov_dir, "early_stop")] == [4]
    assert max(r["step"] for r in _records(ov_dir, "train")) <= 5


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def donor(data_dir, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("donor"))
    trainer.fit(_cfg("train.ema_decay=0.9"), data_dir, wd, seed=0,
                device="cpu")
    return wd


@pytest.mark.parametrize("ema", [0.0, 0.5])
def test_warm_start_transplants_the_donor(data_dir, donor, tmp_path, ema):
    """Mirrors ``tests/test_lifecycle.py:901``: the donor's best params
    and batch statistics (not its EMA) become the step-0 weights, its
    EMA seeds the run's shadow, the optimizer starts fresh, and the run
    writes one ``warm_start`` record. An architecture mismatch raises."""
    cfg = _cfg(f"train.init_from={donor}", f"train.ema_decay={ema}")
    wd = str(tmp_path / "warm")
    trainer.fit(cfg, data_dir, wd, seed=5, device="cpu")
    assert [r["init_from"] for r in _records(wd, "warm_start")] == [donor]
    best = ckpt_lib.Checkpointer(donor).restore()
    state = train_lib.create_state(cfg, models.build(cfg.model), "cpu")
    trainer._warm_start_state(cfg, state, donor)
    flat = train_lib.state_to_flat(state)
    for k, v in best.items():
        if k.startswith(("params/", "batch_stats/")):
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
        if ema and k.startswith(ckpt_lib.EMA_PREFIX):
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert state.step == 0 and int(state.count) == 0
    assert all(not m.any() for m in state.mu.values())
    multi = configs.override(cfg, ["model.head=multi"])
    with pytest.raises(ValueError, match="shape"):
        trainer._warm_start_state(multi, train_lib.create_state(
            multi, models.build(multi.model), "cpu"), donor)


def test_resume_wins_over_init_from(data_dir, donor, tmp_path):
    """Mirrors ``tests/test_lifecycle.py:924``: a resumed run continues
    itself; the donor only seeds step 0."""
    cfg = _cfg(f"train.init_from={donor}", "train.resume=true")
    wd = str(tmp_path / "resumed")
    trainer.fit(cfg, data_dir, wd, seed=7, device="cpu")
    trainer.fit(configs.override(cfg, ["train.steps=6"]), data_dir, wd,
                seed=7, device="cpu")
    kinds = [r["kind"] for r in read_jsonl(os.path.join(wd,
                                                        "metrics.jsonl"))]
    assert kinds.count("warm_start") == 1 and kinds.count("resume") == 1


# ---------------------------------------------------------------------------
# The prefetching train stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_split(tmp_path_factory):
    """10 records of 16 px in 3 files: batches of 4 run across epochs."""
    root = str(tmp_path_factory.mktemp("small_split"))
    tfrecord.write_synthetic_split(root, "train", 10, 16, num_shards=3,
                                   seed=4, encoding="raw")
    return root


def _stream(root, readers=1, skip=0):
    cfg = configs.DataConfig(batch_size=4)
    return pipeline.train_batches(root, "train", cfg, 16, seed=3,
                                  skip_batches=skip, readers=readers)


def _reference(root):
    """The stream read on the calling thread through the reader's own
    ``TrainOrder.fill``: what the reader processes are held to."""
    order = readers_lib.TrainOrder(root, "train", 4, 16, seed=3)
    files = order.open_files()
    try:
        for index in itertools.count():
            image, grade = np.empty(order.shape(), np.uint8), np.empty(
                4, np.int32)
            order.fill(index, files, image, grade)
            yield {"image": torch.from_numpy(image),
                   "grade": torch.from_numpy(grade)}
    finally:
        for f in files:
            f.close()


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("readers", [1, 3])
@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_prefetched_batches_are_the_stream_bitwise(small_split, depth,
                                                   readers):
    """At every depth and reader-process count: the first 9 batches (over
    three epochs) equal those read on the calling thread
    (``_reference``), bitwise, and so do those of a stream that skips 4 batches
    (resume)."""
    want = _take(_reference(small_split), 9)
    for skip in (0, 4):
        with pipeline.DevicePrefetch(_stream(small_split, readers, skip),
                                      "cpu", depth) as s:
            got = _take(s, 9 - skip)
        for g, w in zip(got, want[skip:], strict=True):
            assert set(g) == {"image", "grade"}
            assert all(torch.equal(g[k], w[k]) for k in w)


def _readers():
    """Reader processes and prefetch threads of this process now."""
    return {*multiprocessing.active_children(),
            *[t for t in threading.enumerate()
              if t.name == "train-prefetch"]}


def _started_since(before):
    """Those alive now that were not before (another test's stream may
    still be waiting for the garbage collector)."""
    return _readers() - before


def test_prefetch_threads_stop_on_close_and_on_a_consumer_exception(
        small_split):
    before = _readers()
    s = pipeline.DevicePrefetch(_stream(small_split, readers=3), "cpu", 2)
    next(s)
    s.close()
    assert _started_since(before) == set()
    with pytest.raises(RuntimeError, match="closed"):
        next(s)
    with pytest.raises(ZeroDivisionError):
        with pipeline.DevicePrefetch(_stream(small_split, readers=3),
                                      "cpu", 2) as s:
            next(s)
            raise ZeroDivisionError
    assert _started_since(before) == set()


@pytest.mark.parametrize("depth", [0, 2])
def test_a_stream_exception_surfaces_in_order(small_split, depth):
    """An exception of the stream reaches the consumer after every batch
    before it, at the next() that reaches its place, and again after
    that."""
    def failing():
        yield from _take(_reference(small_split), 3)
        raise OSError("disk gone")

    before = _readers()
    s = pipeline.DevicePrefetch(failing(), "cpu", depth)
    assert len(_take(s, 3)) == 3
    for _ in range(2):
        with pytest.raises(OSError, match="disk gone"):
            next(s)
    s.close()
    assert _started_since(before) == set()


def test_a_corrupt_record_surfaces_at_its_batch(small_split, tmp_path):
    """A record whose CRC fails raises, through 3 reader processes and
    the prefetch, at the batch where the calling thread's read raises,
    after every batch before it; the readers stop."""
    import shutil

    root = str(tmp_path)
    for p in tfrecord.list_split(small_split, "train"):
        shutil.copy(p, root)
    path = tfrecord.list_split(root, "train")[1]
    span = tfrecord.index_records(path)[1]
    with open(path, "r+b") as f:
        f.seek(span.offset + 7)
        byte = f.read(1)
        f.seek(span.offset + 7)
        f.write(bytes([byte[0] ^ 0xFF]))
    good = 0
    ref = _reference(root)
    with pytest.raises(tfrecord.CorruptRecordError):
        while True:
            next(ref)
            good += 1
    before = _readers()
    with pipeline.DevicePrefetch(_stream(root, readers=3), "cpu", 2) as s:
        assert len(_take(s, good)) == good
        with pytest.raises(tfrecord.CorruptRecordError):
            next(s)
    assert _started_since(before) == set()


# ---------------------------------------------------------------------------
# The val-AUC trajectory against the reference
# ---------------------------------------------------------------------------


def test_fit_follows_the_jax_val_auc_trajectory(tmp_path, monkeypatch):
    """A port ``fit`` and a JAX ``fit`` of ``smoke`` in float32, augment
    off and dropout 0, from the JAX init converted to the port, over one
    batch order given to both by a test-side stream hook (a seeded draw
    of a 16-image train split's records, 6 steps of batch 8): their val
    AUCs on 32 images at steps 2, 4 and 6 agree within 0.02 each
    (``dtype_curve_tol``'s default; measured: equal, 0.783, 0.874 and
    0.903) and their losses within 1e-4 (measured 6e-8)."""
    data_dir = str(tmp_path / "data")
    for split, n, seed in (("train", 16, 1), ("val", 32, 2)):
        tfrecord.write_synthetic_split(data_dir, split, n, 64,
                                       num_shards=2, seed=seed, encoding="raw")
    items = [*PARITY, "model.compute_dtype=float32", "train.steps=6",
             "train.eval_every=2", "train.log_every=2"]
    cfg = configs.override(configs.get_config("smoke"), items)
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), items)
    records = [tfrecord.parse_record(d) for p in
               tfrecord.list_split(data_dir, "train")
               for d in tfrecord.read_records(p)]
    order = np.random.default_rng(11).integers(0, len(records), (6, 8))

    def batches(skip_batches=0):
        for rows in order[skip_batches:]:
            yield {"image": np.stack([records[i].image for i in rows]),
                   "grade": np.array([records[i].grade for i in rows],
                                     np.int32)}

    jstate, _ = jax_train_lib.create_state(
        jcfg, jax_models.build(jcfg.model), jax.random.key(0))
    from flax.traverse_util import flatten_dict
    init_flat = {f"{col}/{k}": np.array(v) for col in ("params",
                                                          "batch_stats")
                 for k, v in flatten_dict(getattr(jstate, col),
                                          sep="/").items()}

    def jax_init(model, seed):
        model.load_state_dict(convert.flax_to_torch(init_flat, model))
        return model

    monkeypatch.setattr(jax_trainer, "_train_stream",
                        lambda cfg, data_dir, seed, skip_batches, **kw:
                        batches(skip_batches))
    monkeypatch.setattr(pipeline, "train_batches",
                        lambda data_dir, split, cfg, image_size, seed=0,
                        skip_batches=0, **kw: batches(skip_batches))
    monkeypatch.setattr(trainer.init, "init_flax_default", jax_init)
    jax_trainer.fit(jcfg, data_dir, str(tmp_path / "jax"), seed=0)
    trainer.fit(cfg, data_dir, str(tmp_path / "port"), seed=0, device="cpu")
    want, got = _evals(str(tmp_path / "jax")), _evals(str(tmp_path / "port"))
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 0.02, (got, want)
    losses = [(r["step"], r["loss"]) for r in _records(str(tmp_path /
                                                           "port"), "train")]
    jlosses = [(r["step"], r["loss"]) for r in _records(str(tmp_path /
                                                            "jax"), "train")]
    assert [s for s, _ in losses] == [s for s, _ in jlosses] == [2, 4, 6]
    for (_, a), (_, b) in zip(losses, jlosses):
        assert abs(a - b) <= 1e-4, (losses, jlosses)
