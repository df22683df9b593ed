"""The large-batch recipe (``train.lr_scale_ref_batch``) and its curve
gate (``train.recipe_curve_ref`` / ``recipe_curve_tol``) against the JAX
package (``tests/test_podscale.py``'s recipe pins), and a recipe ``fit``
end to end on the CPU."""

import json
import logging

import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu_torch import configs, train_lib, trainer
from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401


def _pair(*items):
    return (jax_configs.override(jax_configs.get_config("smoke"), items),
            configs.override(configs.get_config("smoke"), items))


@pytest.mark.parametrize("items", [
    ("data.batch_size=64",),
    ("data.batch_size=64", "train.lr_scale_ref_batch=16"),
    ("data.batch_size=32", "train.lr_scale_ref_batch=8",
     "train.lr_schedule=warmup_cosine", "train.optimizer=lamb"),
    ("data.batch_size=32", "train.lr_scale_ref_batch=64",
     "train.accum_steps=2"),
    ("data.batch_size=8", "train.lr_scale_ref_batch=8"),
])
def test_resolve_large_batch_matches_the_jax_function(items, caplog):
    """The effective learning rate equals the JAX ``resolve_large_batch``
    bit for bit; ref 0 returns the config itself; a second resolution of
    the same config gives the same rate (resume); the factorization is
    logged, and a scale other than 1 off ``warmup_cosine`` warns."""
    jcfg, cfg = _pair(*items)
    with caplog.at_level(logging.INFO, logger=train_lib.__name__):
        got = train_lib.resolve_large_batch(cfg)
    want = jax_train_lib.resolve_large_batch(jcfg)
    assert got.train.learning_rate == want.train.learning_rate
    assert train_lib.global_batch(cfg) == jax_train_lib.global_batch(jcfg)
    if cfg.train.lr_scale_ref_batch == 0:
        assert got is cfg and not caplog.records
        return
    assert train_lib.resolve_large_batch(cfg).train.learning_rate == (
        got.train.learning_rate)
    scale = cfg.data.batch_size / cfg.train.lr_scale_ref_batch
    accum = cfg.train.accum_steps
    assert (f"global batch {cfg.data.batch_size} (= {accum} accum x "
            f"{cfg.data.batch_size // accum} device batch x 1 data ways)"
            in caplog.text)
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert bool(warned) == (scale != 1.0
                            and cfg.train.lr_schedule != "warmup_cosine")


def _curve(path, aucs: dict) -> str:
    with open(path, "w") as f:
        for step, auc in aucs.items():
            f.write(json.dumps({"kind": "eval", "step": step,
                                "val_auc": auc, "t": 0.0}) + "\n")
    return str(path)


def test_recipe_curve_gate_passes_and_fails_closed(tmp_path):
    """Within the tolerance the gate is silent, at an unpinned step it
    has no opinion, beyond it raises ``RecipeCurveRejected`` naming the
    step, as the JAX gate does on the same curve."""
    ref = _curve(tmp_path / "baseline.jsonl", {10: 0.9})
    items = ("train.optimizer=lamb", f"train.recipe_curve_ref={ref}",
             "train.recipe_curve_tol=0.05")
    jcfg, cfg = _pair(*items)
    from jama16_retina_tpu import trainer as jax_trainer

    for gate, exc in ((trainer._DtypeCurveGate(cfg),
                       train_lib.RecipeCurveRejected),
                      (jax_trainer._DtypeCurveGate(jcfg),
                       jax_train_lib.RecipeCurveRejected)):
        gate.check(10, 0.92)
        gate.check(99, 0.0)
        with pytest.raises(exc, match="step 10"):
            gate.check(10, 0.5)
    # A baseline run (adamw at its own batch) never gates, even with a
    # ref set; a recipe run without one runs ungated.
    _, base = _pair(f"train.recipe_curve_ref={tmp_path / 'missing'}")
    trainer._DtypeCurveGate(base).check(10, 0.0)
    _, scaled = _pair("train.lr_scale_ref_batch=4")
    trainer._DtypeCurveGate(scaled).check(10, 0.0)


def test_recipe_gate_arms_alongside_dtype_gate(tmp_path):
    """A bf16 LAMB run gates against both pinned curves, each arm with
    its own exception against its own reference."""
    dtype_ref = _curve(tmp_path / "fp32.jsonl", {5: 0.8})
    recipe_ref = _curve(tmp_path / "recipe.jsonl", {7: 0.8})
    _, cfg = _pair("train.dtype=bf16", f"train.dtype_curve_ref={dtype_ref}",
                   "train.optimizer=lamb",
                   f"train.recipe_curve_ref={recipe_ref}")
    gate = trainer._DtypeCurveGate(cfg)
    with pytest.raises(train_lib.DtypeCurveRejected, match="step 5"):
        gate.check(5, 0.1)
    with pytest.raises(train_lib.RecipeCurveRejected, match="step 7"):
        gate.check(7, 0.1)
    gate.check(5, 0.8)
    gate.check(7, 0.8)


def test_recipe_fit_scales_the_rate_passes_its_own_curve_and_refuses_a_shift(
        tmp_path, caplog):
    """A 4-step ``lamb`` fit at batch 8 with ``lr_scale_ref_batch=2``
    trains at 4x ``learning_rate`` (logged); rerun against its own
    ``metrics.jsonl`` as ``recipe_curve_ref`` it passes with the same
    eval curve; against that curve shifted by 0.5 it stops at the first
    eval with ``RecipeCurveRejected``."""
    data = str(tmp_path / "data")
    for split, n, seed in (("train", 16, 1), ("val", 8, 2)):
        tfrecord.write_synthetic_split(data, split, n, 64, num_shards=2,
                                       seed=seed, encoding="raw")
    base = ["train.optimizer=lamb", "train.lr_scale_ref_batch=2",
            "train.lr_schedule=warmup_cosine", "train.warmup_steps=1",
            "train.steps=4", "train.eval_every=2", "train.log_every=2"]
    cfg = configs.override(configs.get_config("smoke"), base)
    with caplog.at_level(logging.INFO, logger=train_lib.__name__):
        first = trainer.fit(cfg, data, str(tmp_path / "a"), device="cpu")
    assert f"LR {cfg.train.learning_rate:g} x 4 -> " \
           f"{4 * cfg.train.learning_rate:g} (lamb)" in caplog.text
    ref = str(tmp_path / "a" / trainer.METRICS_FILE)
    curve = {r["step"]: r["val_auc"] for r in read_jsonl(ref)
             if r["kind"] == "eval"}
    assert sorted(curve) == [2, 4]
    again = trainer.fit(configs.override(cfg, [
        f"train.recipe_curve_ref={ref}", "train.recipe_curve_tol=1e-9"]),
        data, str(tmp_path / "b"), device="cpu")
    assert again == first
    shifted = _curve(tmp_path / "shifted.jsonl",
                     {s: a - 0.5 for s, a in curve.items()})
    with pytest.raises(train_lib.RecipeCurveRejected, match="step 2"):
        trainer.fit(configs.override(cfg, [
            f"train.recipe_curve_ref={shifted}"]), data,
            str(tmp_path / "c"), device="cpu")
