"""Data-parallel training over ranks (``parallel/mesh.py``) against the
JAX package and against the port's one-process forms, on the CPU under
gloo.

Two launches of two ranks, each read by several tests: the rank worker
(``torch_parallel_ranks.py``: cross-replica BatchNorm, three train steps
in each step form, the eval step, the mesh's collectives) and a 4-step
``fit`` through ``python -m jama16_retina_tpu_torch.train --fake_devices 2
--device cpu``. Everything else runs in this process: the launch
environment's contract, the mesh's refusals, the rank-sharded train
stream and the sharded eval stream against the reference's. Tolerances
are stated at each test with what was measured.
"""

import json
import os
import subprocess
import sys

import flax.linen as fnn
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
from jama16_retina_tpu.data import pipeline as jax_pipeline
from jama16_retina_tpu.parallel import mesh as jax_mesh
from jama16_retina_tpu_torch import configs, train_lib, trainer
from jama16_retina_tpu_torch.data import pipeline, synthetic, tfrecord
from jama16_retina_tpu_torch.parallel import mesh as mesh_lib
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils.logging import read_jsonl

import torch_parallel_ranks as ranks
from torch_parity import (flat_optax_state, random_flat, torch_threads,
                          variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEP = ranks.SEP
STEPS = 3
# The smoke preset in float32 with dropout 0, as the single-step parity
# tests run it (tests/test_torch_train.py::_smoke_pair), in each form.
SMOKE = ["model.compute_dtype=float32", "model.dropout_rate=0.0",
         "train.steps=10", "train.lr_schedule=warmup_cosine",
         "train.weight_decay=0.01", "train.ema_decay=0.9"]
FORMS = {"preset": ["data.use_pallas=true"],
         "fused": ["train.use_pallas_fused=true"]}
# The float64 case: the preset's augment through B1's plain version, its
# dropout on, the step's own draws, and sgdm (adamw's plain version and
# B3 are float32 only).
F64 = ["model.compute_dtype=float32", "data.use_pallas=true",
       "train.optimizer=sgdm", "train.steps=10"]
LAUNCH_ENV = mesh_lib.LAUNCH_ENV + ("LOCAL_WORLD_SIZE",)


def _unflat(out: dict, case: str) -> dict:
    """The ``case|...`` entries of a rank's output, keyed ``a/b/c``."""
    head = case + SEP
    return {k[len(head):].replace(SEP, "/"): v for k, v in out.items()
            if k.startswith(head)}


def _rel(got, want, floor: float = 1e-30) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), floor))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(inputs, [rank 0 output, rank 1 output]) of one launch of the rank
    worker on two gloo ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(20)
    jcfg = jax_configs.override(jax_configs.get_config("smoke"),
                                SMOKE + FORMS["preset"])
    flat = random_flat(jax_models.build(jcfg.model), (2, 64, 64, 3), seed=12)
    images, grades = synthetic.make_dataset(
        8, synthetic.SynthConfig(image_size=64), seed=3)
    arrays = {"image": images, "grade": grades}
    arrays.update({f"flat{SEP}{k.replace('/', SEP)}": v
                   for k, v in flat.items()})
    base_key = jax.random.key(0)
    for s in range(STEPS):
        # The draws the JAX step makes inside (train_lib.py:440-447), over
        # the global batch.
        aug_key, _ = jax.random.split(jax.random.fold_in(base_key, s))
        for k, v in jax_augment._draw_params(aug_key, 8, jcfg.data).items():
            arrays[f"draw{s}{SEP}{k}"] = np.asarray(v)
    c = 6
    arrays.update({
        f"bn{SEP}x": rng.normal(0.5, 2.0, (8, c, 5, 5)),
        f"bn{SEP}w": rng.normal(0.0, 1.0, (8, c, 5, 5)),
        f"bn{SEP}scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        f"bn{SEP}bias": rng.normal(0.0, 0.1, c).astype(np.float32),
        f"bn{SEP}mean": rng.normal(0.0, 0.1, c).astype(np.float32),
        f"bn{SEP}var": rng.uniform(0.5, 1.5, c).astype(np.float32)})
    spec = {"steps": {
        **{f"jax_{form}": {"sets": SMOKE + sets, "steps": STEPS,
                           "float64": False, "inject": True}
           for form, sets in FORMS.items()},
        "f64": {"sets": F64, "steps": STEPS, "float64": True,
                "inject": False}},
        "eval_sets": ["model.compute_dtype=float32"]}
    arrays["spec"] = np.asarray(json.dumps(spec))
    np.savez(tmp / "in.npz", **arrays)
    code = mesh_lib.launch_local(
        [os.path.join(ROOT, "tests", "torch_parallel_ranks.py"),
         str(tmp / "in.npz"), str(tmp)], 2, timeout_s=300)
    assert code == 0
    outs = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as f:
            outs.append(dict(f))
    arrays.pop("spec")
    return arrays, spec, outs


def test_ranks_hold_bitwise_equal_replicas(launched):
    """After every case the two ranks' states, losses and assembled
    probabilities are the same bits: the averaged gradient is one value,
    and every replica applies the same update to it."""
    _, _, (r0, r1) = launched
    shared = [k for k in r0 if not k.startswith(("bn", "mesh|replicated"))]
    assert set(r0) == set(r1) and len(shared) > 50
    for k in shared:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_mesh_fingerprint_replication_and_assembly(launched):
    """The fingerprint has the reference's keys (shape, axis names,
    process count), rank 0's tensor reaches every rank, and the assembly
    is rank-major."""
    _, _, outs = launched
    want = jax_mesh.mesh_fingerprint(jax_mesh.make_mesh(2))
    for out in outs:
        got = json.loads(str(out["mesh|fingerprint"]))
        assert set(got) == set(want)
        assert got == {"shape": [2], "axis_names": ["data"],
                       "process_count": 2}
        assert (got["shape"], got["axis_names"]) == (want["shape"],
                                                    want["axis_names"])
        np.testing.assert_array_equal(out["mesh|replicated"], [1.0] * 3)
        np.testing.assert_array_equal(out["mesh|assembled"],
                                      [0.0, 1.0, 10.0, 11.0])
    assert mesh_lib.mesh_fingerprint(None) == {
        "shape": [1], "axis_names": [], "process_count": 1}


def test_cross_replica_batchnorm_is_the_global_batchs_in_float64(launched):
    """Two ranks of four rows against the port's one-process BatchNorm on
    the eight: outputs and input gradients row for row, scale and bias
    gradients summed over the ranks, running statistics on every rank.
    Bound 1e-12 absolute; measured 4.4e-16 (outputs, input gradients) and
    2.8e-15 (the summed scale gradient)."""
    arrays, _, outs = launched
    bn = {k.split(SEP, 1)[1]: v for k, v in arrays.items()
          if k.startswith("bn" + SEP)}
    want = ranks.batchnorm(bn, torch.float64)
    got = [_unflat(o, "bn64") for o in outs]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]),
                                   want[key], rtol=0, atol=1e-12)
    for key in ("dscale", "dbias"):
        np.testing.assert_allclose(got[0][key] + got[1][key], want[key],
                                   rtol=0, atol=1e-12)
    for key in ("mean", "var"):
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=0,
                                       atol=1e-12)


def test_cross_replica_batchnorm_matches_flax_axis_name(launched):
    """The same rows in float32 against Flax ``BatchNorm(axis_name=
    "data")`` under ``jax.pmap`` over 2 of the conftest's CPU devices:
    each device's output and the running statistics. Bound 1e-5 on the
    outputs, 1e-6 on the statistics (float32)."""
    arrays, _, outs = launched
    bn = {k.split(SEP, 1)[1]: v for k, v in arrays.items()
          if k.startswith("bn" + SEP)}

    class BN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.BatchNorm(use_running_average=False, momentum=0.9,
                                 epsilon=1e-3, axis_name="data")(x)

    v = {"params": {"BatchNorm_0": {"scale": bn["scale"],
                                    "bias": bn["bias"]}},
         "batch_stats": {"BatchNorm_0": {"mean": bn["mean"],
                                         "var": bn["var"]}}}
    x = bn["x"].astype(np.float32).transpose(0, 2, 3, 1).reshape(
        2, 4, 5, 5, 6)
    y, mutated = jax.pmap(
        lambda v, x: BN().apply(v, x, mutable=["batch_stats"]),
        axis_name="data", in_axes=(None, 0),
        devices=jax.devices()[:2])(v, x)
    for r, out in enumerate(outs):
        got = _unflat(out, "bn32")
        np.testing.assert_allclose(
            got["y"], np.asarray(y[r]).transpose(0, 3, 1, 2), rtol=0,
            atol=1e-5)
        stats = mutated["batch_stats"]["BatchNorm_0"]
        for key in ("mean", "var"):
            np.testing.assert_allclose(got[key], np.asarray(stats[key][r]),
                                       rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_mesh_steps(launched):
    """Three steps of the reference's ``make_train_step`` over a 2-device
    data mesh on the global batch (its kernels routed to the jnp
    composition there, ``_pallas_safe_cfg``; both forms one program)."""
    arrays, _, _ = launched
    jcfg = jax_configs.override(jax_configs.get_config("smoke"),
                                SMOKE + FORMS["preset"])
    jmodel = jax_models.build(jcfg.model)
    flat = {k.split(SEP, 1)[1].replace(SEP, "/"): v
            for k, v in arrays.items() if k.startswith("flat" + SEP)}
    v = variables(flat)
    tx = jax_train_lib.make_optimizer(jcfg.train)
    jstate = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        ema_params=jax.tree.map(jnp.copy, v["params"]))
    jstep = jax_train_lib.make_train_step(
        jcfg, jmodel, tx, mesh=jax_mesh.make_mesh(2), donate=False)
    batch = {"image": jnp.asarray(arrays["image"]),
             "grade": jnp.asarray(arrays["grade"])}
    losses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, batch, jax.random.key(0))
        losses.append(float(m["loss"]))
    return jstate, losses


@pytest.mark.parametrize("form", list(FORMS))
def test_two_rank_step_matches_the_jax_mesh_step(launched, jax_mesh_steps,
                                                 form):
    """Three steps on two ranks (four rows each, the JAX draws of the
    global batch injected) against ``make_train_step(mesh=make_mesh(2))``
    with the single-step parity test's bounds: loss 1e-5 a step, params
    and statistics 2e-5, Adam moments 1e-5, EMA 2e-6. The port keeps B1
    (preset) or B2 and B3 (fused) on every rank; the reference ran the
    jnp composition on its mesh. Measured: loss 7.2e-7, params and
    statistics 6.7e-6, moments 3.1e-6, EMA 4.3e-7."""
    _, _, outs = launched
    jstate, losses = jax_mesh_steps
    got = _unflat(outs[0], f"jax_{form}")
    np.testing.assert_allclose(got["loss"], losses, rtol=0, atol=1e-5)
    want = {"params/" + k: np.asarray(x) for k, x in
            flatten_dict(jstate.params, sep="/").items()}
    want.update({"batch_stats/" + k: np.asarray(x) for k, x in
                 flatten_dict(jstate.batch_stats, sep="/").items()})
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-5, err_msg=k)
    opt = flat_optax_state(jstate.opt_state, "adamw")
    assert int(got["adam/count"]) == int(opt["adam/count"]) == STEPS
    for k, w in opt.items():
        if k.startswith("adam/m"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5,
                                       err_msg=k)
    for k, x in flatten_dict(jstate.ema_params, sep="/").items():
        np.testing.assert_allclose(got["ema/params/" + k], np.asarray(x),
                                   rtol=0, atol=2e-6, err_msg=k)


def test_two_rank_step_is_the_one_rank_step_in_float64(launched):
    """Three float64 steps (dropout on, the step's own augment and
    dropout draws, sgdm) on two ranks against the port's one-process
    step on the global batch: every leaf of the params, statistics,
    momentum and EMA within 1e-10 relative L2, the losses within 1e-12.
    The draws are the global batch's, each rank taking its rows, so the
    two forms draw the same numbers. Measured: losses 2.2e-16 apart, every
    leaf bitwise."""
    arrays, spec, outs = launched
    run = spec["steps"]["f64"]
    with torch_threads(1):
        want = ranks.steps(arrays, run["sets"], run["steps"], True, False)
    got = _unflat(outs[0], "f64")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=1e-12)
    worst = max(_rel(got[k], want[k]) for k in want if k != "loss")
    assert worst <= 1e-10, worst


def test_eval_step_assembles_the_whole_batch_on_every_rank(launched):
    """Each rank scores its four rows; the assembled probabilities equal
    the one-process eval step's on the eight within 1e-6 (measured 0)."""
    arrays, spec, outs = launched
    want = ranks.eval_probs(arrays, spec["eval_sets"])
    for out in outs:
        np.testing.assert_allclose(out[f"eval{SEP}probs"], want, rtol=0,
                                   atol=1e-6)


@pytest.fixture
def clean_env(monkeypatch):
    for v in LAUNCH_ENV:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_initialize_is_a_no_op_without_the_launch_env(clean_env):
    """One process: no group forms, and nothing reaches the network (the
    reference's ``test_initialize_is_noop_without_coordinator_env``)."""
    assert mesh_lib.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert mesh_lib.process_count() == 1


@pytest.mark.parametrize("missing", ["WORLD_SIZE", "RANK", "MASTER_PORT"])
def test_a_half_set_launch_env_is_refused_naming_what_is_missing(
        clean_env, missing):
    """As ``tests/test_mesh.py::test_half_configured_launcher_env_fails_
    loudly``: the refusal names the missing variable, before any
    connection."""
    env = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    for k, v in env.items():
        if k != missing:
            clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match=f"but {missing} is not"):
        mesh_lib.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_refuses_more_devices_than_the_launch_has(clean_env):
    """The device count is the launch's world size (1 here): the
    reference's message for oversubscription; 0 and 1 make the one-rank
    mesh."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh_lib.make_mesh(2, device="cpu")
    for n in (0, 1):
        mesh = mesh_lib.make_mesh(n, "batch", device="cpu")
        assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
        assert mesh.shape == {"batch": 1}
        assert mesh_lib._batch_axis(mesh) == "batch"


def test_one_rank_mesh_places_and_shards_whole(clean_env):
    """One rank's ``shard_batch`` and ``place_full_local`` hold every row,
    as tensors on its device, and ``replicated`` leaves a state as it is
    (the reference's single-process ``device_put``)."""
    mesh = mesh_lib.make_mesh(device="cpu")
    batch = {"image": np.arange(24, dtype=np.uint8).reshape(4, 2, 3),
             "grade": np.arange(4, dtype=np.int32), "n": np.int64(7)}
    for got in (mesh_lib.shard_batch(batch, mesh),
                mesh_lib.place_full_local(batch, mesh)):
        assert set(got) == set(batch)
        for k, v in batch.items():
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), v)
    t = torch.arange(3.0)
    assert mesh_lib.replicated({"t": t}, mesh)["t"] is t
    np.testing.assert_array_equal(mesh.assemble(t).numpy(), [0, 1, 2])
    with pytest.raises(ValueError, match="not divisible by process_count=2"):
        mesh_lib.local_rows(5, _two_ranks())
    assert mesh_lib.local_rows(8, mesh_lib.Mesh(2, 1, "data", mesh.device)
                               ) == slice(4, 8)


def _two_ranks():
    return mesh_lib.Mesh(2, 0, "data", torch.device("cpu"))


@pytest.mark.parametrize("item", [
    "train.accum_steps=2", "train.distill_from=/teacher",
    "data.loader=hbm", "data.loader=tiered", "data.loader=rawshard",
    "data.loader=grain"])
def test_knobs_of_part_2_are_refused_across_ranks(item):
    """What one fit over ranks cannot honour yet names Queue A item 8,
    part 2; one rank takes each of them."""
    cfg = configs.override(configs.get_config("smoke"), [item])
    with pytest.raises(NotImplementedError,
                       match="Queue A item 8, part 2"):
        trainer.check_mesh_knobs(cfg, _two_ranks())
    trainer.check_mesh_knobs(cfg, mesh_lib.make_mesh(device="cpu"))


@pytest.mark.parametrize("item", ["train.async_save=true",
                                  "train.eval_overlap=true"])
def test_background_saves_and_evals_are_refused_across_ranks(item):
    """The reference's ``_async_knobs_guard``, with its message."""
    cfg = configs.override(configs.get_config("smoke"), [item])
    with pytest.raises(ValueError, match="multi-process runs"):
        trainer.check_mesh_knobs(cfg, _two_ranks())


@pytest.mark.parametrize("item,where", [
    ("parallel.member_axis_size=2", "check"),
    ("parallel.serve_devices=2", "check"),
    ("train.ensemble_manual_data=true", "override")])
def test_the_member_axis_serving_mesh_and_manual_data_name_part_2(item,
                                                                  where):
    if where == "override":
        with pytest.raises(NotImplementedError,
                           match="Queue A item 8, part 2"):
            configs.override(configs.get_config("smoke"), [item])
        return
    cfg = configs.override(configs.get_config("smoke"), [item])
    with pytest.raises(NotImplementedError, match="Queue A item 8, part 2"):
        configs.check_supported(cfg)


@pytest.mark.parametrize("what", ["synthetic", "stacked"])
def test_one_process_fits_refuse_a_launch_of_ranks(what, monkeypatch,
                                                   tmp_path):
    """The in-memory fit and the stacked ensemble would train alone on
    each rank: under a launch of two they are refused."""
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 2)
    cfg = configs.get_config("smoke")
    with pytest.raises(NotImplementedError, match="Queue A item 8, part 2"):
        if what == "synthetic":
            trainer.fit_synthetic(cfg, str(tmp_path), 8, device="cpu")
        else:
            trainer.fit_ensemble_parallel(cfg, str(tmp_path), str(tmp_path),
                                          device="cpu")


def test_large_batch_rule_logs_the_mesh_data_ways(caplog):
    """The reference's factorization with the mesh's ways, and its
    effective learning rate."""
    items = ["train.lr_scale_ref_batch=4", "data.batch_size=16"]
    jcfg = jax_train_lib.resolve_large_batch(
        jax_configs.override(jax_configs.get_config("smoke"), items),
        jax_mesh.make_mesh(2))
    with caplog.at_level("INFO"):
        cfg = train_lib.resolve_large_batch(
            configs.override(configs.get_config("smoke"), items),
            _two_ranks())
    assert cfg.train.learning_rate == jcfg.train.learning_rate
    assert "(= 1 accum x 8 device batch x 2 data ways)" in caplog.text


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Raw splits (the port's writer writes the reference's records): 20
    train records in 3 shards, 21 val records in 5 (so an eval batch of 4
    ends padded)."""
    root = str(tmp_path_factory.mktemp("splits"))
    for split, n, shards, seed in (("train", 20, 3, 1), ("val", 21, 5, 2)):
        tfrecord.write_synthetic_split(root, split, n, 32, num_shards=shards,
                                       seed=seed, encoding="raw")
    return root


def _take(data_dir, n, **kw):
    cfg = configs.override(configs.get_config("smoke"), ["data.batch_size=8"])
    it = pipeline.train_batches(data_dir, "train", cfg.data, 32, seed=5,
                                **kw)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_rank_sharded_train_stream_is_the_one_process_stream(splits):
    """Under P = 2 each rank yields its 4 rows of every batch of 8; the
    ranks' rows, concatenated, are the one-process batches (five batches:
    two epochs of 20), so each epoch's union is the one-process epoch and
    the ranks' rows are disjoint records. A batch the ranks do not divide
    is refused with the reference's message."""
    one = _take(splits, 5)
    by_rank = [_take(splits, 5, process_index=p, process_count=2)
               for p in range(2)]
    rows = []
    for k, batch in enumerate(one):
        parts = [r[k] for r in by_rank]
        assert all(tuple(p["image"].shape) == (4, 32, 32, 3) for p in parts)
        for key in ("image", "grade"):
            assert torch.equal(torch.cat([p[key] for p in parts]),
                               batch[key])
        rows += [img.tobytes() for p in parts for img in p["image"].numpy()]
    assert len(set(rows[:20])) == len(set(rows[20:])) == 20
    assert set(rows[:20]) == set(rows[20:])
    with pytest.raises(ValueError, match="not divisible by process_count=3"):
        _take(splits, 1, process_index=0, process_count=3)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("p", [0, 1])
def test_eval_streams_by_process_are_the_references_bitwise(splits, sharded,
                                                            p):
    """Each process's eval batches, sharded before decode or not, equal
    the reference's ``eval_batches_sharded`` / ``eval_batches`` for that
    process index bitwise: its image rows and the whole batch's grades,
    names and mask in the assembled order."""
    read, jread = ((pipeline.eval_batches_sharded,
                    jax_pipeline.eval_batches_sharded) if sharded
                   else (pipeline.eval_batches, jax_pipeline.eval_batches))
    got = list(read(splits, "val", 4, 32, process_index=p, process_count=2))
    want = list(jread(splits, "val", 4, 32, process_index=p,
                      process_count=2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("image", "grade", "mask"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert list(g["name"]) == list(w["name"])
    assert want[-1]["mask"].sum() == 1


def _fit_args(data_dir, workdir):
    return ["--config", "smoke", "--data_dir", data_dir, "--workdir",
            workdir, "--device", "cpu", "--set", "train.steps=4",
            "--set", "train.eval_every=2", "--set", "train.log_every=2",
            "--set", "train.learning_rate=0", "--set", "eval.batch_size=4",
            "--set", "model.image_size=32"]


@pytest.fixture(scope="module")
def cli_fit(splits, tmp_path_factory):
    """A 4-step fit through the train CLI on two gloo ranks
    (``--fake_devices 2 --device cpu``, ``eval.sharded``), and the same
    fit on one process."""
    root = tmp_path_factory.mktemp("cli_fit")
    wd2, wd1 = str(root / "ranks"), str(root / "one")
    from jama16_retina_tpu_torch import train as train_cli

    # The one-process fit runs here while the ranks run.
    ranks_run = subprocess.Popen(
        [sys.executable, "-m", "jama16_retina_tpu_torch.train",
         *_fit_args(splits, wd2), "--fake_devices", "2",
         "--set", "parallel.num_devices=2", "--set", "eval.sharded=true"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with torch_threads(1):
            assert train_cli.main(_fit_args(splits, wd1)) == 0
        stdout, stderr = ranks_run.communicate(timeout=300)
    finally:
        if ranks_run.poll() is None:
            ranks_run.kill()
            ranks_run.communicate()
    assert ranks_run.returncode == 0, stderr[-3000:]
    return wd2, wd1, stdout


def test_cli_fit_over_two_ranks_matches_one_process(cli_fit):
    """The two-rank fit against one process at learning rate 0 (a fit
    computes in float32, whose gradients cancel in the train-mode
    BatchNorm variance, so the float64 bound is the step test's): the
    same eval steps and AUCs (within 1e-6), train losses within 1e-6,
    params bitwise (unmoved) and the BatchNorm running statistics, which
    the ranks update from the global batch's moments, within 1e-4
    relative L2 a leaf: the moments of 8 rows a rank, averaged, round
    otherwise than those of 16. Adam's moments hold the float32 gradient,
    within 1e-2 a leaf. Measured: equal AUCs, statistics at most 7.9e-6
    apart (a running mean near 0), moments 3.2e-3 (cosine 0.999999)."""
    wd2, wd1, stdout = cli_fit
    got, want = (read_jsonl(os.path.join(w, "metrics.jsonl"))
                 for w in (wd2, wd1))
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert got[0]["n_devices"] == 2 and want[0]["n_devices"] == 1
    for g, w in zip(got, want):
        if g["kind"] == "eval":
            assert g["step"] == w["step"]
            assert abs(g["val_auc"] - w["val_auc"]) <= 1e-6
        if g["kind"] == "train":
            assert abs(g["loss"] - w["loss"]) <= 1e-6
    assert json.loads(stdout.strip().splitlines()[-1])["results"] == (
        trainer_results(want))
    a, b = (ckpt_lib.Checkpointer(w) for w in (wd2, wd1))
    assert a.all_steps() == b.all_steps() == {2, 4}
    fa, fb = a.restore(4), b.restore(4)
    for k in fb:
        if k.startswith("batch_stats/"):
            assert _rel(fa[k], fb[k]) <= 1e-4, k
        elif k.startswith(("adam/mu/", "adam/nu/")):
            assert _rel(fa[k], fb[k]) <= 1e-2, k
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def trainer_results(records) -> dict:
    evals = [r for r in records if r["kind"] == "eval"]
    best = max(evals, key=lambda r: r["val_auc"])
    return {"best_auc": best["val_auc"], "best_step": best["step"],
            "stopped_early": False}


def test_rank_0_alone_writes_the_runs_files(cli_fit):
    """The two-rank workdir holds what the one-process one does, and no
    file of rank 1's."""
    wd2, wd1, _ = cli_fit
    assert sorted(os.listdir(wd2)) == sorted(os.listdir(wd1))
    assert not [n for n in os.listdir(wd2) if ".p1" in n or "rank" in n]


def test_fake_devices_needs_the_cpu():
    from jama16_retina_tpu_torch import train as train_cli

    with pytest.raises(SystemExit, match="--device=cpu"):
        train_cli.main(["--config", "smoke", "--fake_devices", "2"])
