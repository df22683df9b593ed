"""The optimizer families beyond AdamW (``optim.py``: sgdm, rmsprop, lamb
and the gradient clip), their optax-state converters and checkpoints,
against the JAX package on the CPU.

Both sides start from the same numpy weights of ``tiny_cnn``
(``torch_parity.random_flat``) and take the same gradients. Tolerances
are stated at each test with what was measured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu.data import augment as jax_augment
from jama16_retina_tpu.models import tiny_cnn as jax_tiny
from jama16_retina_tpu_torch import configs, models, optim, train_lib
from jama16_retina_tpu_torch.data import synthetic
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import (flat_optax_state, one_torch_thread,  # noqa: F401
                          random_flat, relative_l2_per_leaf, variables)

FAMILIES = ("sgdm", "rmsprop", "lamb")


def _both(**kw):
    return (dataclasses.replace(jax_configs.TrainConfig(), **kw),
            dataclasses.replace(configs.TrainConfig(), **kw))


def _tiny(seed: int = 5):
    """(flat Flax tree, port tiny_cnn loaded from it)."""
    flat = random_flat(jax_tiny.TinyCNN(num_classes=1), (2, 64, 64, 3), seed)
    model = models.build(configs.get_config("smoke").model)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    return flat, model


def _params_tree(flat):
    return unflatten_dict({k[len("params/"):]: jnp.asarray(v)
                           for k, v in flat.items()
                           if k.startswith("params/")}, sep="/")


def _flat_params(tree) -> dict:
    return {"params/" + k: np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def _port_grads(flat_grads, flat, model) -> "list[torch.Tensor]":
    """Flax-layout gradients in the port's layout and parameter order."""
    sd = convert.flax_to_torch(
        {**flat_grads, **{k: v for k, v in flat.items()
                          if k.startswith("batch_stats/")}}, model)
    return [sd[k] for k, _ in model.named_parameters()]


@pytest.mark.parametrize("sched", ["cosine", "warmup_cosine"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_optax_over_three_updates(family, clip, sched):
    """Three updates of ``optim.apply_update`` against the JAX package's
    ``make_optimizer`` (optax) on the same gradients: every parameter and
    every state leaf within 1e-6 relative L2 per leaf (measured at most
    8.1e-7, in LAMB's nu behind the clip; 7.7e-7 in rmsprop's trace; 0
    for sgdm without the clip: the clip's global norm and LAMB's
    trust-ratio norms sum in another order), the counts equal. The gradients are unit normals
    over ~25k parameters, so the clip at 1.0 scales every update."""
    jtc, ptc = _both(optimizer=family, gradient_clip_norm=clip,
                     lr_schedule=sched, steps=10, warmup_steps=2,
                     learning_rate=3e-3, weight_decay=0.1, momentum=0.9)
    flat, model = _tiny()
    tx = jax_train_lib.make_optimizer(jtc)
    j_params = _params_tree(flat)
    j_state = tx.init(j_params)
    params = [p.detach() for p in model.parameters()]
    names = [k for k, _ in model.named_parameters()]
    state = train_lib._opt_fields(family, dict(model.named_parameters()),
                                  "cpu")
    moms = {n: [state[n][k] for k in names] for n in optim.MOMENTS[family]}
    schedule = train_lib.make_schedule(ptc)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in flat.items() if k.startswith("params/")}
        upd, j_state = tx.update(_params_tree(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        optim.apply_update(family, ptc, params, _port_grads(g, flat, model),
                           moms, state["count"], state["sched_count"],
                           schedule)
        if state["count"] is not None:
            state["count"] += 1
        state["sched_count"] += 1
    got = {k: v for k, v in convert.torch_to_flax(model).items()
           if k.startswith("params/")}
    worst = relative_l2_per_leaf(got, _flat_params(j_params))
    want_st = flat_optax_state(j_state, family)
    got_st = convert.port_to_optax(
        family, {n: state[n] for n in optim.MOMENTS[family]},
        None if state["count"] is None else int(state["count"]),
        int(state["sched_count"]))
    assert set(got_st) == set(want_st)
    for k in want_st:
        if k.endswith("count"):
            assert int(got_st[k]) == int(want_st[k]) == 3, k
    worst.update(relative_l2_per_leaf(
        {k: v for k, v in got_st.items() if not k.endswith("count")},
        {k: v for k, v in want_st.items() if not k.endswith("count")}))
    top = max(worst, key=worst.get)
    assert worst[top] <= 1e-6, (top, worst[top])


def _optax_state_after_updates(family: str, clip: float):
    jtc, _ = _both(optimizer=family, gradient_clip_norm=clip,
                   weight_decay=0.1)
    flat, model = _tiny()
    params = _params_tree(flat)
    tx = jax_train_lib.make_optimizer(jtc)
    st = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    for _ in range(2):
        _, st = tx.update(grads, st, params)
    return flat_optax_state(st, family), model


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("family", ("adamw",) + FAMILIES)
def test_optax_state_round_trips_bitwise(family, clip):
    """An optax state after two updates -> the port's state -> the flat
    optax form is bit for bit the one it came from, and back to the port
    again equal; the clip's empty state adds no key. A missing leaf
    raises naming the moment."""
    flat_st, model = _optax_state_after_updates(family, clip)
    port = convert.optax_to_port(flat_st, model, family)
    assert port["sched_count"] == 2
    assert port["count"] == (2 if family in optim.COUNTED else None)
    names = dict(model.named_parameters())
    assert set(port["moments"]) == set(optim.MOMENTS[family])
    for mom in port["moments"].values():
        assert set(mom) == set(names)
        assert all(t.shape == names[k].shape for k, t in mom.items())
    back = convert.port_to_optax(family, port["moments"], port["count"],
                                 port["sched_count"])
    assert set(back) == set(flat_st)
    for k, v in flat_st.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    again = convert.optax_to_port(back, model, family)
    for name, mom in port["moments"].items():
        for k, t in mom.items():
            assert torch.equal(again["moments"][name][k], t), (name, k)
    assert convert.optax_family(flat_st) == family
    name = optim.MOMENTS[family][-1]
    gone = f"{convert.OPT_PREFIXES[family][name]}/Logits/bias"
    with pytest.raises(KeyError, match=f"lacks {name}"):
        convert.optax_to_port({k: v for k, v in flat_st.items()
                               if k != gone}, model, family)


def _smoke(*items):
    return configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "model.dropout_rate=0.0",
        "train.steps=10", "train.weight_decay=0.01", *items])


def _batch(n: int = 8, seed: int = 3):
    images, grades = synthetic.make_dataset(
        n, synthetic.SynthConfig(image_size=64), seed=seed)
    return images, grades, {"image": torch.from_numpy(images),
                            "grade": torch.from_numpy(grades)}


@pytest.mark.parametrize("family", ("adamw",) + FAMILIES)
def test_checkpoint_holds_each_family(family, tmp_path):
    """Two ``train_step``s of each family (behind the clip), saved by the
    ``Checkpointer``, restored into a fresh state: params, statistics,
    every moment and both counts equal bit for bit, and the flat form
    names the family."""
    cfg = _smoke(f"train.optimizer={family}", "train.gradient_clip_norm=1.0")
    _, _, batch = _batch()
    state = train_lib.create_state(cfg, _tiny()[1], "cpu")
    for _ in range(2):
        train_lib.train_step(state, batch, cfg)
    flat = train_lib.state_to_flat(state)
    assert convert.optax_family(flat) == family
    ckpt = ckpt_lib.Checkpointer(str(tmp_path))
    ckpt.save(2, flat, {"val_auc": 0.5})
    fresh = train_lib.create_state(cfg, models.build(cfg.model), "cpu")
    train_lib.load_state_flat(fresh, ckpt.restore(2))
    assert fresh.step == 2 and fresh.optimizer == family
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for name, mom in train_lib.moments(state).items():
        for k, t in mom.items():
            assert torch.equal(t, getattr(fresh, name)[k]), (name, k)
    assert torch.equal(fresh.sched_count, state.sched_count)
    assert (fresh.count is None) == (family not in optim.COUNTED)
    if fresh.count is not None:
        assert int(fresh.count) == int(state.count) == 2


@pytest.mark.parametrize("saved,loaded", [("lamb", "adamw"),
                                          ("sgdm", "rmsprop"),
                                          ("adamw", "sgdm")])
def test_loading_another_familys_checkpoint_raises_naming_both(saved, loaded):
    model = models.build(configs.get_config("smoke").model)
    src = train_lib.create_state(_smoke(f"train.optimizer={saved}"), model,
                                 "cpu")
    dst = train_lib.create_state(
        _smoke(f"train.optimizer={loaded}"),
        models.build(configs.get_config("smoke").model), "cpu")
    with pytest.raises(ValueError, match=f"{saved}.*{loaded}"):
        train_lib.load_state_flat(dst, train_lib.state_to_flat(src))


@pytest.mark.parametrize("family", ["sgdm", "lamb"])
def test_train_step_matches_jax_for_three_steps(family):
    """Three ``train_lib.train_step``s of the smoke step (B1's plain
    version, float32, dropout 0, clip 1.0) against ``make_train_step``
    with the same augment draws: the loss per step within 1e-5 (measured
    9.5e-7), after the third step the params and batch statistics within
    2e-5 absolute (measured 5.1e-6 sgdm, 6.0e-6 lamb), the counts equal,
    and the family's optax state within 1e-4 relative L2 over all its
    leaves (measured 3.6e-5 each). Per leaf the state differs more (up
    to 4e-4 in a BatchNorm bias's nu): the float32 train gradient of
    leaves whose BatchNorm cancels them is ill-conditioned (ROADMAP
    Queue C, "The Inception-v3 float32 train gradient")."""
    sets = ["model.compute_dtype=float32", "model.dropout_rate=0.0",
            "train.steps=10", "train.lr_schedule=warmup_cosine",
            "train.weight_decay=0.01", "data.use_pallas=true",
            f"train.optimizer={family}", "train.gradient_clip_norm=1.0"]
    jcfg = jax_configs.override(jax_configs.get_config("smoke"), sets)
    cfg = configs.override(configs.get_config("smoke"), sets)
    jmodel = jax_models.build(jcfg.model)
    flat = random_flat(jmodel, (2, 64, 64, 3), seed=12)
    v = variables(flat)
    tx = jax_train_lib.make_optimizer(jcfg.train)
    jstate = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    jstep = jax_train_lib.make_train_step(jcfg, jmodel, tx, donate=False)
    base_key = jax.random.key(0)
    model = models.build(cfg.model)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    state = train_lib.create_state(cfg, model, "cpu")
    images, grades, batch = _batch()
    jbatch = {"image": jnp.asarray(images), "grade": jnp.asarray(grades)}
    for s in range(3):
        aug_key, _ = jax.random.split(jax.random.fold_in(base_key, s))
        drawn = jax_augment._draw_params(aug_key, 8, jcfg.data)
        jstate, m = jstep(jstate, jbatch, base_key)
        loss = train_lib.train_step(
            state, batch, cfg,
            augment_params={k: torch.from_numpy(np.array(a))
                            for k, a in drawn.items()})
        assert abs(float(loss) - float(m["loss"])) <= 1e-5, s
    want = {**_flat_params(jstate.params),
            **{"batch_stats/" + k: np.asarray(a) for k, a in flatten_dict(
                jstate.batch_stats, sep="/").items()},
            **flat_optax_state(jstate.opt_state, family)}
    got = {**convert.torch_to_flax(state.model),
           **convert.port_to_optax(
               family, train_lib.moments(state),
               None if state.count is None else int(state.count),
               int(state.sched_count))}
    assert set(got) == set(want)
    for k in ("schedule/count", convert.OPT_COUNTS.get(family)):
        if k is not None:
            assert int(got.pop(k)) == int(want.pop(k)) == 3, k
    want = {k: np.asarray(w) for k, w in want.items()}
    model_keys = [k for k in want if k.startswith(("params/",
                                                   "batch_stats/"))]
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in model_keys)
    opt_keys = sorted(set(want) - set(model_keys))

    def norm(d):
        return np.sqrt(sum(np.sum(np.square(d[k].astype(np.float64)))
                           for k in opt_keys))

    diff = {k: got[k].astype(np.float64) - want[k] for k in opt_keys}
    rel = norm(diff) / norm(want)
    assert worst <= 2e-5 and rel <= 1e-4, (worst, rel)
