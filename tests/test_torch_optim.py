"""The port's learning-rate schedules, AdamW (plain version of kernel B3)
and optimizer-state converter against the JAX package on the CPU.

Tolerances: AdamW rtol 2e-6, atol 1e-7 on params (nu 1e-6 / 1e-8), the
bar of ``test_mixedprec.py:193-236``: optax divides by the bias
correction where the Pallas kernel and the port multiply by its inverse,
and float32 ``pow`` may differ by an ulp between XLA and PyTorch.
Schedules: the constant schedule is equal in float32. The others are
pinned at 2^-22 of the learning rate (a few float32 ulps): XLA folds the
schedule's constants before it runs (a division by the warmup length
becomes a multiply by its reciprocal, ``0.5 * lr`` one constant) and its
float32 ``cos`` rounds differently from PyTorch's; measured up to 1.9e-7
of the learning rate over a 30,000-step cosine (ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import unflatten_dict

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu.models import tiny_cnn as jax_tiny
from jama16_retina_tpu.ops import pallas_opt
from jama16_retina_tpu_torch import configs, models, train_lib
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.ops import adamw
from torch_parity import flat_optax_state, random_flat

I32 = torch.int32


def _both(**kw):
    return (dataclasses.replace(jax_configs.TrainConfig(), **kw),
            dataclasses.replace(configs.TrainConfig(), **kw))


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("steps,warmup", [(12, 4), (9, 500)])
def test_schedule_matches_optax_at_every_step(sched, steps, warmup):
    jtc, ptc = _both(lr_schedule=sched, steps=steps, warmup_steps=warmup,
                     learning_rate=3e-3)
    counts = np.arange(steps + 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jax_train_lib.make_schedule(jtc)))(
        jnp.asarray(counts)), np.float32)
    fn = train_lib.make_schedule(ptc)
    got = np.array([fn(torch.tensor(int(c), dtype=I32)).numpy()
                    for c in counts], np.float32)
    assert got.dtype == np.float32
    if sched == "constant":
        np.testing.assert_array_equal(got, want)
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-22 * 3e-3)


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
            "dense": rng.normal(size=(7, 3)).astype(np.float32),
            "bias": rng.normal(size=(5,)).astype(np.float32)}


def test_plain_adamw_matches_optax_and_pallas_over_three_steps():
    jtc, ptc = _both(lr_schedule="cosine", steps=10, learning_rate=3e-3,
                     weight_decay=0.1)
    start = _leaves(0)
    tx = jax_train_lib.make_optimizer(jtc)
    j_params = {k: jnp.asarray(v) for k, v in start.items()}
    j_state = tx.init(j_params)
    k_params, k_state = j_params, j_state
    names = sorted(start)
    p = [torch.from_numpy(start[k].copy()) for k in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    decay = [t.ndim >= 2 for t in p]
    count = torch.zeros((), dtype=I32)
    sched_count = torch.zeros((), dtype=I32)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in start.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, j_state = tx.update(jg, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        k_params, k_state = pallas_opt.fused_adamw_update(
            jtc, k_params, jg, k_state)
        scalars = adamw.adamw_scalars(count, sched_count,
                                      train_lib.make_schedule(ptc))
        adamw.adamw_reference(p, [torch.from_numpy(g[k]) for k in names],
                              mu, nu, decay, scalars, ptc.weight_decay)
        count += 1
        sched_count += 1
        for i, k in enumerate(names):
            for ref_p, ref_st in ((j_params, j_state), (k_params, k_state)):
                np.testing.assert_allclose(p[i].numpy(), np.asarray(ref_p[k]),
                                           rtol=2e-6, atol=1e-7, err_msg=k)
                np.testing.assert_allclose(mu[i].numpy(),
                                           np.asarray(ref_st[0].mu[k]),
                                           rtol=2e-6, atol=1e-7, err_msg=k)
                np.testing.assert_allclose(nu[i].numpy(),
                                           np.asarray(ref_st[0].nu[k]),
                                           rtol=1e-6, atol=1e-8, err_msg=k)
        assert int(count) == int(j_state[0].count) == int(k_state[0].count)
        assert int(sched_count) == int(j_state[2].count)


def test_b3_wrapper_takes_the_plain_version_on_the_cpu_only():
    leaves = _leaves(1)
    grads = _leaves(2)

    def run(fn):
        p = [torch.from_numpy(v.copy()) for v in leaves.values()]
        mu = [torch.full_like(t, 0.1) for t in p]
        nu = [torch.full_like(t, 0.2) for t in p]
        fn(p, [torch.from_numpy(v) for v in grads.values()], mu, nu,
           [t.ndim >= 2 for t in p], torch.tensor([1e-3, 10.0, 1000.0]), 0.1)
        return p + mu + nu

    before = adamw.launches
    for a, b in zip(run(adamw.fused_adamw_update), run(adamw.adamw_reference)):
        assert torch.equal(a, b)
    assert adamw.launches == before
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="float32"):
        adamw.fused_adamw_update(p, [torch.zeros(4)], p, p, [False],
                                 torch.zeros(3), 0.0)
    with pytest.raises(ValueError, match="scalars"):
        adamw.fused_adamw_update(p, p, p, p, [False], torch.zeros(2), 0.0)


def test_b3_leaf_table_rows_are_the_kernels_struct():
    """The host rows B3's launch copies into its parameter (``struct
    Leaf`` in csrc/adamw.cu: four pointers and the size as int64, then
    the first block and the decay flag as int32) and the block count."""
    sizes = [5, adamw.CHUNK, adamw.CHUNK + 1, 1]
    p = [torch.zeros(n) for n in sizes]
    g, mu, nu = ([torch.zeros(n) for n in sizes] for _ in range(3))
    table, n_blocks = adamw._leaf_table(p, g, mu, nu,
                                        [True, False, True, False])
    assert adamw._LEAF.itemsize == 48
    assert n_blocks == 1 + 1 + 2 + 1
    assert table["first_block"].tolist() == [0, 1, 2, 4]
    assert table["n"].tolist() == sizes
    assert table["decay"].tolist() == [1, 0, 1, 0]
    for col, ts in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        assert table[col].tolist() == [t.data_ptr() for t in ts]


def test_optax_state_converter_round_trips_exactly():
    model = models.build(configs.get_config("smoke").model)
    flat = random_flat(jax_tiny.TinyCNN(num_classes=1), (2, 64, 64, 3), 3)
    params = {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
              if k.startswith("params/")}
    params = unflatten_dict(params, sep="/")
    jtc, _ = _both(weight_decay=0.1)
    tx = jax_train_lib.make_optimizer(jtc)
    st = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    for _ in range(2):
        _, st = tx.update(grads, st, params)
    flat_st = flat_optax_state(st, "adamw")
    port = convert.optax_to_port(flat_st, model, "adamw")
    assert port["count"] == 2 and port["sched_count"] == 2
    names = dict(model.named_parameters())
    moments = port["moments"]
    assert set(moments["mu"]) == set(names) == set(moments["nu"])
    for k, t in moments["mu"].items():
        assert t.shape == names[k].shape
    back = convert.port_to_optax("adamw", moments, port["count"],
                                 port["sched_count"])
    assert set(back) == set(flat_st)
    for k, v in flat_st.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    again = convert.optax_to_port(back, model, "adamw")
    for moment in ("mu", "nu"):
        for k, t in moments[moment].items():
            assert torch.equal(again["moments"][moment][k], t), k
    with pytest.raises(KeyError, match="lacks mu"):
        convert.optax_to_port(
            {k: v for k, v in flat_st.items()
             if k != "adam/mu/Logits/bias"}, model, "adamw")
