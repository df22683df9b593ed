"""The port's ResNet-50 (``jama16_retina_tpu_torch/models/resnet.py``)
against the Flax module on the CPU, on the same random weights, BN
scales and statistics: the SAME max pool, bottleneck blocks and the
whole model in eval form (float32 within 1e-4, bf16 logits within
0.02), the train forward and gradient in float64 per leaf within 1e-6,
and the full-size parameter tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu.models import resnet as jax_resnet
from jama16_retina_tpu_torch import configs, models, train_lib
from jama16_retina_tpu_torch.models import common, convert, resnet
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (Float64Numpy, apply_as_written, calibrated,
                          flax_train, random_flat, relative_l2_per_leaf,
                          to_nchw, to_nhwc, variables)

F32 = jnp.float32


def _port(module, flat):
    module.load_state_dict(convert.flax_to_torch(flat, module))
    return module.eval().to(memory_format=torch.channels_last)


def _input(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("size", [150, 75, 9, 8, 1])
def test_same_max_pool_matches_flax(size):
    """3x3/2 SAME: XLA pads (0, 1) on 150 cells and (1, 1) on 75; the
    port pads with -inf and pools VALID. Bitwise, in bf16 too."""
    x = np.random.default_rng(size).normal(size=(2, size, size + 1, 4))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(nn.max_pool(jnp.asarray(x, jdt), (3, 3), (2, 2),
                                      padding="SAME"), np.float32)
        got = to_nhwc(common.max_pool_same(to_nchw(x).to(tdt)))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# name, Flax block, port block, input NHWC shape
BLOCKS = [
    ("identity", jax_resnet.Bottleneck(8, dtype=F32),
     lambda: resnet.Bottleneck(32, 8, dtype=torch.float32), (2, 7, 7, 32)),
    ("projection", jax_resnet.Bottleneck(8, dtype=F32),
     lambda: resnet.Bottleneck(16, 8, dtype=torch.float32), (2, 7, 7, 16)),
    ("stride2_odd", jax_resnet.Bottleneck(8, (2, 2), dtype=F32),
     lambda: resnet.Bottleneck(32, 8, 2, dtype=torch.float32),
     (2, 9, 9, 32)),
    ("stride2_even", jax_resnet.Bottleneck(8, (2, 2), dtype=F32),
     lambda: resnet.Bottleneck(16, 8, 2, dtype=torch.float32),
     (2, 10, 10, 16)),
]


@pytest.mark.parametrize("name,flax_mod,make_port,shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_bottleneck_parity_float32(name, flax_mod, make_port, shape):
    flat = random_flat(flax_mod, shape, seed=len(name))
    x = _input(shape, seed=1)
    want = np.asarray(flax_mod.apply(variables(flat), jnp.asarray(x),
                                     train=False))
    with torch.inference_mode():
        got = to_nhwc(_port(make_port(), flat)(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _residual_scaled(flat: dict, factor: float = 0.1) -> dict:
    """``flat`` with the scale of each residual branch's last BatchNorm
    (``bn3``) multiplied by ``factor``: the small-scale residual init of
    Goyal et al. (2017), which keeps a random ResNet well conditioned.
    With every scale in [0.5, 1.5] a perturbation grows about 1.3x a
    block, and at 64 px the float32 logits of either framework lie
    2.5-2.7e-4 from the float64 ones (bf16: over 1), which would measure
    the random network, not the port (ROADMAP.md Queue C)."""
    return {k: v * factor if k.endswith("/bn3/scale") else v
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def resnet64():
    """Full-depth ResNet-50 weights at 64 px, batch 2, and its input; the
    running statistics are the input's own (``calibrated``). Returns
    the tree with scales near 1 and its ``_residual_scaled`` form."""
    flat = random_flat(jax_resnet.ResNet50(dtype=F32), (2, 64, 64, 3), seed=5)
    x = _input((2, 64, 64, 3), seed=6)
    return {"near_one": calibrated(flat, resnet.ResNet50(dtype=torch.float64),
                                   x),
            "scaled": calibrated(_residual_scaled(flat),
                                 resnet.ResNet50(dtype=torch.float64), x),
            "x": x}


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 0.02)])
def test_resnet50_64px_logits(resnet64, dtype, atol):
    """Whole model, full depth (3-4-6-3), eval form, built from the
    ``resnet50`` preset on the ``_residual_scaled`` tree, the Flax side
    compiled as written (``apply_as_written``): float32 logits within
    1e-4 (measured 9.5e-7); bf16 logits within 0.02, as Inception-v3's
    (measured 9.4e-3: the two round conv sums to bf16 at the same points
    but sum them in other orders, and a sum on either side of a rounding
    boundary moves on through the net; each framework's bf16 lies
    1.4-1.8e-2 from the float64 logits)."""
    flat, x = resnet64["scaled"], resnet64["x"]
    sets = [f"model.compute_dtype={dtype}", "model.image_size=64"]
    jcfg = jax_configs.override(jax_configs.get_config("resnet50"), sets)
    cfg = configs.override(configs.get_config("resnet50"), sets)
    want = apply_as_written(jax_models.build(jcfg.model), flat, x,
                            jnp.float32)
    model = _port(models.build(cfg.model), flat)
    assert isinstance(model, resnet.ResNet50)
    with torch.inference_mode():
        got, aux = model(to_nchw(x))
    assert aux is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_resnet50_64px_float64_logits_with_scales_near_one(resnet64,
                                                           monkeypatch):
    """The same model on the tree with every scale in [0.5, 1.5], both
    sides in float64 (the Flax module's float32 BatchNorms made
    float64; the port's head stays float32): logits within 1e-6."""
    flat, x = resnet64["near_one"], resnet64["x"]
    monkeypatch.setattr(jax_resnet, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        want, _ = jax.jit(lambda v, x: jax_resnet.ResNet50(
            dtype=jnp.float64).apply(v, x, train=False))(
            variables({k: a.astype(np.float64) for k, a in flat.items()}),
            jnp.asarray(x, jnp.float64))
    model = resnet.ResNet50(dtype=torch.float64)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    model = model.double().eval()
    model.Logits.float()
    with torch.inference_mode():
        got, _ = model(to_nchw(x).double())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_resnet50_full_size_tree_converts_with_no_key_left_over():
    """The ``jax.eval_shape`` tree of the preset's model at 299 px maps
    onto the port's model key for key (161 parameter leaves, 106
    statistics, 23,510,081 parameters) and back."""
    cfg = configs.get_config("resnet50")
    flat = random_flat(jax_models.build(jax_configs.get_config(
        "resnet50").model), (1, 299, 299, 3), seed=0)
    model = models.build(cfg.model)
    sd = convert.flax_to_torch(flat, model)
    assert set(sd) == set(model.state_dict())
    assert sum(k.startswith("params/") for k in flat) == 161
    assert sum(k.startswith("batch_stats/") for k in flat) == 106
    assert sum(p.numel() for p in model.parameters()) == 23_510_081
    assert set(convert.torch_to_flax(sd)) == set(flat)


def test_resnet50_train_grads_match_flax_per_leaf_in_float64(monkeypatch):
    """Train form at stage sizes (2, 1, 1, 1) (identity and projection
    shortcuts, stride 1 and 2), batch 4 at 64 px, dropout 0, both sides
    in float64 (the Flax module's float32 BatchNorms and head made
    float64; the port's head stays float32): loss and logits within
    1e-6, every running statistic (momentum 0.9) within rtol 1e-6, and
    every gradient leaf within 1e-6 relative L2."""
    stages = (2, 1, 1, 1)
    shape = (4, 64, 64, 3)
    flat = random_flat(jax_resnet.ResNet50(dtype=F32, stage_sizes=stages),
                       shape, seed=7)
    monkeypatch.setattr(jax_resnet, "jnp", Float64Numpy())
    x = _input(shape, seed=8)
    grades = np.array([0, 2, 4, 1], np.int32)

    def loss_of(logits, aux):
        labels = jax_train_lib._labels_from_grades(jnp.asarray(grades),
                                                   "binary")
        return jax_train_lib._head_loss(logits, labels, "binary", 0.0, None)

    with jax.enable_x64(True):
        loss, logits, stats, grads = flax_train(
            jax_resnet.ResNet50(dropout_rate=0.0, dtype=jnp.float64,
                                stage_sizes=stages),
            {k: a.astype(np.float64) for k, a in flat.items()},
            x.astype(np.float64), loss_of)

    model = resnet.ResNet50(dropout_rate=0.0, dtype=torch.float64,
                            stage_sizes=stages)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    model = model.to(torch.float64, memory_format=torch.channels_last)
    model.Logits.float()
    cfg = configs.override(configs.get_config("resnet50"),
                           ["model.dropout_rate=0.0"])
    got_logits, aux = model(to_nchw(x).to(torch.float64), train=True)
    got_loss = train_lib.loss_fn(got_logits, aux, torch.from_numpy(grades),
                                 cfg)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), loss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_logits.detach().numpy(), logits, rtol=0,
                               atol=1e-6)
    got_stats = {k: v for k, v in convert.torch_to_flax(model).items()
                 if k.startswith("batch_stats/")}
    assert sorted(got_stats) == sorted(stats)
    for k in stats:
        np.testing.assert_allclose(got_stats[k], stats[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    per_leaf = relative_l2_per_leaf(convert.torch_to_flax(
        {k: p.grad for k, p in model.named_parameters()}), grads)
    assert len(per_leaf) == sum(k.startswith("params/") for k in flat)
    worst = max(per_leaf, key=per_leaf.get)
    assert per_leaf[worst] <= 1e-6, (worst, per_leaf[worst])
