"""The port's EfficientNet (``jama16_retina_tpu_torch/models/
efficientnet.py``) against the Flax module on the CPU, on the same
random weights, BN scales and statistics: the channel and repeat
rounding, MBConv blocks and whole models in eval form (float32 within
1e-4, bf16 logits within 0.02), stochastic depth, the train forward and
gradient in float64 per leaf within 1e-6 with the 0.99 BatchNorm
momentum, and the full-size B4 parameter tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu.models import efficientnet as jax_eff
from jama16_retina_tpu_torch import configs, models, train_lib
from jama16_retina_tpu_torch.models import common, convert, efficientnet
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


@pytest.mark.parametrize("mult", [0.5, 1.0, 1.1, 1.4, 1.8, 2.0])
def test_rounding_matches_flax(mult):
    for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert (efficientnet.round_filters(f, mult)
                == jax_eff.round_filters(f, mult))
    for r in (1, 2, 3, 4):
        assert (efficientnet.round_repeats(r, mult)
                == jax_eff.round_repeats(r, mult))


# name, Flax block, port block, input NHWC shape
BLOCKS = [
    ("no_expand", jax_eff.MBConv(16, 16, 1, 3, 1, 0.0, dtype=F32),
     lambda: efficientnet.MBConv(16, 16, 1, 3, 1, 0.0, dtype=torch.float32),
     (2, 8, 8, 16)),
    ("residual_k5", jax_eff.MBConv(16, 16, 6, 5, 1, 0.0, dtype=F32),
     lambda: efficientnet.MBConv(16, 16, 6, 5, 1, 0.0, dtype=torch.float32),
     (2, 9, 9, 16)),
    ("k3_s2_even", jax_eff.MBConv(16, 24, 6, 3, 2, 0.0, dtype=F32),
     lambda: efficientnet.MBConv(16, 24, 6, 3, 2, 0.0, dtype=torch.float32),
     (2, 10, 10, 16)),
    ("k5_s2_odd", jax_eff.MBConv(8, 16, 6, 5, 2, 0.0, dtype=F32),
     lambda: efficientnet.MBConv(8, 16, 6, 5, 2, 0.0, dtype=torch.float32),
     (2, 11, 11, 8)),
]


@pytest.mark.parametrize("name,flax_mod,make_port,shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_mbconv_parity_float32(name, flax_mod, make_port, shape):
    """Depthwise convs with XLA's SAME padding (asymmetric for a 3x3/2 on
    an even size), squeeze-and-excitation with conv biases, the
    residual where stride 1 and widths agree."""
    flat = random_flat(flax_mod, shape, seed=len(name))
    x = _input(shape, seed=1)
    want = np.asarray(flax_mod.apply(variables(flat), jnp.asarray(x),
                                     train=False))
    with torch.inference_mode():
        got = to_nhwc(_port(make_port(), flat)(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# name, (width_mult, depth_mult), image size
NETS = [("w0.5_d0.5", (0.5, 0.5), 64), ("b4_width_shallow", (1.4, 0.3), 48)]


@pytest.fixture(scope="module", params=NETS, ids=[n[0] for n in NETS])
def net(request):
    """Weights of an EfficientNet of this width and depth (every scale in
    [0.5, 1.5]), batch 2 and its input; the running statistics are the
    input's own (``calibrated``)."""
    _, (w, d), px = request.param
    shape = (2, px, px, 3)
    flat = random_flat(jax_eff.EfficientNet(width_mult=w, depth_mult=d,
                                            dtype=F32), shape, seed=5)
    x = _input(shape, seed=6)
    flat = calibrated(flat, efficientnet.EfficientNet(
        width_mult=w, depth_mult=d, drop_connect_rate=0.0,
        dtype=torch.float64), x)
    return {"w": w, "d": d, "flat": flat, "x": x}


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 0.02)])
def test_efficientnet_logits(net, dtype, atol):
    """Whole model in eval form, the Flax side compiled as written
    (``apply_as_written``): float32 logits within 1e-4 (measured
    1.7e-5 / 7.7e-6); bf16 within 0.02, as Inception-v3's (measured
    2.1e-7 / 5.7e-3)."""
    tdt = common.DTYPES[dtype]
    want = apply_as_written(jax_eff.EfficientNet(
        width_mult=net["w"], depth_mult=net["d"],
        dtype=jnp.dtype(dtype)), net["flat"], net["x"], jnp.float32)
    model = _port(efficientnet.EfficientNet(
        width_mult=net["w"], depth_mult=net["d"], dtype=tdt), net["flat"])
    with torch.inference_mode():
        got, aux = model(to_nchw(net["x"]))
    assert aux is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _flax_drop_rates(module, shape) -> "dict[str, float]":
    """Each MBConv's ``drop_rate`` as the Flax module builds it."""
    rates = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_eff.MBConv):
            rates[context.module.name] = context.module.drop_rate
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda: module.init(
            {"params": jax.random.key(0)}, jnp.zeros(shape), train=False))
    return rates


def test_stochastic_depth_rates_match_flax_exactly():
    """B4 from the preset: 32 blocks, per-block rates 0.2 * i / 32
    exactly as the Flax module computes them; stem 48, head 1792."""
    cfg = configs.get_config("efficientnet_b4")
    model = models.build(cfg.model)
    want = _flax_drop_rates(jax_models.build(jax_configs.get_config(
        "efficientnet_b4").model), (1, 64, 64, 3))
    got = {n: model._modules[n].drop_rate for n in model.block_names}
    assert len(got) == 32 and got == want
    assert model.stem_conv.out_channels == 48
    assert model.head_conv.out_channels == 1792
    assert model.dropout_rate == 0.4


def test_stochastic_depth_drops_whole_examples_and_scales_kept_by_keep():
    """A residual block in train form at drop rate 0.5 over 64 examples:
    a dropped example's output is its input exactly; a kept one's is the
    branch (``project_bn``'s output) / keep + input exactly. The mask
    comes from the generator: the same seed drops the same examples."""
    block = efficientnet.MBConv(8, 8, 6, 3, 1, 0.5, dtype=torch.float32)
    x = to_nchw(_input((64, 5, 5, 8), seed=2))
    branch = []
    block.project_bn.register_forward_hook(
        lambda m, args, out: branch.append(out))
    outs = [block(x, train=True, generator=torch.Generator().manual_seed(s))
            .detach() for s in (3, 3, 4)]
    kept = [(o - x).flatten(1).abs().amax(1) > 0 for o in outs]
    assert torch.equal(kept[0], kept[1]) and not torch.equal(kept[0], kept[2])
    assert 16 <= int(kept[0].sum()) <= 48
    k = kept[0]
    assert torch.equal(outs[0][~k], x[~k])
    want = branch[0].detach() / 0.5 + x
    assert torch.equal(outs[0][k], want[k])


def test_efficientnet_b4_full_size_tree_converts_with_no_key_left_over():
    """The ``jax.eval_shape`` tree of the preset's model at 299 px maps
    onto the port's model key for key (418 parameter leaves, 192
    statistics, 17,550,409 parameters) and back."""
    cfg = configs.get_config("efficientnet_b4")
    flat = random_flat(jax_models.build(jax_configs.get_config(
        "efficientnet_b4").model), (1, 299, 299, 3), seed=0)
    model = models.build(cfg.model)
    sd = convert.flax_to_torch(flat, model)
    assert set(sd) == set(model.state_dict())
    assert sum(k.startswith("params/") for k in flat) == 418
    assert sum(k.startswith("batch_stats/") for k in flat) == 192
    assert sum(p.numel() for p in model.parameters()) == 17_550_409
    assert set(convert.torch_to_flax(sd)) == set(flat)


@pytest.mark.parametrize("arch,momentum", [
    ("inception_v3", 0.9), ("resnet50", 0.9), ("efficientnet_b4", 0.99),
    ("tiny_cnn", 0.9)])
def test_batchnorm_momentum_per_arch(arch, momentum):
    """EfficientNet's 0.99 stays in EfficientNet: every BatchNorm of the
    other archs keeps 0.9, and a train forward updates Inception-v3's
    statistics at 0.9."""
    cfg = configs.override(configs.get_config("smoke"), [
        f"model.arch={arch}", "model.compute_dtype=float32"])
    model = models.build(cfg.model)
    bns = [m for m in model.modules() if isinstance(m, common.BatchNorm)]
    assert bns and {m.momentum for m in bns} == {momentum}
    if arch == "inception_v3":
        bn = model.Conv2d_1a_3x3.bn
        x = torch.randn(2, 3, 75, 75)
        y = model.Conv2d_1a_3x3.conv(x)
        model.Conv2d_1a_3x3(x, train=True)
        assert torch.allclose(bn.mean, 0.1 * y.mean(dim=(0, 2, 3)),
                              rtol=1e-5, atol=1e-7)


def test_efficientnet_train_grads_match_flax_per_leaf_in_float64(
        monkeypatch):
    """Train form at width 0.5, depth 0.5 (10 blocks, 3 with a residual),
    batch 4 at 48 px, dropout and stochastic depth 0, the 5-class head
    with label smoothing 0.1, both sides in float64 (the Flax module's
    float32 BatchNorms and head made float64; the port's head stays
    float32): loss and logits within 1e-6, every running statistic
    (momentum 0.99) within rtol 1e-6, every gradient leaf within 1e-6
    relative L2 (measured 1.7e-7; ``relative_l2_per_leaf`` holds the
    ten leaves whose true gradient is 0 against its floor)."""
    shape = (4, 48, 48, 3)
    kw = dict(num_classes=5, width_mult=0.5, depth_mult=0.5,
              dropout_rate=0.0, drop_connect_rate=0.0)
    flat = random_flat(jax_eff.EfficientNet(dtype=F32, **kw), shape, seed=7)
    x = _input(shape, seed=8)
    grades = np.array([0, 2, 4, 1], np.int32)

    def loss_of(logits, aux):
        labels = jax_train_lib._labels_from_grades(jnp.asarray(grades),
                                                   "multi")
        return jax_train_lib._head_loss(logits, labels, "multi", 0.1, None)

    monkeypatch.setattr(jax_eff, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        loss, logits, stats, grads = flax_train(
            jax_eff.EfficientNet(dtype=jnp.float64, **kw),
            {k: a.astype(np.float64) for k, a in flat.items()},
            x.astype(np.float64), loss_of)

    model = efficientnet.EfficientNet(dtype=torch.float64, **kw)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    model = model.to(torch.float64, memory_format=torch.channels_last)
    model.Logits.float()
    assert sum(model._modules[n].residual for n in model.block_names) == 3
    cfg = configs.override(configs.get_config("icdr5"),
                           ["model.arch=efficientnet_b4"])
    assert cfg.train.label_smoothing == 0.1
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
    # The leaves held against the floor (true gradient 0): the biases of
    # every project_bn, each followed by train-mode BatchNorms only.
    total = np.sqrt(sum(np.sum(np.square(g)) for g in grads.values()))
    zero = {k for k, g in grads.items() if np.linalg.norm(g) < 1e-9 * total}
    assert zero == {f"params/{n}/project_bn/bias" for n in model.block_names}
