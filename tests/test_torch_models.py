"""Port models (``jama16_retina_tpu_torch/models/``) against the Flax
modules, eval mode, on the same random weights and BN statistics.

Float32 blocks and whole models agree to atol 1e-4: both frameworks sum
the convolutions in different orders, which moves float32 results by a
few ulps per layer and compounds over depth. bfloat16 agrees to a looser
bound stated at its test, because the two frameworks round to bf16 at
some different points (pooling, accumulation inside the conv)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jama16_retina_tpu.models import common as jax_common
from jama16_retina_tpu.models import inception_v3 as jax_inception
from jama16_retina_tpu.models import tiny_cnn as jax_tiny
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch import models as port_models
from jama16_retina_tpu_torch.models import common, convert, inception_v3
from jama16_retina_tpu_torch.models.tiny_cnn import TinyCNN
from torch_parity import random_flat, to_nchw, to_nhwc, variables

F32 = jnp.float32


def _apply_flax(module, flat, x):
    fn = jax.jit(lambda v, x: module.apply(v, x, train=False))
    return fn(variables(flat), jnp.asarray(x))


def _port(module, flat):
    module.load_state_dict(convert.flax_to_torch(flat, module))
    return module.eval().to(memory_format=torch.channels_last)


def _input(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# name, Flax module, port module, input NHWC shape
BLOCKS = [
    ("convbn_1x7_same", jax_common.ConvBN(16, (1, 7), dtype=F32),
     lambda: common.ConvBN(8, 16, (1, 7), dtype=torch.float32), (2, 9, 9, 8)),
    ("convbn_3x3_s2_valid",
     jax_common.ConvBN(16, (3, 3), (2, 2), "VALID", dtype=F32),
     lambda: common.ConvBN(8, 16, (3, 3), (2, 2), "VALID",
                           dtype=torch.float32), (2, 9, 9, 8)),
    ("convbn_3x3_s2_same_even",
     jax_common.ConvBN(16, (3, 3), (2, 2), dtype=F32),
     lambda: common.ConvBN(8, 16, (3, 3), (2, 2), dtype=torch.float32),
     (2, 10, 10, 8)),
    ("inception_a", jax_inception.InceptionA(pool_features=32, dtype=F32),
     lambda: inception_v3.InceptionA(16, 32, dtype=torch.float32),
     (2, 9, 9, 16)),
    ("inception_b", jax_inception.InceptionB(dtype=F32),
     lambda: inception_v3.InceptionB(16, dtype=torch.float32), (2, 9, 9, 16)),
    ("inception_c", jax_inception.InceptionC(channels_7x7=16, dtype=F32),
     lambda: inception_v3.InceptionC(16, 16, dtype=torch.float32),
     (2, 9, 9, 16)),
    ("inception_d", jax_inception.InceptionD(dtype=F32),
     lambda: inception_v3.InceptionD(16, dtype=torch.float32), (2, 9, 9, 16)),
    ("inception_e", jax_inception.InceptionE(dtype=F32),
     lambda: inception_v3.InceptionE(16, dtype=torch.float32), (2, 5, 5, 16)),
]


@pytest.mark.parametrize("name,flax_mod,make_port,shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_parity_float32(name, flax_mod, make_port, shape):
    flat = random_flat(flax_mod, shape, seed=len(name))
    x = _input(shape, seed=1)
    want = np.asarray(_apply_flax(flax_mod, flat, x))
    with torch.inference_mode():
        got = to_nhwc(_port(make_port(), flat)(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_aux_head_parity_float32():
    flax_mod = jax_inception.AuxHead(num_classes=1, dtype=F32)
    shape = (2, 8, 8, 32)
    flat = random_flat(flax_mod, shape, seed=5)
    x = _input(shape, seed=2)
    want = np.asarray(_apply_flax(flax_mod, flat, x))
    with torch.inference_mode():
        got = _port(inception_v3.AuxHead(32, 8, 1, dtype=torch.float32),
                    flat)(to_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def inception75():
    """Inception-v3 at 75 px, aux head off, random weights + inputs."""
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.image_size=75", "model.aux_head=false",
        "model.compute_dtype=float32"])
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=False,
                                         dtype=F32)
    flat = random_flat(flax_mod, (2, 75, 75, 3), seed=3)
    x = _input((2, 75, 75, 3), seed=4)
    return cfg, flat, x


def test_inception_v3_75px_float32_logits(inception75):
    cfg, flat, x = inception75
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=False,
                                         dtype=F32)
    want, aux = _apply_flax(flax_mod, flat, x)
    assert aux is None
    model = _port(port_models.build(cfg.model), flat)
    with torch.inference_mode():
        got, got_aux = model(to_nchw(x))
    assert got_aux is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_inception_v3_75px_bfloat16_logits(inception75):
    """bf16 compute on both sides. Bound: 0.02 absolute on logits of
    magnitude ~0.5 (measured gap 4.3e-3 at these seeds), i.e. a few bf16
    ulps (2^-8 relative) compounded over ~20 conv layers; the float32
    runs of the same weights agree to 1.4e-6, so the gap is where the
    two frameworks round to bf16."""
    cfg, flat, x = inception75
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=False,
                                         dtype=jnp.bfloat16)
    want, _ = _apply_flax(flax_mod, flat, x)
    bf16 = configs.override(cfg, ["model.compute_dtype=bfloat16"])
    model = _port(port_models.build(bf16.model), flat)
    with torch.inference_mode():
        got, _ = model(to_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0.02)


def test_inception_v3_139px_aux_logits_float32():
    """139 px is the smallest input whose Mixed_6e map (5x5) fits the aux
    head's 5x5/3 pool; logits and aux logits both agree to 1e-4."""
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=True,
                                         dtype=F32)
    flat = random_flat(flax_mod, (1, 139, 139, 3), seed=8)
    x = _input((1, 139, 139, 3), seed=9)
    want, want_aux = _apply_flax(flax_mod, flat, x)
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.image_size=139", "model.compute_dtype=float32"])
    model = _port(port_models.build(cfg.model), flat)
    with torch.inference_mode():
        got, got_aux = model(to_nchw(x), with_aux=True)
        assert model(to_nchw(x))[1] is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), rtol=0,
                               atol=1e-4)


def test_inception_v3_299_aux_head_shapes_and_param_count():
    """At 299 px the aux head's second conv is 5x5 as in slim, and the
    port holds the 24.3 M parameters of the Flax model with aux head."""
    model = port_models.build(configs.get_config("eyepacs_binary").model)
    assert model.AuxLogits.Conv2d_2a_5x5.conv.weight.shape == (768, 128, 5, 5)
    assert inception_v3.mixed_6e_size(299) == 17
    flax_mod = jax_inception.InceptionV3(num_classes=1, aux_head=True)
    shapes = jax.eval_shape(lambda: flax_mod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((1, 299, 299, 3)), train=False))
    n_flax = sum(int(np.prod(v.shape))
                 for v in jax.tree.leaves(shapes["params"]))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_flax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_cnn_parity(dtype):
    jdt = F32 if dtype == "float32" else jnp.bfloat16
    flax_mod = jax_tiny.TinyCNN(num_classes=1, dtype=jdt)
    flat = random_flat(flax_mod, (3, 64, 64, 3), seed=6)
    x = _input((3, 64, 64, 3), seed=7)
    want, _ = _apply_flax(flax_mod, flat, x)
    model = _port(TinyCNN(num_classes=1, dtype=common.DTYPES[dtype]), flat)
    with torch.inference_mode():
        got, _ = model(to_nchw(x))
    # Measured gaps at these seeds: 1.2e-7 (float32), 9.3e-4 (bf16).
    atol = 1e-5 if dtype == "float32" else 0.01
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_convert_round_trip_is_identity(inception75):
    cfg, flat, _ = inception75
    model = port_models.build(cfg.model)
    sd = convert.flax_to_torch(flat, model)
    back = convert.torch_to_flax(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    model.load_state_dict(sd)
    again = convert.flax_to_torch(convert.torch_to_flax(model), model)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_convert_refuses_unmatched_missing_and_misshapen_keys(inception75):
    cfg, flat, _ = inception75
    model = port_models.build(cfg.model)
    with pytest.raises(KeyError, match="no match"):
        convert.flax_to_torch({**flat, "params/Nope/conv/kernel":
                               np.zeros((1, 1, 3, 3), np.float32)}, model)
    short = dict(flat)
    del short["batch_stats/Mixed_5b/Branch_0_Conv2d_0a_1x1/bn/var"]
    with pytest.raises(KeyError, match="lacks"):
        convert.flax_to_torch(short, model)
    bad = dict(flat)
    bad["params/Logits/kernel"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        convert.flax_to_torch(bad, model)
