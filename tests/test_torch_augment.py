"""The port's augment and its kernels' plain versions (B1
``fused_color_jitter``, B2 ``fused_normalize_color_jitter``) against the
JAX package on the CPU, on the same uint8 batches and augment draws.

The JAX kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them. Tolerances: B1 and the host helpers 1e-6 (float32 reassociation:
XLA may fuse a multiply and an add into one FMA, the port rounds each);
B2 and the whole augment 2e-5, the bar of ``test_mixedprec.py:271-282``
(the JAX kernel sums the means in float32, the port exactly). Geometric
moves are pixel permutations and must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jama16_retina_tpu.configs import DataConfig as JaxDataConfig
from jama16_retina_tpu.data import augment as jax_augment
from jama16_retina_tpu.ops import pallas_augment as pk
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.data import augment
from jama16_retina_tpu_torch.ops import color_jitter as cj

COLOUR_OFF = dict(brightness_delta=0.0, contrast_range=(1.0, 1.0),
                  saturation_range=(1.0, 1.0), hue_delta=0.0)


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _port_cfg(jcfg: JaxDataConfig) -> configs.DataConfig:
    return configs.DataConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(configs.DataConfig)
        if ("data", f.name) not in configs.PORT_FIELDS})


def _t(x):
    return torch.from_numpy(np.array(x))


def _affine(case, b, seed=1):
    rng = np.random.default_rng(seed)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3))
    if case == "identity":
        return eye.copy(), np.zeros((b, 3), np.float32)
    if case == "scale_offset":
        return 0.5 * eye, np.full((b, 3), 0.25, np.float32)
    a = (eye + rng.normal(0.0, 0.3, (b, 3, 3))).astype(np.float32)
    return a, rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["identity", "scale_offset", "random"])
@pytest.mark.parametrize("shape", [(2, 37, 53, 3), (2, 299, 299, 3)])
def test_b1_plain_version_matches_pallas_kernel(shape, case):
    imgs = _images(shape)
    a, o = _affine(case, shape[0])
    want = np.asarray(pk.fused_color_jitter(
        jnp.asarray(imgs), jnp.asarray(a), jnp.asarray(o), interpret=True))
    got = cj.fused_color_jitter(_t(imgs), _t(a), _t(o))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (65, 65), (33, 47)])
def test_b2_plain_version_matches_pallas_kernel(hw):
    rng = np.random.default_rng(11)
    imgs = _images((3, *hw, 3), seed=2)
    sat = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    theta = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    contrast = rng.uniform(0.75, 1.25, 3).astype(np.float32)
    bright = rng.uniform(-0.25, 0.25, 3).astype(np.float32)
    m = np.asarray(pk.chroma_matrix(jnp.asarray(sat), jnp.asarray(theta)))
    want = np.asarray(pk.fused_normalize_color_jitter(
        jnp.asarray(imgs), jnp.asarray(m), jnp.asarray(contrast),
        jnp.asarray(bright), interpret=True))
    got = cj.fused_normalize_color_jitter(_t(imgs), _t(m), _t(contrast),
                                          _t(bright))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(5)
    imgs = _images((4, 19, 23, 3), seed=3)
    sat, theta, contrast, bright = (
        rng.uniform(lo, hi, 4).astype(np.float32)
        for lo, hi in ((0.8, 1.2), (-0.3, 0.3), (0.75, 1.25), (-0.25, 0.25)))
    want_m = pk.chroma_matrix(jnp.asarray(sat), jnp.asarray(theta))
    np.testing.assert_allclose(cj.chroma_matrix(_t(sat), _t(theta)).numpy(),
                               np.asarray(want_m), rtol=0, atol=1e-6)
    want_means = pk.channel_means_u8(jnp.asarray(imgs))
    got_means = cj.channel_means_u8(_t(imgs))
    np.testing.assert_allclose(got_means.numpy(), np.asarray(want_means),
                               rtol=0, atol=1e-6)
    want_a, want_o = pk.color_affine_from_params(
        want_means, jnp.asarray(bright), jnp.asarray(contrast),
        jnp.asarray(sat), jnp.asarray(theta))
    got_a, got_o = cj.color_affine_from_params(
        got_means, _t(bright), _t(contrast), _t(sat), _t(theta))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-6)
    # Colour flags off (saturation 1, hue 0): exactly the identity.
    eye = cj.chroma_matrix(torch.ones(4), torch.zeros(4))
    assert torch.equal(eye, torch.eye(3).expand(4, 3, 3))
    np.testing.assert_array_equal(cj.YIQ2RGB.numpy(),
                                  np.asarray(jax_augment._YIQ2RGB))
    np.testing.assert_array_equal(cj.RGB2YIQ.numpy(),
                                  np.asarray(jax_augment._RGB2YIQ))


def _jax_params(key, n, jcfg):
    return {k: np.asarray(v)
            for k, v in jax_augment._draw_params(key, n, jcfg).items()}


@pytest.mark.parametrize("route", ["jnp", "use_pallas", "fused"])
@pytest.mark.parametrize("colour", ["default", "off"])
@pytest.mark.parametrize("hw", [(41, 41), (33, 47)])
def test_augment_batch_matches_jax_at_injected_draws(route, colour, hw):
    jcfg = JaxDataConfig(use_pallas=route == "use_pallas",
                         **(COLOUR_OFF if colour == "off" else {}))
    imgs = _images((6, *hw, 3), seed=4)
    key = jax.random.key(11)
    want = np.asarray(jax_augment.augment_batch(
        key, jnp.asarray(imgs), jcfg, fused=route == "fused"))
    params = {k: _t(v) for k, v in _jax_params(key, 6, jcfg).items()}
    got = augment.augment_batch(None, _t(imgs), _port_cfg(jcfg),
                                fused=route == "fused", params=params)
    assert got.shape == imgs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_geometric_moves_are_exact(hw):
    """Flips and the square-only transpose select the same pixels as the
    reference's ``_geometric_one`` (the 6x10 shape skips the transpose)."""
    jcfg = JaxDataConfig()
    x = np.random.default_rng(6).normal(size=(16, *hw, 3)).astype(np.float32)
    p = _jax_params(jax.random.key(3), 16, jcfg)
    want = jax.vmap(lambda im, q: jax_augment._geometric_one(im, q, jcfg))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got = augment._geometric(_t(x), {k: _t(v) for k, v in p.items()},
                             _port_cfg(jcfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_off_is_normalize_and_draws_are_in_range():
    imgs = _t(_images((32, 9, 9, 3), seed=8))
    off = dataclasses.replace(configs.DataConfig(), augment=False)
    assert torch.equal(augment.augment_batch(None, imgs, off),
                       augment.normalize(imgs))
    cfg = configs.DataConfig()
    p = augment._draw_params(torch.Generator().manual_seed(0), 32, cfg, "cpu")
    assert p["hflip"].dtype == torch.bool and p["sat_hue"].shape == (32, 2)
    assert float(p["brightness"].abs().max()) <= cfg.brightness_delta
    assert 0.75 <= float(p["contrast"].min()) <= float(p["contrast"].max()) <= 1.25
    again = augment._draw_params(torch.Generator().manual_seed(0), 32, cfg,
                                 "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu_only():
    imgs = _t(_images((2, 5, 7, 3)))
    a, o = (_t(v) for v in _affine("random", 2))
    before = dict(cj.launches)
    assert torch.equal(cj.fused_color_jitter(imgs, a, o),
                       cj.color_jitter_reference(imgs, a, o))
    with pytest.raises(TypeError, match="uint8"):
        cj.fused_color_jitter(imgs.float(), a, o)
    with pytest.raises(ValueError, match="leading dim"):
        cj.fused_color_jitter(imgs, a[:1], o)
    with pytest.raises(ValueError, match="float32"):
        cj.fused_normalize_color_jitter(imgs, a, torch.ones(2, dtype=torch.float64),
                                        torch.zeros(2))
    assert cj.launches == before
