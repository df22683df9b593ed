"""Fused serve preprocess of the port (``jama16_retina_tpu_torch/ops/
serve_preprocess.py``) against the JAX package's
(``jama16_retina_tpu/ops/pallas_serve.py``).

The port's plain version is what its CUDA kernel is held to bit for bit
on the card; here, on the CPU, it is held against the JAX reference and
the Pallas kernel in interpret mode.

Rows: the port computes ``x * float32(1/127.5) - 1`` with two rounded
operations (the CUDA kernel forbids FMA contraction). XLA's CPU backend
contracts the same expression into one FMA, so the JAX rows differ by
at most one float32 ulp of 1.0 (2^-23), and are exactly the
single-rounding values. Both facts are pinned below.

Statistics: the port sums exactly in int64; the JAX kernel sums in
float32, inexact past 2^24, so the float64 statistics agree to 1e-6.
"""

import numpy as np
import pytest
import torch

from jama16_retina_tpu.obs import quality as quality_lib
from jama16_retina_tpu.ops import pallas_serve
from jama16_retina_tpu_torch.ops import serve_preprocess as sp
from jama16_retina_tpu_torch.serve import host

SHAPES = [(1, 8, 8, 3), (3, 32, 32, 3), (2, 128, 128, 3), (2, 299, 299, 3)]
ULP_AT_ONE = float(np.finfo(np.float32).eps)  # 2^-23


def _images(shape, seed=7):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _port(imgs):
    norm, sums = sp.serve_preprocess_reference(torch.from_numpy(imgs))
    return norm.numpy(), sp.stats_from_sums(sums, imgs.shape[1] * imgs.shape[2])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_against_jax_reference_and_interpret_kernel(shape):
    imgs = _images(shape)
    norm, stats = _port(imgs)
    assert norm.dtype == np.float32 and norm.shape == shape
    assert stats.dtype == np.float64 and stats.shape == (shape[0], 4)
    xf = imgs.astype(np.float32)
    c = np.float32(1.0 / 127.5)
    two_roundings = xf * c - np.float32(1.0)
    one_rounding = (imgs.astype(np.float64) * np.float64(c) - 1.0).astype(
        np.float32)
    np.testing.assert_array_equal(norm, two_roundings)
    for jax_norm, jax_stats in (
        pallas_serve.serve_preprocess_reference(imgs),
        pallas_serve.fused_serve_preprocess(imgs, interpret=True),
    ):
        jax_norm = np.asarray(jax_norm)
        np.testing.assert_array_equal(jax_norm, one_rounding)
        assert np.max(np.abs(jax_norm - norm)) <= ULP_AT_ONE
        np.testing.assert_allclose(stats, np.asarray(jax_stats), rtol=0,
                                   atol=1e-6)


def test_sums_are_exact_integers():
    imgs = _images((2, 299, 299, 3), seed=11)
    _, sums = sp.serve_preprocess_reference(torch.from_numpy(imgs))
    wide = imgs.reshape(2, -1, 3).astype(np.int64)
    want = np.concatenate([wide.sum(1), (wide ** 2).sum((1, 2))[:, None]], 1)
    assert sums.dtype == torch.int64
    np.testing.assert_array_equal(sums.numpy(), want)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    imgs = torch.from_numpy(_images((3, 37, 53, 3)))
    before = sp.launches
    norm_w, sums_w = sp.fused_serve_preprocess(imgs)
    norm_p, sums_p = sp.serve_preprocess_reference(imgs)
    assert sp.launches == before
    assert torch.equal(norm_w, norm_p) and torch.equal(sums_w, sums_p)


def test_flat_and_constant_images_use_float64_epilogue():
    """Near-constant images are where E[x^2]-E[x]^2 cancels; a constant
    image must give std exactly 0.0 (``tests/test_pallas_serve.py:57``)."""
    rng = np.random.default_rng(3)
    imgs = (np.full((4, 64, 64, 3), 200, np.uint8)
            + rng.integers(0, 2, (4, 64, 64, 3)).astype(np.uint8))
    _, stats = _port(imgs)
    want = quality_lib.input_stat_values(imgs)
    assert np.all(np.asarray(want["std"]) < 0.01), "fixture not flat"
    np.testing.assert_allclose(stats[:, 3], np.asarray(want["std"], np.float64),
                               atol=5e-5)
    _, stats_c = _port(np.full((2, 32, 32, 3), 137, np.uint8))
    assert np.all(stats_c[:, 3] == 0.0)


def test_input_stats_dict_vocabulary_and_values():
    imgs = _images((5, 32, 32, 3), seed=8)
    got = sp.input_stats_dict(_port(imgs)[1])
    _, jax_stats = pallas_serve.fused_serve_preprocess(imgs, interpret=True)
    want = pallas_serve.input_stats_dict(np.asarray(jax_stats))
    assert set(got) == set(quality_lib.INPUT_STATS) == set(want)
    for k in want:
        assert got[k].dtype == np.float64
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_host_prepare_images_fused_and_unfused_agree():
    imgs = _images((6, 16, 16, 3), seed=9)
    norm_u, stats_u = host.prepare_images(imgs, fused=False, device="cpu")
    norm_f, stats_f = host.prepare_images(imgs, fused=True, device="cpu")
    assert torch.equal(norm_u, norm_f)
    for k in stats_u:
        np.testing.assert_array_equal(stats_u[k], stats_f[k])
    stats = host.stats_only(imgs, fused=True, device="cpu")
    want = quality_lib.input_stat_values(imgs)
    for k in quality_lib.INPUT_STATS:
        np.testing.assert_allclose(stats[k], np.asarray(want[k], np.float64),
                                   atol=1e-4, err_msg=k)
