"""Card-only tests of the port's CUDA kernels, each held against its
plain PyTorch version on the card. Marked ``gpu``; they skip where no
card is visible. This file imports no JAX, so it also runs on a machine
without JAX. ``tests/conftest.py`` sets ``CUDA_VISIBLE_DEVICES=-1`` when
it is unset, so run them as

    CUDA_VISIBLE_DEVICES=0 python -m pytest -m gpu tests/test_torch_gpu.py

(add ``--noconftest`` where JAX is not installed)."""

import pytest
import torch

from jama16_retina_tpu_torch.ops import serve_preprocess as sp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 299, 299, 3), (3, 37, 53, 3),
                                   (1, 1, 1, 3)])
def test_serve_preprocess_kernel_matches_plain_version(cuda, shape):
    """Rows bitwise, sums exactly, and one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                         generator=g)
    before = sp.launches
    norm_k, sums_k = sp.fused_serve_preprocess(imgs)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    norm_p, sums_p = sp.serve_preprocess_reference(imgs)
    assert norm_k.shape == shape and norm_k.dtype == torch.float32
    assert torch.equal(norm_k, norm_p)
    assert torch.equal(sums_k, sums_p)


@pytest.mark.gpu
def test_serve_preprocess_kernel_refuses_non_contiguous(cuda):
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sp.fused_serve_preprocess(imgs.transpose(1, 2))
