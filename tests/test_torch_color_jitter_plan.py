"""B2's route plan (``ops/color_jitter._b2_plan``): which route an image
size takes and how the single-pass route cuts an image into one slice per
block of its cluster. Pure arithmetic, so it runs on the CPU; the card
tests (``tests/test_torch_gpu.py``) hold both routes bitwise."""

import pytest

from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.ops import color_jitter as cj

SHAPES = [(32, 299, 299, 3), (3, 37, 53, 3), (1, 1, 1, 3), (5, 17, 23, 3),
          (2, 64, 64, 3), (1, 1536, 1536, 3)]
LIMIT = 232_448  # shared memory a block may use on the H100


def _slices(plan, n_bytes):
    """Each block's [lo, hi) of an image's bytes, as the kernel cuts it."""
    out = []
    for rank in range(plan.cluster):
        lo = min(rank * plan.slice_bytes, n_bytes)
        out.append((lo, min(lo + plan.slice_bytes, n_bytes)))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_b2_plan_tiles_each_image_once_within_shared_memory(shape):
    _, h, w, _ = shape
    n_bytes = 3 * h * w
    plan = cj._b2_plan(h, w)
    if h * w > 1024 * 1024:
        assert plan == cj.B2Plan("two_pass", 0, 0, 0)
        # Two pass only above the budget: the cluster's blocks could not
        # hold the image at the largest slice the limit leaves room for.
        assert n_bytes > cj.B2_CLUSTER * (LIMIT - 256 - 41)
        return
    assert plan.route == "single_pass" and plan.cluster == cj.B2_CLUSTER
    slices = _slices(plan, n_bytes)
    # No gap and no overlap: each slice starts where the last one ended.
    assert slices[0][0] == 0 and slices[-1][1] == n_bytes
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # Every boundary is on a 4-pixel (12-byte) unit but an image's end.
    for lo, hi in slices:
        assert lo % 12 == 0 or lo == n_bytes
        assert hi % 12 == 0 or hi == n_bytes
    # Shared memory holds the slice at any start alignment (up to 15
    # bytes before it) padded to a 12-byte step, after the 256-byte header.
    for lo, hi in slices:
        for d0 in range(16):
            assert 256 + -(-(d0 + hi - lo) // 12) * 12 <= plan.shared_bytes
    assert plan.shared_bytes % 16 == 0 and plan.shared_bytes <= LIMIT


def test_b2_plan_is_single_pass_for_every_preset_and_up_to_its_budget():
    sizes = {configs.get_config(n).model.image_size for n in configs.PRESETS}
    assert {64, 299} <= sizes
    for s in sizes:
        assert cj._b2_plan(s, s).route == "single_pass", s
    # The largest square image a cluster of 8 holds, and one past it.
    assert cj._b2_plan(786, 786).shared_bytes <= LIMIT
    assert cj._b2_plan(787, 787).route == "two_pass"
    # A larger cluster takes larger images on the single-pass route.
    assert cj._b2_plan(787, 787, cluster=16).route == "single_pass"
