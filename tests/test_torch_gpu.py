"""Card-only tests of the port's CUDA kernels (B1-B4), each held against
its plain PyTorch version on the card. Marked ``gpu``; they skip where no
card is visible. This file imports no JAX, so it also runs on a machine
without JAX. ``tests/conftest.py`` sets ``CUDA_VISIBLE_DEVICES=-1`` when
it is unset, so run them as

    CUDA_VISIBLE_DEVICES=0 python -m pytest -m gpu tests/test_torch_gpu.py

(add ``--noconftest`` where JAX is not installed)."""

import pytest
import torch

from jama16_retina_tpu_torch.ops import adamw as ad
from jama16_retina_tpu_torch.ops import color_jitter as cj
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


def _affine_inputs(b, g, dev):
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    a = (eye + 0.3 * torch.randn((b, 3, 3), generator=g, device=dev))
    o = 0.3 * torch.rand((b, 3), generator=g, device=dev) - 0.15
    return a.contiguous(), o


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 299, 299, 3), (3, 37, 53, 3)])
def test_color_jitter_kernels_match_plain_versions(cuda, shape):
    """B1 and B2 bitwise against their plain versions, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(1)
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                         generator=g)
    b = shape[0]
    a, o = _affine_inputs(b, g, cuda)
    before = dict(cj.launches)
    got = cj.fused_color_jitter(imgs, a, o)
    torch.cuda.synchronize()
    assert cj.launches["fused_color_jitter"] == before["fused_color_jitter"] + 1
    assert torch.equal(got, cj.color_jitter_reference(imgs, a, o))
    sat = 0.8 + 0.4 * torch.rand(b, generator=g, device=cuda)
    theta = 0.6 * torch.rand(b, generator=g, device=cuda) - 0.3
    m = cj.chroma_matrix(sat, theta)
    c = 0.75 + 0.5 * torch.rand(b, generator=g, device=cuda)
    br = 0.5 * torch.rand(b, generator=g, device=cuda) - 0.25
    got = cj.fused_normalize_color_jitter(imgs, m, c, br)
    torch.cuda.synchronize()
    assert (cj.launches["fused_normalize_color_jitter"]
            == before["fused_normalize_color_jitter"] + 1)
    assert torch.equal(got, cj.normalize_color_jitter_reference(imgs, m, c, br))


@pytest.mark.gpu
def test_color_jitter_kernels_refuse_non_contiguous(cuda):
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    a, o = _affine_inputs(2, torch.Generator(device=cuda).manual_seed(0), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cj.fused_color_jitter(imgs.transpose(1, 2), a, o)
    with pytest.raises(ValueError, match="contiguous"):
        cj.fused_normalize_color_jitter(imgs, a.transpose(1, 2), o[:, 0],
                                        o[:, 1])


# B2 at odd byte counts and unaligned images on the single-pass route,
# and an image past a cluster's shared memory on the two-pass route.
B2_SHAPES = [((32, 299, 299, 3), "single_pass"), ((3, 37, 53, 3), "single_pass"),
             ((1, 1, 1, 3), "single_pass"), ((5, 17, 23, 3), "single_pass"),
             ((2, 64, 64, 3), "single_pass"), ((1, 1536, 1536, 3), "two_pass")]


def _b2_inputs(shape, g, dev):
    """Images one past the start of a larger batch (so with an odd H*W
    the first image starts unaligned too) and random colour params."""
    b = shape[0]
    imgs = torch.randint(0, 256, (b + 1, *shape[1:]), dtype=torch.uint8,
                         device=dev, generator=g)[1:]
    sat = 0.8 + 0.4 * torch.rand(b, generator=g, device=dev)
    theta = 0.6 * torch.rand(b, generator=g, device=dev) - 0.3
    c = 0.75 + 0.5 * torch.rand(b, generator=g, device=dev)
    br = 0.5 * torch.rand(b, generator=g, device=dev) - 0.25
    return imgs, (cj.chroma_matrix(sat, theta), c, br)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,route", B2_SHAPES)
def test_b2_routes_match_plain_version(cuda, shape, route):
    """B2 bitwise on the route its shape takes, one launch per call; the
    single-pass shapes also at a cluster of 16 blocks."""
    assert cj._b2_plan(*shape[1:3]).route == route
    imgs, args = _b2_inputs(shape, torch.Generator(device=cuda).manual_seed(4),
                            cuda)
    want = cj.normalize_color_jitter_reference(imgs, *args)
    before = cj.launches["fused_normalize_color_jitter"]
    got = cj.fused_normalize_color_jitter(imgs, *args)
    torch.cuda.synchronize()
    assert cj.launches["fused_normalize_color_jitter"] == before + 1
    assert torch.equal(got, want)
    if route == "single_pass":
        got16 = cj._launch_b2(imgs, *args, cj._b2_plan(*shape[1:3], cluster=16))
        torch.cuda.synchronize()
        assert torch.equal(got16, want)


@pytest.mark.gpu
def test_b2_single_pass_is_one_device_kernel(cuda):
    """One single-pass call is one kernel on the card: no fill, no memset."""
    from torch.profiler import ProfilerActivity, profile

    imgs, args = _b2_inputs((32, 299, 299, 3),
                            torch.Generator(device=cuda).manual_seed(5), cuda)
    cj.fused_normalize_color_jitter(imgs, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cj.fused_normalize_color_jitter(imgs, *args)
        torch.cuda.synchronize()
    ops = [(e.key, e.count) for e in prof.key_averages()
           if e.self_device_time_total > 0]
    assert len(ops) == 1 and ops[0][1] == 1, ops
    assert "normalize_color_jitter_cluster_kernel" in ops[0][0], ops


def _leaves(dev, g):
    shapes = [(32, 3, 3, 3), (768, 128, 5, 5), (1, 2048), (1,), (192,),
              (100_003,)]
    p = [torch.randn(s, generator=g, device=dev) for s in shapes]
    p[0] = p[0].contiguous(memory_format=torch.channels_last)
    p[1] = p[1].contiguous(memory_format=torch.channels_last)
    return p


@pytest.mark.gpu
def test_adamw_kernel_matches_plain_version_over_three_steps(cuda):
    """B3 bitwise against the plain AdamW, one launch per step, over
    leaves of every kind (channels_last convs, Dense, biases, a size
    that is not a multiple of the chunk)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    pk = _leaves(cuda, g)
    pp = [t.clone() for t in pk]
    mk = [torch.zeros_like(t) for t in pk]
    vk = [torch.zeros_like(t) for t in pk]
    mp = [torch.zeros_like(t) for t in pk]
    vp = [torch.zeros_like(t) for t in pk]
    decay = [t.ndim >= 2 for t in pk]
    for step in range(3):
        grads = [torch.randn(t.shape, generator=g, device=cuda).contiguous(
            memory_format=torch.channels_last if t.ndim == 4 else
            torch.contiguous_format) for t in pk]
        t = float(step + 1)
        scalars = torch.tensor([1e-3, 1 / (1 - 0.9**t), 1 / (1 - 0.999**t)],
                               device=cuda)
        before = ad.launches
        ad.fused_adamw_update(pk, grads, mk, vk, decay, scalars, 0.01)
        torch.cuda.synchronize()
        assert ad.launches == before + 1
        ad.adamw_reference(pp, grads, mp, vp, decay, scalars, 0.01)
        for a, b in zip(pk + mk + vk, pp + mp + vp):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_adamw_kernel_splits_long_leaf_lists_into_launches(cuda):
    """More leaves than one launch's parameter table holds: one launch
    per full table, and still bitwise against the plain AdamW."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shapes = [(7, 3)] * 450 + [(3,)] * 10
    pk = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    grads = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    pp = [t.clone() for t in pk]
    mk, vk, mp, vp = ([torch.zeros_like(t) for t in pk] for _ in range(4))
    decay = [t.ndim >= 2 for t in pk]
    scalars = torch.tensor([1e-3, 10.0, 1000.0], device=cuda)
    _, max_leaves = ad._library()
    before = ad.launches
    ad.fused_adamw_update(pk, grads, mk, vk, decay, scalars, 0.01)
    torch.cuda.synchronize()
    assert ad.launches == before + -(-len(shapes) // max_leaves) == before + 2
    ad.adamw_reference(pp, grads, mp, vp, decay, scalars, 0.01)
    for a, b in zip(pk + mk + vk, pp + mp + vp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_adamw_kernel_over_efficientnet_b4_leaves_in_two_launches(cuda):
    """EfficientNet-B4's 418 parameter leaves (channels_last convs,
    depthwise kernels, SE biases, BN scales) as the train state holds
    them: two launches a call, bitwise against the plain AdamW over three
    steps."""
    from jama16_retina_tpu_torch import configs, models

    model = models.build(configs.get_config("efficientnet_b4").model).to(
        cuda, memory_format=torch.channels_last)
    pk = [p.detach().clone() for p in model.parameters()]
    assert len(pk) == 418
    g = torch.Generator(device=cuda).manual_seed(4)
    pp = [t.clone() for t in pk]
    mk, vk, mp, vp = ([torch.zeros_like(t) for t in pk] for _ in range(4))
    decay = [t.ndim >= 2 for t in pk]
    for step in range(3):
        grads = [torch.randn(t.shape, generator=g, device=cuda).contiguous(
            memory_format=torch.channels_last if t.ndim == 4 else
            torch.contiguous_format) for t in pk]
        t = float(step + 1)
        scalars = torch.tensor([1e-3, 1 / (1 - 0.9**t), 1 / (1 - 0.999**t)],
                               device=cuda)
        before = ad.launches
        ad.fused_adamw_update(pk, grads, mk, vk, decay, scalars, 4e-5)
        torch.cuda.synchronize()
        assert ad.launches == before + 2
        ad.adamw_reference(pp, grads, mp, vp, decay, scalars, 4e-5)
        for a, b in zip(pk + mk + vk, pp + mp + vp):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_adamw_kernel_refuses_mismatched_layouts(cuda):
    p = [torch.zeros((4, 3, 2, 2), device=cuda).contiguous(
        memory_format=torch.channels_last)]
    g = [torch.zeros((4, 3, 2, 2), device=cuda)]
    with pytest.raises(ValueError, match="strides"):
        ad.fused_adamw_update(p, g, [torch.zeros_like(p[0])],
                              [torch.zeros_like(p[0])], [True],
                              torch.zeros(3, device=cuda), 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_same_avg_pool_gradient_matches_the_cpu(cuda, dtype):
    """The SAME 3x3 average pool of Inception's blocks, forward and
    backward on channels_last input, against the CPU's
    ``F.avg_pool2d(count_include_pad=False)`` (whose CUDA backward the
    port does not use)."""
    from jama16_retina_tpu_torch.models.inception_v3 import _avg_pool_same

    g = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn((4, 64, 35, 35), generator=g)).to(dtype)
    cot = torch.randn((4, 64, 35, 35), generator=g).to(dtype)
    xc = x.clone().contiguous(memory_format=torch.channels_last).requires_grad_()
    torch.nn.functional.avg_pool2d(xc, 3, 1, 1, count_include_pad=False
                                   ).backward(cot)
    xg = x.to(cuda).contiguous(memory_format=torch.channels_last)
    xg.requires_grad_()
    y = _avg_pool_same(xg)
    y.backward(cot.to(cuda))
    # bfloat16: two ulps (2^-6 relative), the two sum in other orders.
    tol = 1e-6 if dtype == torch.float32 else 2.0**-6
    want = torch.nn.functional.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    assert torch.allclose(y.detach().cpu().float(), want.float(), rtol=tol,
                          atol=tol)
    assert torch.allclose(xg.grad.cpu().float(), xc.grad.float(), rtol=tol,
                          atol=tol)


@pytest.mark.gpu
def test_fit_and_resume_on_the_card(cuda, tmp_path):
    """The smoke preset with kernel B1 on, at 64 px: 4 steps with evals at
    2 and 4, then a resume to 6 steps. B1 launches once a step in each
    call, the resume starts at 4 from a bitwise copy of what was saved,
    and every val AUC is finite in [0, 1]."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, train_lib, trainer
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.models import init
    from jama16_retina_tpu_torch import models
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    data, wd = str(tmp_path / "data"), str(tmp_path / "wd")
    for split, n, seed in (("train", 24, 1), ("val", 12, 2)):
        tfrecord.write_synthetic_split(data, split, n, 64, num_shards=2,
                                       seed=seed, encoding="raw")
    base = ["data.use_pallas=true", "train.eval_every=2", "train.log_every=1"]
    cfg = configs.override(configs.get_config("smoke"),
                           base + ["train.steps=4"])
    cj.launches["fused_color_jitter"] = 0
    trainer.fit(cfg, data, wd, device=cuda)
    assert cj.launches["fused_color_jitter"] == 4
    saved = ckpt_lib.Checkpointer(wd).restore(4)
    cfg6 = configs.override(cfg, ["train.steps=6", "train.resume=true"])
    state = train_lib.create_state(
        cfg6, init.init_flax_default(models.build(cfg6.model), 1), cuda)
    train_lib.load_state_flat(state, saved)
    again = train_lib.state_to_flat(state)
    assert all(np.array_equal(again[k], saved[k]) for k in saved)
    cj.launches["fused_color_jitter"] = 0
    trainer.fit(cfg6, data, wd, device=cuda)
    assert cj.launches["fused_color_jitter"] == 2
    recs = read_jsonl(f"{wd}/metrics.jsonl")
    assert [r["step"] for r in recs if r["kind"] == "resume"] == [4]
    aucs = [r["val_auc"] for r in recs if r["kind"] == "eval"]
    assert [r["step"] for r in recs if r["kind"] == "eval"] == [2, 4, 6]
    assert all(0.0 <= a <= 1.0 for a in aucs)
    assert ckpt_lib.Checkpointer(wd).latest_step == 6


def _smoke_split(root, n=12, size=64):
    from jama16_retina_tpu_torch.data import tfrecord

    tfrecord.write_synthetic_split(str(root), "train", n, size, num_shards=3,
                                   seed=4, encoding="raw")
    return str(root)


@pytest.mark.gpu
@pytest.mark.parametrize("depth,readers", [(1, 1), (2, 3), (4, 2)])
def test_prefetched_batches_on_the_card_are_the_stream(cuda, tmp_path,
                                                       depth, readers):
    """Batches staged through pinned buffers and a side stream come out
    in order and bitwise those of the unprefetched host stream, while the
    consumer's stream is kept busy so that a buffer reused before its
    copy finished would show."""
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import pipeline

    root = _smoke_split(tmp_path)
    cfg = configs.DataConfig(batch_size=4)

    def stream(r):
        return pipeline.train_batches(root, "train", cfg, 64, seed=2,
                                      readers=r)

    want = [next(s) for s in [stream(1)] for _ in range(10)]
    busy = torch.randn((2048, 2048), device=cuda)
    with pipeline.DevicePrefetch(stream(readers), cuda, depth) as s:
        for w in want:
            got = next(s)
            for _ in range(4):
                busy = busy @ busy / busy.norm()
            assert got["image"].device.type == "cuda"
            assert all(torch.equal(got[k].cpu(), w[k]) for k in w)


@pytest.mark.gpu
def test_snapshot_is_ordered_before_a_reader_on_another_thread(cuda):
    """A snapshot taken right after a step, read at once on another
    thread (after its event), holds that step's values, however long the
    step's kernels ran and whatever the next step does to the state."""
    import threading

    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.models import init

    cfg = configs.override(configs.get_config("smoke"),
                           ["train.use_pallas_fused=true"])
    state = train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model), 0), cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), device=cuda,
                                    dtype=torch.uint8, generator=g),
             "grade": torch.arange(8, device=cuda, dtype=torch.int32) % 5}
    train_lib.train_step(state, batch, cfg)
    busy = torch.randn((4096, 4096), device=cuda)
    for _ in range(8):
        busy = busy @ busy / busy.norm()
    snap = train_lib.snapshot(state)
    got = {}

    def read():
        snap.wait()
        got.update(train_lib.state_to_flat(snap.state))

    reader = threading.Thread(target=read)
    reader.start()
    reader.join()
    torch.cuda.synchronize()
    want = train_lib.state_to_flat(state)
    assert set(got) == set(want)
    assert all((got[k] == want[k]).all() for k in want)
    train_lib.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    again = train_lib.state_to_flat(snap.state)
    assert all((again[k] == got[k]).all() for k in got)


@pytest.mark.gpu
def test_bf16_fused_step_on_the_card(cuda):
    """``train.dtype=bf16`` with B2 and B3: one launch of each a step,
    float32 masters and moments, and a loss within 0.05 of the step with
    float32 params from the same init and batch."""
    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.models import init

    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), device=cuda,
                                    dtype=torch.uint8, generator=g),
             "grade": torch.arange(8, device=cuda, dtype=torch.int32) % 5}
    losses = {}
    for dtype in ("fp32", "bf16"):
        cfg = configs.override(configs.get_config("smoke"), [
            "train.use_pallas_fused=true", f"train.dtype={dtype}"])
        state = train_lib.create_state(
            cfg, init.init_flax_default(models.build(cfg.model), 0), cuda)
        before = (dict(cj.launches), ad.launches)
        losses[dtype] = float(train_lib.train_step(state, batch, cfg))
        assert (cj.launches["fused_normalize_color_jitter"]
                == before[0]["fused_normalize_color_jitter"] + 1)
        assert ad.launches == before[1] + 1
        assert all(t.dtype == torch.float32 for t in (
            *state.model.parameters(), *state.mu.values(),
            *state.nu.values()))
    assert abs(losses["bf16"] - losses["fp32"]) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("parallel", [False, True], ids=["in_turn", "vmap"])
def test_serving_dtypes_and_member_parallel_on_the_card(cuda, dtype,
                                                        parallel):
    """The smoke preset's engine at each serving dtype, members in turn and
    in one vmap, on the card against the same engine on the CPU (float32
    compute, TF32 off): within 1e-4, and the fused preprocess launched
    once per chunk."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "serve.max_batch=8",
        "serve.fused_preprocess=true", f"serve.dtype={dtype}",
        f"serve.member_parallel={parallel}"])
    sds = []
    for m in range(2):
        gen = torch.Generator().manual_seed(m)
        sds.append({k: (v if k.endswith((".mean", ".var"))
                        else v + 0.05 * torch.randn(v.shape, generator=gen))
                    for k, v in models.build(cfg.model).state_dict().items()})
    imgs = np.random.default_rng(0).integers(0, 256, (11, 64, 64, 3),
                                             np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = sp.launches
        card = ServingEngine(cfg, state_dicts=sds, device=cuda,
                             registry=Registry()).member_probs(imgs)
        assert sp.launches == before + 2
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = ServingEngine(cfg, state_dicts=sds, device="cpu",
                        registry=Registry()).member_probs(imgs)
    assert np.abs(card - cpu).max() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("family,clip,bound", [
    ("sgdm", 0.0, 1e-6), ("rmsprop", 0.0, 1e-6), ("lamb", 0.0, 1e-5),
    ("adamw", 1.0, 1e-6), ("sgdm", 1.0, 1e-6)])
def test_family_update_on_the_card_matches_the_cpu(cuda, family, clip,
                                                   bound):
    """One update of each optimizer family (``optim.apply_update``) on
    the same float32 gradients and state, on the card and on the CPU:
    every parameter and state leaf within ``bound`` relative L2 (LAMB's
    and the clip's norms reduce in another order on the card)."""
    from jama16_retina_tpu_torch import configs, models, optim, train_lib

    cfg = configs.override(configs.get_config("smoke"), [
        f"train.optimizer={family}", f"train.gradient_clip_norm={clip}",
        "train.weight_decay=0.01"])
    gen = torch.Generator().manual_seed(3)
    names = [k for k, _ in models.build(cfg.model).named_parameters()]
    params = [p.detach() + 0.1 * torch.randn(p.shape, generator=gen)
              for p in models.build(cfg.model).parameters()]
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    moms = {n: [0.1 * torch.rand(p.shape, generator=gen) for p in params]
            for n in optim.MOMENTS[family]}
    counted = family in optim.COUNTED
    out = {}
    for dev in ("cpu", cuda):
        p = [t.to(dev).clone() for t in params]
        m = {n: [t.to(dev).clone() for t in ts] for n, ts in moms.items()}
        count = torch.tensor(4, dtype=torch.int32, device=dev)
        optim.apply_update(family, cfg.train, p,
                           [g.to(dev) for g in grads], m,
                           count if counted else None, count.clone(),
                           train_lib.make_schedule(cfg.train))
        out[str(dev)] = [t.cpu() for t in p] + [
            t.cpu() for n in sorted(m) for t in m[n]]
    cpu, card = out["cpu"], out[str(cuda)]
    assert len(cpu) == len(names) * (1 + len(moms))
    for a, b in zip(card, cpu):
        rel = float((a.double() - b.double()).norm() / b.double().norm())
        assert rel <= bound, rel


@pytest.mark.gpu
def test_stacked_step_on_the_card_matches_members_in_turn(cuda):
    """k=2 smoke members stepped 3 times stacked (B1 once over the 16
    stacked images a step) against each stepped in turn (B1 once a
    step), float32 with TF32 off and cuDNN deterministic: losses within
    1e-5 and every param and statistic within 1e-4 absolute, as on the
    CPU."""
    import dataclasses

    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.models import init

    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "data.use_pallas=true",
        "train.optimizer=lamb", "train.gradient_clip_norm=1.0",
        "train.ensemble_size=2", "train.ensemble_parallel=true"])
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), device=cuda,
                                    dtype=torch.uint8, generator=g),
             "grade": torch.arange(8, device=cuda, dtype=torch.int32) % 5}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        seeds = [0, 1]
        state = train_lib.create_ensemble_state(cfg, seeds, cuda)
        singles = [train_lib.create_state(
            cfg, init.init_flax_default(models.build(cfg.model), s), cuda)
            for s in seeds]
        for _ in range(3):
            before = cj.launches["fused_color_jitter"]
            losses = train_lib.ensemble_train_step(state, batch, cfg)
            torch.cuda.synchronize()
            assert cj.launches["fused_color_jitter"] == before + 1
            for m, single in enumerate(singles):
                mcfg = cfg.replace(train=dataclasses.replace(
                    cfg.train, seed=seeds[m], ensemble_size=1))
                loss = train_lib.train_step(single, batch, mcfg)
                assert abs(float(loss) - float(losses[m])) <= 1e-5
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    for m, single in enumerate(singles):
        got = train_lib.state_to_flat(train_lib.unstack_member(state, m))
        want = train_lib.state_to_flat(single)
        for k in want:
            if k.startswith(("params/", "batch_stats/")):
                assert abs(got[k] - want[k]).max() <= 1e-4, k


def _smoke_members(cfg, seeds):
    from jama16_retina_tpu_torch import models

    sds = []
    for s in seeds:
        gen = torch.Generator().manual_seed(s)
        sds.append({k: (v if k.endswith((".mean", ".var"))
                        else v + 0.05 * torch.randn(v.shape, generator=gen))
                    for k, v in models.build(cfg.model).state_dict().items()})
    return sds


@pytest.mark.gpu
def test_reload_and_rollback_on_the_card(cuda):
    """A reload on the card swaps generations (each scored within 1e-4 of
    the CPU engine on the same members, TF32 off) and a rollback restores
    the first bitwise; the retained generation doubles the resident
    bytes until it is released."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "serve.max_batch=8",
        "serve.fused_preprocess=true"])
    a, b = _smoke_members(cfg, (0, 1)), _smoke_members(cfg, (2, 3))
    imgs = np.random.default_rng(1).integers(0, 256, (11, 64, 64, 3),
                                             np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        eng = ServingEngine(cfg, state_dicts=a, device=cuda,
                            registry=Registry())
        one = eng.resident_bytes()
        gen_a = eng.probs(imgs)
        assert eng.reload(state_dicts=b)["generation"] == 1
        assert eng.resident_bytes() == 2 * one
        got_b, gen = eng.probs_with_generation(imgs)
        assert gen == 1
        assert eng.rollback()["restored_from"] == 0
        np.testing.assert_array_equal(eng.probs(imgs), gen_a)
        eng.release_retained()
        assert eng.resident_bytes() == one
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for sds, got in ((a, gen_a), (b, got_b)):
        cpu = ServingEngine(cfg, state_dicts=sds, device="cpu",
                            registry=Registry()).probs(imgs)
        assert np.abs(got - cpu).max() <= 1e-4


@pytest.mark.gpu
def test_cascade_escalated_rows_are_the_ensembles_on_the_card(cuda):
    """The cascade's escalated rows are bitwise ``ensemble.probs`` of the
    same rows and its other rows bitwise ``student.probs`` of the
    request, on the card."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.cascade import CascadeEngine
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "serve.max_batch=16",
        "serve.fused_preprocess=true"])
    sds = _smoke_members(cfg, (0, 1, 2))
    student = ServingEngine(cfg, state_dicts=sds[:1], device=cuda,
                            registry=Registry())
    ensemble = ServingEngine(cfg, state_dicts=sds, device=cuda,
                             registry=Registry())
    imgs = np.random.default_rng(2).integers(0, 256, (13, 64, 64, 3),
                                             np.uint8)
    s = student.probs(imgs)
    thr = float(np.median(s))
    band = float(np.quantile(np.abs(s - thr), 0.5))
    cascade = CascadeEngine(configs.override(cfg, [
        f"serve.cascade_band={band}", f"serve.cascade_thresholds={thr}"]),
        student, ensemble, registry=Registry())
    out, mask = cascade._probs_masked(imgs)
    assert 0 < mask.sum() < len(mask)
    np.testing.assert_array_equal(out[~mask], student.probs(imgs)[~mask])
    np.testing.assert_array_equal(out[mask], ensemble.probs(imgs[mask]))


@pytest.mark.gpu
def test_a_fused_bin_of_two_299px_tenants_launches_b4_once(cuda):
    """Two Inception-v3 tenants (299 px, float32 compute, TF32 off, k=2
    each) share one fused bin of 8 rows: B4 launches once, and each
    tenant's rows are bitwise its own engine's direct rows at bucket 8."""
    import types

    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import fusion
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.max_batch=8",
        "serve.bucket_sizes=8", "serve.fused_preprocess=true"])
    imgs = np.random.default_rng(3).integers(0, 256, (8, 299, 299, 3),
                                             np.uint8)
    parts = [(types.SimpleNamespace(model="a"), 0, 4),
             (types.SimpleNamespace(model="b"), 0, 4)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        engines = {m: ServingEngine(cfg, state_dicts=_smoke_members(cfg, s),
                                    device=cuda, registry=Registry())
                   for m, s in (("a", (0, 1)), ("b", (2, 3)))}
        ref_a = engines["a"].probs(imgs[:4])
        ref_b = engines["b"].probs(imgs[4:])
        before = sp.launches
        out, gens = fusion.score_mixed(engines, imgs, parts, 8)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert sp.launches == before + 1 and gens == {"a": 0, "b": 0}
    assert not np.array_equal(ref_a, ref_b)
    np.testing.assert_array_equal(out[:4], ref_a)
    np.testing.assert_array_equal(out[4:], ref_b)


def _profiled_kernel_names(trace_path) -> set:
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


@pytest.mark.gpu
def test_profiler_windows_and_telemetry_of_full_width_fits(cuda, tmp_path):
    """Two 3-step ``eyepacs_binary`` fits at full width (Inception-v3, 299
    px, batch 32) with the obs planes on: the fused fit's planned
    profiler window captures B2 and B3 in its Chrome trace, the preset
    fit's captures B1; each run writes a telemetry and a heartbeat record
    a flush, a parseable telemetry.prom and the trainer's histograms."""
    import json
    import os
    import re

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.data import tfrecord

    data = str(tmp_path / "data")
    for split, n, seed in (("train", 96, 1), ("val", 32, 2)):
        tfrecord.write_synthetic_split(data, split, n, 299, num_shards=2,
                                       seed=seed, encoding="raw")
    want = {"fused": {"normalize_color_jitter", "adamw_kernel"},
            "preset": {"color_jitter_kernel"}}
    for form, extra in (("fused", ["train.use_pallas_fused=true"]),
                        ("preset", [])):
        wd = tmp_path / form
        cfg = configs.override(configs.get_config("eyepacs_binary"), [
            "train.steps=3", "train.eval_every=3", "train.log_every=1",
            "train.profile_steps=1", "obs.flush_every_s=0",
            "eval.batch_size=32", *extra])
        trainer.fit(cfg, data, str(wd), device="cuda")
        [trace] = os.listdir(wd / "profile")
        names = _profiled_kernel_names(wd / "profile" / trace)
        assert all(any(re.search(rf"(?<![A-Za-z0-9_]){k}", n)
                       for n in names) for k in want[form]), (
            form, sorted(names)[:40])
        recs = [json.loads(line) for line in open(wd / "metrics.jsonl")]
        kinds = [r["kind"] for r in recs]
        assert kinds.count("telemetry") == kinds.count("heartbeat") >= 3
        assert [r for r in recs if r["kind"] == "profile"][0]["steps"] == 1
        tele = [r for r in recs if r["kind"] == "telemetry"][-1]
        assert tele["histograms"]["trainer.dispatch_s"]["count"] == 3
        prom = (wd / "telemetry.prom").read_text()
        assert "# TYPE trainer_dispatch_s histogram" in prom


@pytest.mark.gpu
def test_an_injected_dispatch_fails_one_batcher_window_on_the_card(cuda):
    """The ``engine.dispatch`` drill on the card (smoke members, fused
    preprocess, bf16, one bucket of 8): the second window's future carries
    the injected error, the worker survives, the next requests' rows are
    bitwise the unarmed engine's, and B4 runs once a chunk."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("smoke"), [
        "serve.max_batch=8", "serve.bucket_sizes=8",
        "serve.fused_preprocess=true"])
    reg = Registry()
    eng = ServingEngine(cfg, state_dicts=_smoke_members(cfg, (0, 1)),
                        device=cuda, registry=reg)
    imgs = np.random.default_rng(4).integers(0, 256, (6, 64, 64, 3),
                                             np.uint8)
    want = [eng.probs(imgs[i:i + 1]) for i in range(len(imgs))]
    b = eng.make_batcher()
    eng.chunks_dispatched = 0
    before = sp.launches
    faultinject.arm({"engine.dispatch": {
        "kind": "error", "error": "RuntimeError", "on_calls": [2],
        "message": "chaos"}})
    try:
        out = []
        for i in range(len(imgs)):
            try:
                out.append(b.submit(imgs[i:i + 1]).result(timeout=60))
            except RuntimeError as e:
                out.append(str(e))
    finally:
        faultinject.disarm()
        b.close()
    torch.cuda.synchronize()
    assert out[1] == "chaos (injected, call 2)"
    assert reg.counter("serve.batcher.window_errors").value == 1
    for i in (0, *range(2, len(imgs))):
        np.testing.assert_array_equal(out[i], want[i])
    # The failed window's chunk raised before its forward.
    assert sp.launches - before == eng.chunks_dispatched == len(imgs) - 1


@pytest.mark.gpu
def test_a_replica_killed_at_the_router_site_drops_no_request_on_the_card(
        cuda):
    """The ``serve.router.dispatch`` drill on the card: two replicas of
    one smoke engine pair, an error on the 2nd bin: one replica is marked
    failed, its bin retries on the other, no request fails, and every row
    is bitwise its engine's."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "serve.max_batch=8",
        "serve.bucket_sizes=8", "serve.fused_preprocess=true",
        "serve.router_tick_ms=1"])
    sds = _smoke_members(cfg, (0, 1))
    engines = [ServingEngine(cfg, state_dicts=sds, device=cuda,
                             registry=Registry()) for _ in range(2)]
    imgs = np.random.default_rng(5).integers(0, 256, (8, 8, 64, 64, 3),
                                             np.uint8)
    want = [engines[0].probs(x) for x in imgs]
    reg = Registry()
    router = router_lib.Router(cfg, engines=engines, registry=reg)
    faultinject.arm({"serve.router.dispatch": {
        "kind": "error", "error": "RuntimeError", "on_calls": [2]}})
    try:
        futs = [router.submit(x) for x in imgs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        faultinject.disarm()
        router.close()
    counters = reg.snapshot()["counters"]
    assert counters["serve.router.replica_failures"] == 1
    assert counters["serve.router.retried_bins"] >= 1
    assert counters.get("serve.router.request_failures", 0) == 0
    assert sum(r["state"] == router_lib.FAILED
               for r in router.replica_states()) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [0, 4])
def test_hbm_batches_on_the_card_are_the_host_reference(cuda, tmp_path,
                                                        skip):
    """Three epochs of the card-resident loader's batches (12 records,
    batch 4, from step ``skip``) bitwise the host's numpy gather of the
    same decoded rows by the same epoch permutations, while the
    consumer's stream is kept busy."""
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import hbm_pipeline, threefry

    root = _smoke_split(tmp_path)
    cfg = configs.DataConfig(batch_size=4, loader="hbm", decode_workers=2)
    images, grades = hbm_pipeline.load_split_numpy(root, "train", 64)
    per_epoch = len(images) // 4
    stream = hbm_pipeline.train_batches(root, "train", cfg, 64, seed=5,
                                        skip_batches=skip, device=cuda)
    busy = torch.randn((2048, 2048), device=cuda)
    for step in range(skip, 3 * per_epoch):
        got = next(stream)
        for _ in range(4):
            busy = busy @ busy / busy.norm()
        epoch, pos = divmod(step, per_epoch)
        idx = threefry.epoch_permutation(5, epoch, len(images))[
            pos * 4:(pos + 1) * 4]
        assert got["image"].device.type == "cuda"
        assert torch.equal(got["image"].cpu(), torch.from_numpy(images[idx]))
        assert torch.equal(got["grade"].cpu(), torch.from_numpy(grades[idx]))
    stream.close()


@pytest.mark.gpu
def test_cached_eval_on_the_card_is_the_streamed_one_across_threads(
        cuda, tmp_path):
    """A val cache filled on an overlapped-eval thread's side stream (as
    ``fit`` runs it under ``train.eval_overlap``) and read on the main
    thread and on another thread's side stream, with the card kept busy
    in between: every read bitwise the streamed eval."""
    import threading

    import numpy as np

    from jama16_retina_tpu_torch import configs, models, train_lib, trainer
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.models import init

    tfrecord.write_synthetic_split(str(tmp_path), "val", 10, 64,
                                   num_shards=2, seed=6, encoding="raw")
    cfg = configs.override(configs.get_config("smoke"),
                           ["data.loader=hbm"])
    state = train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model), 0), cuda)
    step = train_lib.make_eval_step(cfg, state, cuda)

    def fn(images):
        return step(images)[None]

    want = trainer.predict_split(cfg, fn, str(tmp_path), "val")
    cache = trainer._eval_cache_for(cfg, str(tmp_path), "val", device=cuda)
    assert cache == []
    got = []

    def on_side_stream():
        with trainer._stream_context(cuda), torch.no_grad():
            busy = torch.randn((4096, 4096), device=cuda)
            for _ in range(8):
                busy = busy @ busy / busy.norm()
            got.append(trainer.predict_split(cfg, fn, str(tmp_path), "val",
                                             cache=cache, device=cuda))

    for run in (on_side_stream, None, on_side_stream):
        if run is None:
            got.append(trainer.predict_split(cfg, fn, str(tmp_path), "val",
                                             cache=cache, device=cuda))
            continue
        t = threading.Thread(target=run)
        t.start()
        t.join()
    assert len(cache) == 2 and len(got) == 3
    for g in got:
        for a, b in zip(g, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_hbm_fit_with_overlapped_evals_on_the_card(cuda, tmp_path):
    """``fit`` under ``data.loader=hbm`` (cuDNN deterministic): the
    overlapped evals, reading the val cache on their own threads, log the
    blocking run's eval records, and the final checkpoints are bitwise
    equal."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    root = _smoke_split(tmp_path / "data", n=16)
    tfrecord.write_synthetic_split(root, "val", 10, 64, num_shards=2,
                                   seed=6, encoding="raw")
    records = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in (False, True):
            wd = str(tmp_path / f"overlap{int(overlap)}")
            cfg = configs.override(configs.get_config("smoke"), [
                "data.loader=hbm", "train.steps=6", "train.eval_every=2",
                "train.log_every=2", f"train.eval_overlap={str(overlap).lower()}"])
            trainer.fit(cfg, root, wd, device=cuda)
            records[overlap] = [
                (r["step"], r["val_auc"]) for r in read_jsonl(
                    f"{wd}/metrics.jsonl") if r["kind"] == "eval"]
            records[(overlap, "ckpt")] = ckpt_lib.Checkpointer(wd).restore(6)
    finally:
        torch.backends.cudnn.deterministic = det
    assert [s for s, _ in records[False]] == [2, 4, 6]
    assert records[True] == records[False]
    a, b = records[(False, "ckpt")], records[(True, "ckpt")]
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _tiered_cfg(**kw):
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import hbm_pipeline

    # 12 records, batch 4: 3 steps an epoch; 6 rows resident, so 2
    # resident and 2 streamed rows a batch.
    return configs.DataConfig(
        batch_size=4, decode_workers=2,
        tiered_resident_bytes=6 * hbm_pipeline.row_bytes(64), **kw)


def _busy(busy):
    for _ in range(4):
        busy = busy @ busy / busy.norm()
    return busy


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [0, 4])
def test_tiered_batches_on_the_card_are_the_host_reference(cuda, tmp_path,
                                                           skip):
    """Three epochs of the tiered loader at partial residency, from step
    ``skip``, bitwise ``host_reference_batches``, while the consumer's
    stream is kept busy."""
    from jama16_retina_tpu_torch.data import tiered_pipeline

    root = _smoke_split(tmp_path)
    cfg = _tiered_cfg()
    stream = tiered_pipeline.train_batches(root, "train", cfg, 64, seed=5,
                                           skip_batches=skip, device=cuda)
    ref = tiered_pipeline.host_reference_batches(
        root, "train", cfg, 64, seed=5, skip_batches=skip, capacity_rows=6)
    busy = torch.randn((2048, 2048), device=cuda)
    for _ in range(skip, 9):
        got, want = next(stream), next(ref)
        busy = _busy(busy)
        assert got["image"].device.type == "cuda"
        assert torch.equal(got["image"].cpu(), torch.from_numpy(want["image"]))
        assert torch.equal(got["grade"].cpu(), torch.from_numpy(want["grade"]))
    stream.close()
    ref.close()


@pytest.mark.gpu
def test_tiered_pinned_ring_wrapping_keeps_the_batches(cuda, tmp_path):
    """Stage depth 1 (a ring of 3 pinned buffers) over 36 batches, the
    streamed tier alone and mixed, the ring wrapping 12 times with the
    consumer's stream busy and every batch held until the end: each is
    still the host reference's."""
    import dataclasses

    from jama16_retina_tpu_torch.data import tiered_pipeline

    root = _smoke_split(tmp_path)
    for cfg, cap in ((_tiered_cfg(stage_depth=1), 6),
                     (dataclasses.replace(_tiered_cfg(stage_depth=1),
                                          tiered_resident_bytes=0), 0)):
        stream = tiered_pipeline.train_batches(root, "train", cfg, 64, seed=8,
                                               device=cuda)
        ref = tiered_pipeline.host_reference_batches(root, "train", cfg, 64,
                                                     seed=8, capacity_rows=cap)
        busy = torch.randn((2048, 2048), device=cuda)
        held = []
        for _ in range(36):
            held.append(next(stream))
            busy = _busy(busy)
        torch.cuda.synchronize()
        for got in held:
            want = next(ref)
            assert torch.equal(got["image"].cpu(),
                               torch.from_numpy(want["image"]))
            assert torch.equal(got["grade"].cpu(),
                               torch.from_numpy(want["grade"]))
        stream.close()
        ref.close()


@pytest.mark.gpu
def test_rawshard_batches_on_the_card_are_the_tiered_ones(cuda, tmp_path):
    """The split transcoded to shards: the rawshard loader's batches on the
    card bitwise the tiered loader's over the records, across an epoch."""
    import dataclasses

    from jama16_retina_tpu_torch.data import rawshard, tiered_pipeline

    root = _smoke_split(tmp_path)
    rawshard.transcode_split(root, "train", image_size=64, shard_records=5)
    for cfg in (_tiered_cfg(), dataclasses.replace(
            _tiered_cfg(), tiered_resident_bytes=0)):
        a = rawshard.train_batches(root, "train", cfg, 64, seed=9,
                                   device=cuda)
        b = tiered_pipeline.train_batches(root, "train", cfg, 64, seed=9,
                                          device=cuda)
        for _ in range(7):
            x, y = next(a), next(b)
            assert x["image"].device.type == "cuda"
            assert torch.equal(x["image"], y["image"])
            assert torch.equal(x["grade"], y["grade"])
        a.close()
        b.close()


@pytest.mark.gpu
@pytest.mark.parametrize("workers", [0, 2])
def test_grain_fit_on_the_card_launches_b1_each_step(cuda, tmp_path,
                                                     workers):
    """``fit`` under ``data.loader=grain`` (the smoke preset with B1 on, in
    process and with 2 worker processes): B1 launches once a step, the
    batches reach the card through the prefetcher, and with workers the
    step-4 save writes ``grain_state/4.json``."""
    import os

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.data import tfrecord

    root = _smoke_split(tmp_path / "data", n=16)
    tfrecord.write_synthetic_split(root, "val", 8, 64, num_shards=2,
                                   seed=6, encoding="raw")
    wd = str(tmp_path / "wd")
    cfg = configs.override(configs.get_config("smoke"), [
        "data.use_pallas=true", "data.loader=grain",
        f"data.grain_workers={workers}", "data.batch_size=4",
        "train.steps=6", "train.eval_every=4", "train.log_every=2"])
    cj.launches["fused_color_jitter"] = 0
    trainer.fit(cfg, root, wd, device=cuda)
    assert cj.launches["fused_color_jitter"] == 6
    assert os.path.exists(os.path.join(wd, "grain_state", "4.json")) == (
        workers > 0)


@pytest.mark.gpu
def test_progressive_jpeg_decodes_on_this_host_as_the_manifest(cuda):
    """The card machine's host (no OpenCV, no TensorFlow): every
    progressive fixture decodes to its manifest digests on the host path
    and the records path, and B4 normalizes the progressive photo's
    canvas on the card as its plain version does."""
    import hashlib
    import json
    import os

    import numpy as np

    from jama16_retina_tpu_torch.data import imdecode, jpeg
    from jama16_retina_tpu_torch.preprocess import fundus

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
    with open(os.path.join(here, "manifest.json")) as f:
        manifest = json.load(f)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    names = sorted(n for n in manifest if n.startswith("progressive"))
    assert len(names) >= 6
    for name in names:
        with open(os.path.join(here, name), "rb") as f:
            data = f.read()
        assert sha(imdecode.imdecode(data)) == manifest[name]["cv2_rgb"]
        assert sha(jpeg.decode_jpeg(data, exif_orientation=False)) == \
            manifest[name]["tf_rgb"]
    with open(os.path.join(here, "progressive.jpg"), "rb") as f:
        canvas = fundus.resize_and_center_fundus(imdecode.imdecode(f.read()),
                                                 diameter=299)
    assert sha(canvas) == manifest["progressive.jpg"]["canvas299"]
    x = torch.from_numpy(canvas[None]).to(cuda)
    before = sp.launches
    got = sp.fused_serve_preprocess(x)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    for g, w in zip(got, sp.serve_preprocess_reference(x)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_lifecycle_cycle_on_the_card_keeps_everything_there(cuda, tmp_path):
    """One seam-level cycle (the retrain injected, the default gates) over
    a real fused-preprocess engine on the card: the gates score the val
    split and the canary through B4, the shadow takes live requests, the
    promote and the watch pass to COMMIT, the controller's device is the
    engine's, and every generation's tensors stay on the card."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.lifecycle import LifecycleController
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    base = configs.override(configs.get_config("smoke"), [
        "model.compute_dtype=float32", "serve.max_batch=8",
        "serve.fused_preprocess=true", "serve.rollback_keep_s=900"])
    dirs = {}
    for tag, seed in (("a", 0), ("b", 10)):
        dirs[tag] = []
        for m in range(2):
            gen = torch.Generator().manual_seed(seed + m)
            model = models.build(base.model)
            with torch.no_grad():
                for k, v in model.state_dict().items():
                    if not k.endswith((".mean", ".var")):
                        v.add_(0.05 * torch.randn(v.shape, generator=gen))
            d = ckpt_lib.member_dir(str(tmp_path / tag), m)
            ckpt_lib.save_member(d, convert.torch_to_flax(model))
            dirs[tag].append(d)
    data = str(tmp_path / "data")
    tfrecord.write_synthetic_split(data, "val", 16, 64, num_shards=1, seed=2,
                                   encoding="raw")
    rng = np.random.default_rng(0)
    canary = rng.integers(0, 256, (4, 64, 64, 3), np.uint8)
    probe = ServingEngine(base, dirs["a"], device=cuda, registry=Registry())
    pinned = np.asarray(metrics.ensemble_average(list(
        probe.member_probs(canary))), np.float64).ravel()
    path = quality.save_canary(str(tmp_path / "canary"), canary,
                               scores=pinned)
    cfg = configs.override(base, [
        "obs.quality.enabled=true", f"obs.quality.canary_path={path}",
        "obs.quality.canary_every_s=0", "lifecycle.enabled=true",
        "lifecycle.gate_canary_max_dev=1", "lifecycle.gate_auc_floor_delta=1",
        "lifecycle.gate_eval_rows=16", "lifecycle.shadow_fraction=1",
        "lifecycle.shadow_requests=2", "lifecycle.shadow_wait_s=30",
        "lifecycle.watch_probes=1"])
    reg = Registry()
    engine = ServingEngine(cfg, dirs["a"], device=cuda, registry=reg)
    imgs = rng.integers(0, 256, (8, 64, 64, 3), np.uint8)
    ctl = LifecycleController(
        cfg, str(tmp_path / "wd"), engine=engine, registry=reg,
        data_dir=data, retrain_fn=lambda c, root: dirs["b"],
        live_member_dirs=dirs["a"], sleep=lambda s: engine.probs(imgs))
    assert ctl.device == engine.device and ctl.device.type == "cuda"
    want = metrics.ensemble_average(list(engine.member_probs(
        imgs, _gen=engine.prepare_candidate(dirs["b"]))))
    before = sp.launches
    ctl.trigger(reason="manual")
    assert ctl.run() == "COMMIT"
    assert sp.launches > before
    gate = ctl.journal.find("GATE")
    assert gate["passed"] and [v["skipped"] for v in gate["verdicts"]] == [
        False, True, False]
    assert ctl.journal.find("STAGED_ROLLOUT")["shadow"]["requests"] >= 2
    assert engine.generation == 1 and ctl.journal.read_live() == dirs["b"]
    for module in engine._gen.modules:
        assert all(t.device.type == "cuda" for t in module.state_dict()
                   .values())
    np.testing.assert_array_equal(engine.probs(imgs), want)
