#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``jama16_retina_tpu_torch``) on one
CUDA card: the quickest proof that the port still builds and serves.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, any failure exits nonzero before the result line:

1. device   - a CUDA card is required; prints its name, count, power limit.
2. build    - compiles every kernel from ``ops/csrc`` (``nvcc -Xptxas -v``).
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the serve path's shapes: rows bitwise, sums exactly.
4. serve    - k=2 random Inception-v3 members (299 px, aux head, random BN
              statistics) written as ``params.npz`` member dirs; a float32
              ``ServingEngine`` with ``serve.fused_preprocess=true`` answers
              requests of 1, 8 and 13 rendered fundus canvases. Launch
              counts are reset just before and read just after; every
              kernel must have launched once per chunk. Probabilities must
              be finite in [0, 1] and match the same engine on the CPU to
              atol 1e-4 (TF32 off). The bf16 preset's deviation from
              float32 is reported.
5. times    - kernel and plain-version device time (``torch.profiler``)
              and per-call time (CUDA events), request latency (host clock
              around a synchronize) with the device's idle share, peak
              device memory; printed, not asserted. ``--profile DIR``
              adds a table of device time by kernel for one request,
              written into DIR.

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record. Scratch files go under ``build/chip_smoke`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM at 700 W, published
FP32_FLOPS_PER_S = 67e12      # the same, float32 outside tensor cores
REQUESTS = (1, 8, 13)
KERNEL_SHAPES = ((8, 299, 299, 3), (16, 299, 299, 3), (64, 299, 299, 3),
                 (3, 37, 53, 3))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_member(model, gen):
    """Seeded random weights and BN statistics for a port model: He-normal
    convs, 1/sqrt(fan_in) Dense, small biases, BN var in [0.5, 1.5]."""
    import torch

    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(".bn.var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith((".bn.mean", ".bias")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif t.ndim == 4:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                t.copy_(torch.randn(t.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)
            elif t.ndim == 2:
                t.copy_(torch.randn(t.shape, generator=gen) / t.shape[1] ** 0.5)
            else:
                raise ValueError(f"unexpected tensor {name}")
    return model


def event_ms(fn, reps: int) -> float:
    """Mean ms per ``fn(i)`` call by CUDA events: the card's wall time per
    call, which includes any wait for the host to enqueue the next one."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: "str | None" = None) -> float:
    """Mean device-busy ms per ``fn(i)`` call: the summed durations of the
    kernels (and device memsets/copies) it launched, from a CUDA-only
    ``torch.profiler`` trace; only those whose name contains ``kernel``
    when given. Host time between launches is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel is None or kernel in e.key)
    check(us > 0, f"the profiler saw no device time (kernel={kernel})")
    return us / reps / 1e3


def phase_kernels(torch, sp, dev, seed: int) -> float:
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    for shape in KERNEL_SHAPES:
        imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)
        norm_k, sums_k = sp.fused_serve_preprocess(imgs)
        torch.cuda.synchronize()
        norm_p, sums_p = sp.serve_preprocess_reference(imgs)
        err = float((norm_k - norm_p).abs().max())
        worst = max(worst, err)
        check(torch.equal(norm_k, norm_p),
              f"fused_serve_preprocess rows differ at {shape}: max {err}")
        check(torch.equal(sums_k, sums_p),
              f"fused_serve_preprocess sums differ at {shape}")
        log(f"kernels: fused_serve_preprocess {list(shape)} rows bitwise, "
            "sums exact")
    return worst


def kernel_times(torch, sp, dev, batch: int) -> dict:
    """Kernel and plain-version times at [batch, 299, 299, 3], cycling
    over input sets that together exceed twice the 50 MB L2, so each call
    reads cold input as the serve path's freshly copied chunk would.
    ``ms``/``plain_ms`` are device time; ``call_ms``/``plain_call_ms``
    the card's wall time per call, host enqueue included."""
    shape = (batch, 299, 299, 3)
    per_call = batch * 299 * 299 * 3 * 5  # u8 in + f32 out
    n_sets = max(2, -(-100_000_000 // per_call))
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(n_sets)]
    reps = 100

    def kernel(i):
        sp.fused_serve_preprocess(sets[i % n_sets])

    def plain(i):
        sp.serve_preprocess_reference(sets[i % n_sets])

    n = batch * 299 * 299 * 3
    bytes_ms = (n * 5 + batch * 4 * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n / FP32_FLOPS_PER_S * 1e3
    return {"shape": list(shape),
            "ms": device_ms(kernel, reps, "serve_preprocess_kernel"),
            "plain_ms": device_ms(plain, reps),
            "call_ms": event_ms(kernel, reps),
            "plain_call_ms": event_ms(plain, reps),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_serve(torch, seed: int) -> dict:
    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.data import synthetic
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16_cfg = configs.override(configs.get_config("eyepacs_binary"),
                                ["serve.fused_preprocess=true"])
    cfg = configs.override(bf16_cfg, ["model.compute_dtype=float32"])
    dirs = []
    for m in range(2):
        model = random_member(models.build(cfg.model),
                              torch.Generator().manual_seed(seed + m))
        d = SCRATCH / "members" / f"member_{m:02d}"
        ckpt_lib.save_member(str(d), convert.torch_to_flax(model))
        dirs.append(str(d))
    log(f"serve: wrote {len(dirs)} member dirs of "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    synth = synthetic.SynthConfig(image_size=299)
    canvases = np.stack([
        synthetic.render_fundus(np.random.default_rng(seed + 100 + i), i % 5,
                                synth)
        for i in range(sum(REQUESTS))])
    offsets = np.cumsum((0,) + REQUESTS)
    requests = [canvases[a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, dirs, device="cuda")
    # The main path: counts set to 0 just before, read just after.
    sp.launches = 0
    engine.chunks_dispatched = 0
    gpu = [engine.probs(r) for r in requests]
    launches = sp.launches
    chunks = engine.chunks_dispatched
    log(f"serve: {len(requests)} requests of {list(REQUESTS)} rows -> "
        f"{chunks} chunks, fused_serve_preprocess launches {launches}")
    check(launches > 0, "the serve path launched no fused_serve_preprocess")
    check(launches == chunks,
          f"{launches} kernel launches for {chunks} dispatched chunks")
    for r, p in zip(requests, gpu):
        check(p.shape == (r.shape[0],), f"probs shape {p.shape}")
        check(bool(np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))),
              f"probabilities not finite in [0, 1]: {p}")
    want_stats = sp.input_stats_dict(sp.stats_from_sums(
        sp.serve_preprocess_reference(torch.from_numpy(requests[-1]))[1],
        299 * 299))
    for k, v in want_stats.items():
        check(np.array_equal(engine.last_input_stats[k], v),
              f"input stat {k} of the last request differs from the host's")

    cpu = ServingEngine(cfg, dirs, device="cpu")
    dev_cpu = max(float(np.max(np.abs(cpu.member_probs(r)
                                      - engine.member_probs(r))))
                  for r in requests)
    log(f"serve: float32 card vs CPU max |member prob diff| {dev_cpu:.3e} "
        "(atol 1e-4, TF32 off)")
    check(dev_cpu <= 1e-4, f"card and CPU disagree by {dev_cpu}")

    bf16 = ServingEngine(bf16_cfg, dirs, device="cuda")
    bf16_probs = [bf16.probs(r) for r in requests]
    dev_bf16 = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(bf16_probs, gpu))
    check(all(np.all(np.isfinite(p)) for p in bf16_probs), "bf16 not finite")
    log(f"serve: bf16 preset vs float32 max |prob diff| {dev_bf16:.3e} "
        "(reported, not asserted)")
    engines = {"float32": (cfg, engine), "bfloat16": (bf16_cfg, bf16)}
    return {"launches": launches, "chunks": chunks, "dirs": dirs,
            "canvases": canvases, "engines": engines,
            "max_dev_cpu": dev_cpu, "max_dev_bf16": dev_bf16}


def request_times(torch, serve: dict, card: str) -> None:
    """Host-clock request latency around a synchronizing ``probs`` call,
    per dtype, batch 8 and 64, k = 1 and 2 (medians of 10 after 2 warm),
    and the device's busy time per request (profiler, 3 requests), whose
    complement is the share of the request the card sat idle."""
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    import numpy as np

    canvases = serve["canvases"]
    for dtype, (cfg, engine2) in serve["engines"].items():
        engine1 = ServingEngine(cfg, serve["dirs"][:1], device="cuda")
        for k, engine in ((1, engine1), (2, engine2)):
            for batch in (8, 64):
                imgs = np.resize(canvases, (batch,) + canvases.shape[1:])
                times = []
                for i in range(12):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.probs(imgs)
                    torch.cuda.synchronize()
                    if i >= 2:
                        times.append((time.perf_counter() - t0) * 1e3)
                med = statistics.median(times)
                busy = device_ms(lambda i: engine.probs(imgs), 3)
                log(f"times: request {dtype} k={k} batch={batch}: median "
                    f"{med:.3f} ms, min {min(times):.3f}, max "
                    f"{max(times):.3f}; device busy {busy:.3f} ms, idle "
                    f"{100 * (1 - busy / med):.1f} % ({card})")
        del engine1


def profile_request(torch, serve: dict, out_dir: str) -> None:
    """Device time by operator and kernel for one bf16 k=2 batch-64
    request, written to ``<out_dir>/profile_bf16_k2_b64.txt``."""
    from torch.profiler import ProfilerActivity, profile
    import numpy as np

    cfg, engine = serve["engines"]["bfloat16"]
    imgs = np.resize(serve["canvases"], (64,) + serve["canvases"].shape[1:])
    engine.probs(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.probs(imgs)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_bf16_k2_b64.txt").write_text(table)
    log("profile: bf16 k=2 batch=64 request, top kernels by device time:")
    log("\n".join(table.splitlines()[:20]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write a device-time table of one request "
                         "into DIR")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device is available",
              file=sys.stderr, flush=True)
        return 1
    from jama16_retina_tpu_torch.ops import build
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp

    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    for src, out in build.build_all(ptxas_verbose=True).items():
        log(f"build: {src}.cu\n{out.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    max_err = phase_kernels(torch, sp, dev, args.seed)
    serve = phase_serve(torch, args.seed)
    log(f"serve: peak device memory {torch.cuda.max_memory_allocated()} "
        f"bytes ({smi})")

    timing = {b: kernel_times(torch, sp, dev, b) for b in (8, 16, 64)}
    for t in timing.values():
        log(f"times: fused_serve_preprocess {t['shape']}: device kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); per call "
            f"{t['call_ms']:.4f} ms, plain {t['plain_call_ms']:.4f} ms "
            f"({smi})")
    request_times(torch, serve, smi)
    if args.profile:
        profile_request(torch, serve, args.profile)

    main_row = timing[8]
    log(json.dumps({"kernels": [{
        "name": "fused_serve_preprocess",
        "route": "cuda",
        "source": "jama16_retina_tpu_torch/ops/csrc/serve_preprocess.cu",
        "replaces": "jama16_retina_tpu/ops/pallas_serve.py:143",
        "launches": serve["launches"],
        "max_abs_err": max_err,
        "max_abs_diff": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "timed_shape": main_row["shape"],
        "by_batch": {str(b): t for b, t in timing.items()},
    }]}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
