"""Predict referable-DR probability for raw fundus photographs.

The port's counterpart of the repository's ``predict.py``:

    python -m jama16_retina_tpu_torch.predict --checkpoint_dir=DIR \\
        --images photos/ [--threshold=0.2327] [--device=cpu]
    python -m jama16_retina_tpu_torch.predict --config=icdr5 \\
        --checkpoint_dir=DIR --images photos/

Each image becomes one JSON line on stdout, in input order:
``{"image", "prob", ["referable", "threshold"], "quality",
["gradable"], "n_models"}``; for the 5-class head (``icdr5``), ``prob``
is P(grade >= 2) and the row adds ``grade_probs`` (5, rounded to 6
places) and ``predicted_grade`` after it. An image that cannot be read
or holds no fundus becomes ``{"image", "error"}``. With
``--max_retries N`` a transient read error is retried up to N times
(``utils/retry.py``), and an image read again and then scored carries
``"retried": true`` before ``n_models`` (and counts into
``serve.input_retried``). Exit codes: 0 when at least one image scored,
1 when none did, 2 under ``--strict`` when any image was skipped (a
retried image that scored was not). Member dirs hold ``params.npz``
(``utils/checkpoint.py``).

The engine is built from the config, so ``--set serve.dtype=bf16|int8``,
``--set serve.member_parallel=true`` and ``--set obs.quality.*`` (a
reference profile to monitor drift against; a golden canary, which with
bf16 or int8 gates the engine's construction and refuses the batch with
``DtypeRejected`` when its scores move more than
``serve.dtype_canary_max_dev``) reach it as they reach ``ServingEngine``.
The engine is assembled through ``serve/assemble.py``: with ``--set
serve.cascade_student_dir=STUDENT`` it is a ``CascadeEngine`` (the
student scores every image, the ``--checkpoint_dir`` ensemble the rows
within ``serve.cascade_band`` of ``serve.cascade_thresholds``) that must
pass its go-live gate first; a refused cascade exits 1 before any row
is printed.

``--replicas N`` (N >= 1) serves the batch through the front-door
``Router`` (``serve/router.py``) over N in-process replicas: the blocks
of ``--batch_size`` rows are submitted under ``--priority``, re-binned
and reassembled in order, so ``--replicas 1`` prints the same JSONL as
the direct path. With ``serve.cascade_student_dir`` the replicas are
student cascades sharing one ``EscalationPool`` of
``serve.router_escalation_replicas`` ensemble engines. The quality
monitor lives on replica 0, and the cascades pass one go-live gate. The
router's report goes to stderr as one JSON line. ``serve.policy_from``
applies a sealed serving policy (``serve/policy.py``) before the engines
are built, on either path.

``--obs_workdir=DIR`` writes the batch's telemetry there, as a train run
writes its own: ``telemetry`` and ``heartbeat`` records in
``DIR/metrics.jsonl`` at every ``obs.flush_every_s`` between blocks
(``step`` counts the images forward-passed), ``DIR/telemetry.prom``, and
a final flush on every exit, including a batch with nothing to score.
The alert rules the config implies (``obs.quality.*``, the reliability
rules) are evaluated at each flush from before the first row is scored:
a rule that fires writes an ``alert`` record and a blackbox dump under
``DIR/blackbox``. The router's report lands there too, as a ``router``
record.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.predict",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("--config", default="eyepacs_binary", help="preset name")
    p.add_argument("--set", action="append", default=[],
                   help="config override section.field=value (repeatable)")
    p.add_argument("--checkpoint_dir", default="",
                   help="member dir, or an ensemble root of member_NN dirs")
    p.add_argument("--ensemble_dir", action="append", default=[],
                   help="explicit member dir (repeatable)")
    p.add_argument("--images", action="append", default=[],
                   help="image file, directory, or glob (repeatable)")
    p.add_argument("--threshold", type=float, default=-1.0,
                   help="decision threshold from an operating point; <0 "
                        "emits probabilities only")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch_size", type=int, default=8,
                   help="prediction batch size (the one padded bucket)")
    p.add_argument("--ben_graham", action="store_true",
                   help="apply the ben-graham enhancement the training "
                        "data was preprocessed with")
    p.add_argument("--min_quality", type=float, default=0.0,
                   help="rows with gradability below this gain "
                        "\"gradable\": false (0 flags none)")
    p.add_argument("--strict", action="store_true",
                   help="exit 2 when any input image was skipped")
    p.add_argument("--max_retries", type=int, default=0,
                   help="per-image retries for TRANSIENT read errors (flaky "
                        "NFS/network mounts; utils/retry.py exponential "
                        "backoff). A retried-then-scored image is counted "
                        "separately (serve.input_retried + a 'retried' "
                        "field on its row) from rejects, so --strict "
                        "semantics stay exact: only genuinely skipped "
                        "images exit 2")
    p.add_argument("--host_workers", type=int, default=0,
                   help="fundus-normalization threads (0 = serve."
                        "host_workers, whose 0 is auto)")
    p.add_argument("--replicas", type=int, default=0,
                   help="serve through the Router over N replicas (0: the "
                        "direct single-engine path)")
    p.add_argument("--priority", choices=("interactive", "batch"),
                   default="interactive",
                   help="router priority class of this batch (with "
                        "--replicas)")
    p.add_argument("--obs_workdir", default="",
                   help="write telemetry, heartbeat and alert records, "
                        "telemetry.prom and blackbox dumps into this "
                        "directory while the batch runs (empty: none)")
    return p


def _router_replica_engines(cfg, dirs, n: int, device):
    """The router's replicas: n plain engines, or with
    ``serve.cascade_student_dir`` n student cascades sharing one
    ``EscalationPool`` of ``serve.router_escalation_replicas`` engines.
    Quality lives on replica 0 only (at n = 1 that is the direct path's
    wiring), and the cascades pass one go-live gate: they share the
    student, band and thresholds."""
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.serve.assemble import (EngineSpec,
                                                        _quality_off,
                                                        assemble,
                                                        cascade_monitor)
    from jama16_retina_tpu_torch.serve.cascade import CascadeEngine
    from jama16_retina_tpu_torch.serve.router import EscalationPool
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    sub = _quality_off(cfg)
    dirs = tuple(dirs)
    if not cfg.serve.cascade_student_dir:
        return [assemble(EngineSpec(cfg=cfg if i == 0 else sub,
                                    member_dirs=dirs, device=device))
                for i in range(n)]
    student_dirs = tuple(ckpt_lib.discover_member_dirs(
        cfg.serve.cascade_student_dir))
    pool = EscalationPool([
        assemble(EngineSpec(cfg=sub, member_dirs=dirs, device=device,
                            cascade=False))
        for _ in range(max(1, cfg.serve.router_escalation_replicas))])
    cascades = []
    for i in range(n):
        student = assemble(EngineSpec(cfg=sub, member_dirs=student_dirs,
                                      device=device, cascade=False))
        quality = (cascade_monitor(cfg, obs_registry.default_registry(),
                                   student.device) if i == 0 else None)
        cascades.append(CascadeEngine(cfg if i == 0 else sub, student, pool,
                                      quality=quality))
    cascades[0].go_live()
    return cascades


def _expand(patterns: "list[str]") -> "list[str]":
    """Every pattern must match at least one image: a glob or directory
    that matches nothing is an error, not a silent skip."""
    paths: list = []
    for pat in patterns:
        if os.path.isdir(pat):
            matched = [p for p in sorted(glob.glob(os.path.join(pat, "*")))
                       if p.lower().endswith(_EXTS)]
        elif any(ch in pat for ch in "*?["):
            matched = sorted(glob.glob(pat))
        elif os.path.exists(pat):
            matched = [pat]
        else:
            matched = []
        if not matched:
            raise FileNotFoundError(f"--images pattern matched nothing: {pat}")
        paths.extend(matched)
    return paths


def main(argv: "list[str] | None" = None) -> int:
    args = _parser().parse_args(argv)
    snap = None
    if args.obs_workdir:
        from jama16_retina_tpu_torch import configs
        from jama16_retina_tpu_torch.obs import alerts, export

        cfg = configs.override(configs.get_config(args.config), args.set)
        snap = export.Snapshotter(workdir=args.obs_workdir,
                                  every_s=cfg.obs.flush_every_s)
        snap.progress(0)
        # Attached before any scoring, so a rule that must hold "for"
        # seconds is seen holding across the batch's flushes.
        snap.alerts = alerts.manager_for(cfg, args.obs_workdir)
    try:
        return _run(args, snap)
    finally:
        if snap is not None:
            snap.close()  # the final telemetry, heartbeat and .prom


def _run(args, snap) -> int:

    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs import trace as obs_trace
    from jama16_retina_tpu_torch.serve import host
    from jama16_retina_tpu_torch.serve.assemble import EngineSpec, assemble
    from jama16_retina_tpu_torch.serve import policy as policy_lib
    from jama16_retina_tpu_torch.serve.cascade import CascadeRejected
    from jama16_retina_tpu_torch.serve.router import Router
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = configs.override(configs.get_config(args.config), args.set)
    if args.replicas < 0:
        raise SystemExit(f"--replicas must be >= 0, got {args.replicas}")
    # The fault plan arms before the host stage, whose host.decode seam
    # runs ahead of any engine (JAMA16_FAULTS wins over obs.fault_plan).
    faultinject.arm_from_env_or_config(cfg.obs.fault_plan)
    dirs = list(args.ensemble_dir)
    if not dirs:
        if not args.checkpoint_dir:
            raise SystemExit("--checkpoint_dir or --ensemble_dir required")
        dirs = ckpt_lib.discover_member_dirs(args.checkpoint_dir)
    paths = _expand(args.images)

    pre = host.preprocess_paths(
        paths, cfg.model.image_size, ben_graham=args.ben_graham,
        workers=args.host_workers or cfg.serve.host_workers,
        max_retries=args.max_retries,
    )
    retried = set(pre.retried)
    if pre.kept:
        # The policy first, so the one-bucket pin below still wins on
        # shapes; a stale fingerprint refuses the batch.
        cfg, policy_prov = policy_lib.maybe_apply_policy(cfg, n_devices=1)
        # One bucket at --batch_size: every row runs at the same padded
        # shape.
        cfg = cfg.replace(serve=dataclasses.replace(
            cfg.serve, max_batch=args.batch_size,
            bucket_sizes=(args.batch_size,)))
        try:
            if args.replicas:
                engines = _router_replica_engines(cfg, dirs, args.replicas,
                                                  args.device)
            else:
                engine = assemble(EngineSpec(
                    cfg=cfg, member_dirs=tuple(dirs), device=args.device,
                    go_live=bool(cfg.serve.cascade_student_dir)))
        except CascadeRejected as e:
            raise SystemExit(f"predict: {e}") from None
    for p, why in pre.skipped:
        print(json.dumps({"image": p, "error": why}))
    if not pre.kept:
        return 1
    n_kept = len(pre.kept)
    if args.replicas:
        router = Router(cfg, engines=engines,
                        policy_provenance=policy_prov or None)
        try:
            futs = [router.submit(pre.images[i:i + args.batch_size],
                                  priority=args.priority)
                    for i in range(0, n_kept, args.batch_size)]
            blocks = []
            for bi, f in enumerate(futs):
                blocks.append(np.asarray(f.result()))
                if snap is not None:
                    snap.progress(min(n_kept, (bi + 1) * args.batch_size))
                    snap.maybe_flush()
        finally:
            router.close()
        probs = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        report = router.report()
        if snap is not None:
            snap.write_record("router", **report)
        print(json.dumps({"router": report}), file=sys.stderr)
    else:
        # One context for the batch: each block is a ``predict.block``
        # event carrying its trace id, and the ambient context names the
        # batch inside the engine. With --obs_workdir the blocks go one at
        # a time so heartbeats advance during the batch (the same math:
        # the engine cuts the same chunks).
        tracer = obs_trace.default_tracer()
        ctx = obs_trace.new_context()
        step = args.batch_size if snap is not None else n_kept
        blocks = []
        with obs_trace.use_context(ctx):
            for i in range(0, n_kept, step):
                block = pre.images[i:i + step]
                with tracer.trace("predict.block", args={
                        "trace_id": ctx.trace_id,
                        "rows": int(block.shape[0])}):
                    blocks.append(engine.probs(block))
                if snap is not None:
                    snap.progress(i + block.shape[0])
                    snap.maybe_flush()
        probs = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)

    for p, pr, qual in zip(pre.kept, probs, pre.qualities):
        if cfg.model.head != "binary":
            score = float(metrics.referable_probs_from_multiclass(pr))
            row = {"image": p, "prob": score,
                   "grade_probs": [round(float(x), 6) for x in pr],
                   "predicted_grade": int(np.argmax(pr))}
        else:
            score = float(pr)
            row = {"image": p, "prob": round(score, 6)}
        if args.threshold >= 0:
            row["referable"] = bool(score >= args.threshold)
            row["threshold"] = args.threshold
        row["quality"] = round(float(qual), 4)
        if args.min_quality > 0:
            row["gradable"] = bool(qual >= args.min_quality)
        if p in retried:
            row["retried"] = True
        row["n_models"] = len(dirs)
        print(json.dumps(row))
    if snap is not None:
        snap.progress(n_kept)
    return 2 if pre.skipped and args.strict else 0


if __name__ == "__main__":
    sys.exit(main())
