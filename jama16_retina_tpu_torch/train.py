"""Train the port (the counterpart of the repository's ``train.py``).

    python -m jama16_retina_tpu_torch.train --config=eyepacs_binary \\
        --data_dir=/data/eyepacs --workdir=/ckpt/run1 [--resume] \\
        [--set train.steps=100] [--device=cpu]
    python -m jama16_retina_tpu_torch.train --config=smoke --synthetic=64 \\
        --data_dir=/tmp/synth --workdir=/tmp/ck --device=cpu

With ``--data_dir`` (default ``data.train_dir``) it trains on the
directory's ``train`` TFRecord split with evals on ``val``
(``trainer.fit``; ``trainer.fit_ensemble`` into ``member_NN`` dirs when
``train.ensemble_size`` > 1, the members in turn, or in one stacked step
with ``train.ensemble_parallel`` and ``train.ensemble_parallel_force``)
and writes ``metrics.jsonl``,
``run_meta.json`` and the ``best/`` and ``latest/`` checkpoints to
``--workdir`` (default ``train.checkpoint_dir``); ``--resume`` (or
``--set train.resume=true``) continues the run there. With
``--synthetic=N`` and no train split in ``--data_dir``, it first writes
synthetic fundus splits there, as the reference's CLI does: train N, val
and test max(N/2, 8) images, seeds 1/2/3, 4 shards each, but raw-encoded
where the reference writes JPEG. With
``--synthetic=N`` and no ``--data_dir``, it trains ``train.steps`` steps
on N rendered images held in memory (``trainer.fit_synthetic``) and
writes the trained member as ``<workdir>/params.npz``.

It prints ``{"config": ..., "results": ...}`` as its last line.
``--device`` defaults to the card and raises without one;
``--device=cpu`` runs on the CPU.

Data-parallel training over ranks (``parallel/mesh.py``): launched by
``torch.distributed.run``, each process joins the launch's process group
first and trains one replica of one ``fit``, rank 0 writing the run's
files and printing the last line::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m jama16_retina_tpu_torch.train --config=eyepacs_binary \
        --data_dir=... --workdir=... --set parallel.num_devices=2

``--fake_devices N --device cpu`` (the reference's flag) starts N such
ranks on the CPU itself, under gloo.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.train",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("--config", default="eyepacs_binary", help="preset name")
    p.add_argument("--set", action="append", default=[],
                   help="config override section.field=value (repeatable)")
    p.add_argument("--data_dir", default="",
                   help="TFRecord directory (default: data.train_dir)")
    p.add_argument("--workdir", default="",
                   help="checkpoint and metrics directory (default: "
                        "train.checkpoint_dir)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="write N synthetic images per split into --data_dir "
                        "when it has no train split; without --data_dir, "
                        "train on N rendered images in memory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's latest checkpoint")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--fake_devices", type=int, default=0,
                   help="with --device=cpu: launch this many ranks on the "
                        "CPU under gloo, one replica each")
    return p


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)

    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    # First, as the reference's CLI does: a launch's ranks join its group
    # (which this call releases only if it formed it).
    formed = not mesh_lib.dist.is_initialized()
    launched = mesh_lib.initialize_distributed(device=args.device)
    if args.fake_devices > 1 and not launched:
        if args.device != "cpu":
            raise SystemExit(
                "--fake_devices launches ranks on the CPU: pass --device=cpu "
                "(on cards, launch the ranks with python -m "
                "torch.distributed.run)")
        return mesh_lib.launch_local(
            ["-m", "jama16_retina_tpu_torch.train", *argv],
            args.fake_devices)
    if args.fake_devices > 1 and (mesh_lib.process_count()
                                  != args.fake_devices):
        raise SystemExit(f"--fake_devices={args.fake_devices} but the "
                         f"launch has {mesh_lib.process_count()} ranks")
    try:
        return _run(args, rank0=not launched or (
            mesh_lib.dist.get_rank() == 0))
    finally:
        if launched and formed:
            mesh_lib.dist.destroy_process_group()


def _run(args, rank0: bool) -> int:
    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    cfg = configs.override(configs.get_config(args.config), args.set)
    if args.resume:
        cfg = configs.override(cfg, ["train.resume=true"])
    data_dir = args.data_dir or cfg.data.train_dir
    workdir = args.workdir or cfg.train.checkpoint_dir
    if not data_dir:
        if args.synthetic < 1:
            raise SystemExit("--data_dir is required (or --synthetic N to "
                             "train on N rendered images in memory)")
        results = trainer.fit_synthetic(cfg, workdir, args.synthetic,
                                        device=args.device)
    else:
        if args.synthetic:
            try:
                tfrecord.list_split(data_dir, "train")
            except FileNotFoundError:
                n = args.synthetic
                for split, ns, seed in (("train", n, 1),
                                        ("val", max(n // 2, 8), 2),
                                        ("test", max(n // 2, 8), 3)):
                    if rank0:
                        tfrecord.write_synthetic_split(
                            data_dir, split, ns, cfg.model.image_size,
                            num_shards=4, seed=seed, encoding="raw")
            # Every rank reads the splits after rank 0 has written them.
            mesh_lib.make_mesh(device=args.device).barrier()
        if cfg.train.ensemble_size > 1:
            results = trainer.fit_ensemble(cfg, data_dir, workdir,
                                           device=args.device)
        else:
            results = trainer.fit(cfg, data_dir, workdir, device=args.device)
    if rank0:
        print(json.dumps({"config": cfg.name, "results": results},
                         default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
