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
    return p


def main(argv: "list[str] | None" = None) -> int:
    args = _parser().parse_args(argv)

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.data import tfrecord

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
                    tfrecord.write_synthetic_split(
                        data_dir, split, ns, cfg.model.image_size,
                        num_shards=4, seed=seed, encoding="raw")
        if cfg.train.ensemble_size > 1:
            results = trainer.fit_ensemble(cfg, data_dir, workdir,
                                           device=args.device)
        else:
            results = trainer.fit(cfg, data_dir, workdir, device=args.device)
    print(json.dumps({"config": cfg.name, "results": results}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
