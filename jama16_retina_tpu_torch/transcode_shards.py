"""Ahead-of-time transcode: TFRecord splits -> raw array shards (the
counterpart of the repository's ``scripts/transcode_shards.py``).

The offline half of ``data.loader=rawshard`` (``data/rawshard.py``):
decode and resize every record once, here, so training reads
memory-mapped uint8 rows instead of paying a decode (or a proto parse)
per image per epoch. Output per split is
``<split>-NNNNN-of-MMMMM.images.npy`` / ``.grades.npy`` shard pairs plus
a sealed ``<split>.rawshard.json`` manifest, byte for byte the
reference's. Writes are atomic and the manifest advances after every
durable shard, so an interrupted run resumes where it stopped: re-run
the same command.

    python -m jama16_retina_tpu_torch.transcode_shards \\
        --data_dir /data/eyepacs --splits train,val --image_size 299

    # then train without a per-epoch decode:
    python -m jama16_retina_tpu_torch.train --data_dir /data/eyepacs \\
        --set data.loader=rawshard

The flags, their defaults and the one JSON line printed per split are
the reference's. A fault plan in ``JAMA16_FAULTS`` is armed before any
write. Runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.transcode_shards",
        description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--data_dir", required=True,
        help="directory holding the source <split>-*.tfrecord shards")
    p.add_argument(
        "--splits", default="train",
        help="comma-separated split names to transcode (default: train; "
             "eval splits rarely need it — they stream once per eval)")
    p.add_argument(
        "--out_dir", default="",
        help="output directory (default: <data_dir>/rawshard<image_size>, "
             "where data.loader=rawshard looks without data.rawshard_dir)")
    p.add_argument(
        "--image_size", type=int, default=299,
        help="resize target — MUST match model.image_size at train time "
             "(the loader refuses a size mismatch)")
    p.add_argument(
        "--shard_records", type=int, default=256,
        help="records per output shard (resume granularity; each shard "
             "is ~records x size^2 x 3 bytes)")
    p.add_argument(
        "--workers", type=int, default=0,
        help="decode threads (0 = auto, one per host core up to 8)")
    p.add_argument(
        "--no_resume", action="store_true",
        help="rebuild every shard even when a matching manifest exists")
    p.add_argument(
        "--no_quarantine", action="store_true",
        help="fail loudly on a poison source record instead of baking "
             "the streamed tier's deterministic substitution into the "
             "shards")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # Env-driven fault plans (JAMA16_FAULTS) before any shard write: the
    # disk-fault drills reach this CLI's integrity.write seam.
    from jama16_retina_tpu_torch.obs import faultinject

    faultinject.arm_from_env_or_config()

    from jama16_retina_tpu_torch.data import rawshard

    for split in [s for s in args.splits.split(",") if s]:
        manifest = rawshard.transcode_split(
            args.data_dir, split,
            out_dir=args.out_dir or None,
            image_size=args.image_size,
            shard_records=args.shard_records,
            workers=args.workers,
            quarantine=not args.no_quarantine,
            resume=not args.no_resume,
        )
        print(json.dumps({
            "split": split,
            "num_records": manifest["num_records"],
            "num_shards": len(manifest["shards"]),
            "image_size": manifest["image_size"],
            "out_dir": args.out_dir or rawshard.default_shard_dir(
                args.data_dir, args.image_size),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
