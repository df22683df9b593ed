"""Preprocess Kaggle EyePACS into fundus-normalized TFRecord shards (the
counterpart of the repository's ``preprocess_eyepacs.py``).

    python -m jama16_retina_tpu_torch.preprocess_eyepacs \\
        --data_dir=/data/eyepacs/train \\
        --labels_csv=/data/eyepacs/trainLabels.csv --output_dir=/data/tfr \\
        [--image_size=299] [--encoding=jpeg|raw] [--workers=8]

Reads ``trainLabels.csv`` (``image,level``: ICDR grades 0-4),
fundus-normalizes every photograph and writes stratified train/val/test
shards with a ``quality_<split>.csv`` each (``preprocess/datasets.py``).
Grades are stored raw; the binary label is derived online. The flags,
their defaults and the printed JSON report are the reference's; the
shards and CSVs are its bytes. Runs on the host only (no torch).
"""

from __future__ import annotations

import argparse
import json


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.preprocess_eyepacs",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dir", default="", help="directory of raw images")
    p.add_argument("--labels_csv", default="", help="trainLabels.csv path")
    p.add_argument("--output_dir", default="",
                   help="TFRecord output directory")
    p.add_argument("--image_size", type=int, default=299,
                   help="output diameter")
    p.add_argument("--val_frac", type=float, default=0.1,
                   help="validation fraction")
    p.add_argument("--test_frac", type=float, default=0.2,
                   help="test fraction")
    p.add_argument("--num_shards", type=int, default=16,
                   help="shards per split")
    p.add_argument("--seed", type=int, default=0,
                   help="partition shuffle seed")
    add_common(p)
    return p


def add_common(p: argparse.ArgumentParser) -> None:
    """The flags both runners share."""
    p.add_argument("--ben_graham", action="store_true",
                   help="subtract-local-average contrast enhancement")
    p.add_argument("--encoding", choices=("jpeg", "raw"), default="jpeg",
                   help="record encoding: jpeg (compact) or raw "
                        "pre-decoded uint8 (~9x disk, no per-epoch decode)")
    p.add_argument("--min_quality", type=float, default=0.0,
                   help="drop images whose gradability score is below "
                        "this [0,1] threshold; every score lands in "
                        "quality_<split>.csv regardless")
    p.add_argument("--workers", type=int, default=0,
                   help="worker processes for the per-image stage (0 = "
                        "serial); the output is byte-identical at any count")


def main(argv: "list[str] | None" = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if not (args.data_dir and args.labels_csv and args.output_dir):
        parser.error("--data_dir, --labels_csv, --output_dir required")

    from jama16_retina_tpu_torch.preprocess import datasets

    labels = datasets.parse_labels_csv(args.labels_csv)
    splits = datasets.stratified_split(labels, args.val_frac, args.test_frac,
                                       seed=args.seed)
    report = {}
    for split, items in splits.items():
        stats = datasets.process_split(
            items, args.data_dir, args.output_dir, split,
            image_size=args.image_size, num_shards=args.num_shards,
            ben_graham=args.ben_graham, encoding=args.encoding,
            min_quality=args.min_quality, workers=args.workers)
        report[split] = {"n_labeled": len(items), **stats.as_dict()}
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
