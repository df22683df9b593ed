"""Preprocess Messidor / Messidor-2 into a fundus-normalized TFRecord
evaluation set (the counterpart of the repository's
``preprocess_messidor.py``).

    python -m jama16_retina_tpu_torch.preprocess_messidor \\
        --data_dir=/data/messidor2/images \\
        --labels_csv=/data/messidor2/grades.csv --output_dir=/data/m2_tfr

Messidor-2's grades (a ``;``-separated CSV) are stored raw, as EyePACS
shards store theirs. The whole set is one ``test`` split, written from
the labels in name order, with ``quality_test.csv``
(``preprocess/datasets.py``). The flags, their defaults and the printed
JSON report are the reference's; the shards and the CSV are its bytes.
Runs on the host only (no torch).
"""

from __future__ import annotations

import argparse
import json

from jama16_retina_tpu_torch.preprocess_eyepacs import add_common


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.preprocess_messidor",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dir", default="", help="directory of raw images")
    p.add_argument("--labels_csv", default="", help="grading CSV path")
    p.add_argument("--output_dir", default="",
                   help="TFRecord output directory")
    p.add_argument("--image_size", type=int, default=299,
                   help="output diameter")
    p.add_argument("--num_shards", type=int, default=8,
                   help="shards for the test split")
    add_common(p)
    return p


def main(argv: "list[str] | None" = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if not (args.data_dir and args.labels_csv and args.output_dir):
        parser.error("--data_dir, --labels_csv, --output_dir required")

    from jama16_retina_tpu_torch.preprocess import datasets

    items = sorted(datasets.parse_labels_csv(args.labels_csv).items())
    stats = datasets.process_split(
        items, args.data_dir, args.output_dir, "test",
        image_size=args.image_size, num_shards=args.num_shards,
        ben_graham=args.ben_graham, encoding=args.encoding,
        min_quality=args.min_quality, workers=args.workers)
    print(json.dumps({"test": {"n_labeled": len(items), **stats.as_dict()}},
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
