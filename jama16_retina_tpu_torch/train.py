"""Train the port on synthetic fundus images.

The port's counterpart of the repository's ``train.py``:

    python -m jama16_retina_tpu_torch.train --config=eyepacs_binary \\
        --synthetic=64 --workdir=/tmp/run [--set train.steps=100] \\
        [--device=cpu]

It renders ``--synthetic`` fundus images (``data/synthetic.py``), trains
``train.steps`` steps on them (``trainer.fit``), writes ``train`` records
to ``<workdir>/metrics.jsonl`` and the trained member to
``<workdir>/params.npz``, and prints ``{"config": ..., "results": ...}``
as its last line. ``--device`` defaults to the card and raises without
one; ``--device=cpu`` runs on the CPU. ``--data_dir`` (TFRecord splits)
is not ported yet and raises.
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
    p.add_argument("--workdir", required=True,
                   help="directory for metrics.jsonl and the trained member")
    p.add_argument("--synthetic", type=int, default=0,
                   help="number of synthetic fundus images to train on")
    p.add_argument("--data_dir", default="",
                   help="TFRecord directory (not ported yet)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv: "list[str] | None" = None) -> int:
    args = _parser().parse_args(argv)
    if args.data_dir:
        raise NotImplementedError(
            "--data_dir (TFRecord splits) is not ported yet; see ROADMAP.md "
            "Queue A item 5 (trainer, checkpoint and loaders)")
    if args.synthetic < 1:
        raise SystemExit("--synthetic N (N >= 1) is required: the port "
                         "trains on rendered fundus images only")

    from jama16_retina_tpu_torch import configs, trainer

    cfg = configs.override(configs.get_config(args.config), args.set)
    results = trainer.fit(cfg, args.workdir, args.synthetic,
                          device=args.device)
    print(json.dumps({"config": cfg.name, "results": results}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
