"""Evaluate member checkpoints on a TFRecord split (the counterpart of the
repository's ``evaluate.py``).

    python -m jama16_retina_tpu_torch.evaluate --config=eyepacs_binary \\
        --data_dir=/data/eyepacs --checkpoint_dir=/ckpt/run1 \\
        [--threshold_split=val] [--bootstrap=2000] [--device=cpu]

``--checkpoint_dir`` is a port checkpoint dir (its best step is scored), a
``params.npz`` member dir, or an ensemble root of ``member_NN`` dirs;
``--ensemble_dir`` (repeatable) names members explicitly. Members'
probabilities are averaged in float64. The report (AUC, the operating
points at ``eval.operating_specificities``, and the transferred points,
intervals and calibration when asked) is printed as the last line, one
JSON object. ``--profile_out=P`` also writes the quality monitor's
reference profile of ``--split`` to ``P``. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jama16_retina_tpu_torch.evaluate",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("--config", default="eyepacs_binary", help="preset name")
    p.add_argument("--set", action="append", default=[],
                   help="config override section.field=value (repeatable)")
    p.add_argument("--data_dir", default="",
                   help="TFRecord directory (default: data.test_dir)")
    p.add_argument("--checkpoint_dir", default="",
                   help="checkpoint dir, member dir or ensemble root")
    p.add_argument("--ensemble_dir", action="append", default=[],
                   help="explicit member dir (repeatable)")
    p.add_argument("--split", default="test", help="split to evaluate")
    p.add_argument("--threshold_split", default="",
                   help="choose the operating thresholds on this split and "
                        "apply them to --split")
    p.add_argument("--threshold_data_dir", default="",
                   help="TFRecord dir of --threshold_split (default: "
                        "--data_dir)")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="bootstrap resamples for 95%% intervals (0 = off)")
    p.add_argument("--calibrate", action="store_true",
                   help="fit a temperature on --threshold_split and report "
                        "calibrated Brier score and ECE on --split")
    p.add_argument("--save_probs", default="",
                   help="write per-image probabilities to this CSV")
    p.add_argument("--profile_out", default="",
                   help="write the quality monitor's reference profile of "
                        "--split (score and input-statistic histograms, "
                        "base rate, operating thresholds) to this JSON, "
                        "the artifact obs.quality.profile_path reads")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv: "list[str] | None" = None) -> int:
    args = _parser().parse_args(argv)

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = configs.override(configs.get_config(args.config), args.set)
    data_dir = args.data_dir or cfg.data.test_dir
    if not data_dir:
        raise SystemExit("--data_dir is required")
    dirs = list(args.ensemble_dir) or list(cfg.eval.ensemble_dirs)
    if not dirs:
        if not args.checkpoint_dir:
            raise SystemExit("--checkpoint_dir or --ensemble_dir required")
        dirs = ckpt_lib.discover_member_dirs(args.checkpoint_dir)
    report = trainer.evaluate_checkpoints(
        cfg, data_dir, dirs, split=args.split,
        threshold_split=args.threshold_split or None,
        threshold_data_dir=args.threshold_data_dir or None,
        bootstrap=args.bootstrap, save_probs=args.save_probs or None,
        calibrate=args.calibrate, profile_out=args.profile_out or None,
        device=args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
