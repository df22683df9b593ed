#!/usr/bin/env python
"""Export JAX checkpoints as member dirs of the PyTorch port.

    python scripts/export_torch_member.py --config=eyepacs_binary \
        --checkpoint_dir=/ckpt/run1 --out=/members/run1 [--device=cpu]

``--checkpoint_dir`` is a member's checkpoint dir (its best step is
exported, as ``trainer.restore_for_eval`` restores it) or an ensemble root
of ``member_NN`` dirs (each is exported into ``--out/member_NN``). Each
member dir gets ``params.npz``: the eval params (the EMA shadow when the
checkpoint carries one) and the batch statistics as float32 arrays under
their flat Flax keys (``params/<scope>/...``, ``batch_stats/<scope>/...``),
the format ``jama16_retina_tpu_torch.models.convert`` reads. The port then
serves or evaluates the member:

    python -m jama16_retina_tpu_torch.predict --checkpoint_dir=/members/run1 \
        --images DIR
    python -m jama16_retina_tpu_torch.evaluate --data_dir=/data/eyepacs \
        --checkpoint_dir=/members/run1

The export side imports no torch; the file is written with numpy and the
repository's atomic writer.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import zipfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

PARAMS_FILE = "params.npz"


def npz_bytes(flat: "dict[str, np.ndarray]") -> bytes:
    """The bytes of an uncompressed ``.npz`` of ``flat`` (what
    ``np.savez`` writes), built in memory."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for key, value in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(value))
    return buf.getvalue()


def member_tree(cfg, model, ckpt_dir: str) -> "dict[str, np.ndarray]":
    """The flat float32 eval tree of one JAX member checkpoint."""
    import jax
    from flax.traverse_util import flatten_dict

    from jama16_retina_tpu import train_lib, trainer

    state = jax.device_get(trainer.restore_for_eval(cfg, model, ckpt_dir))
    flat = {}
    for coll, tree in (("params", train_lib.eval_params(state)),
                       ("batch_stats", state.batch_stats)):
        for k, v in flatten_dict(tree, sep="/").items():
            flat[f"{coll}/{k}"] = np.asarray(v, np.float32)
    return flat


def export(cfg, checkpoint_dir: str, out_dir: str) -> "list[str]":
    """Export every member under ``checkpoint_dir``; returns the member
    dirs written."""
    from jama16_retina_tpu import models
    from jama16_retina_tpu.integrity import artifact
    from jama16_retina_tpu.utils import checkpoint as ckpt_lib

    model = models.build(cfg.model)
    members = ckpt_lib.discover_member_dirs(checkpoint_dir)
    single = members == [checkpoint_dir]
    written = []
    for src in members:
        dst = out_dir if single else os.path.join(
            out_dir, os.path.basename(os.path.normpath(src)))
        os.makedirs(dst, exist_ok=True)
        artifact.atomic_write_bytes(os.path.join(dst, PARAMS_FILE),
                                    npz_bytes(member_tree(cfg, model, src)))
        written.append(dst)
    return written


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="eyepacs_binary", help="preset name")
    ap.add_argument("--set", action="append", default=[],
                    help="config override section.field=value (repeatable)")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="member checkpoint dir or ensemble root")
    ap.add_argument("--out", required=True, help="output member dir (root)")
    ap.add_argument("--device", choices=("tpu", "cpu"), default="tpu",
                    help="cpu pins JAX to the CPU backend")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from jama16_retina_tpu import configs

    cfg = configs.override(configs.get_config(args.config), args.set)
    written = export(cfg, args.checkpoint_dir, args.out)
    print(json.dumps({"members": written}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
