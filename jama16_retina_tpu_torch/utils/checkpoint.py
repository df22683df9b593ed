"""Member directories of the port (counterpart of
``jama16_retina_tpu/utils/checkpoint.py``).

A member dir holds ``params.npz``: the flat Flax tree (``params/...``
and ``batch_stats/...`` keys, see ``models/convert.py``) as float32
arrays. It is the port's format until an exporter from the JAX
package's orbax checkpoints exists (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import glob
import os

import numpy as np

PARAMS_FILE = "params.npz"


def discover_member_dirs(root: str) -> list[str]:
    """The ``member_NN`` subdirs of an ensemble root, else the root
    itself as a single model."""
    members = sorted(glob.glob(os.path.join(root, "member_*")))
    return members or [root]


def save_member(directory: str, flat: "dict[str, np.ndarray]") -> str:
    """Write ``flat`` to ``<directory>/params.npz`` atomically (a
    temporary file renamed into place); returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PARAMS_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    os.replace(tmp, path)
    return path


def load_member(directory: str) -> "dict[str, np.ndarray]":
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no {PARAMS_FILE} in member dir {directory!r}; the port reads "
            "member dirs written by utils.checkpoint.save_member"
        )
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
