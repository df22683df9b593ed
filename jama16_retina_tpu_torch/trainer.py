"""Train loop of the port (the part of ``jama16_retina_tpu/trainer.fit``
this slice carries).

``fit`` trains ``train.steps`` steps of ``train_lib.train_step`` on an
in-memory synthetic fundus set (``data/synthetic.make_dataset``) kept on
the device, in batches of ``data.batch_size`` drawn from a seeded shuffle,
one permutation per epoch. Every ``train.log_every`` steps it appends a
``train`` record ``{"kind", "t", "step", "loss"}`` to
``<workdir>/metrics.jsonl`` (the reference's keys), and at the end it
writes the eval params (the EMA shadow when carried) and batch statistics
as a member dir (``<workdir>/params.npz``, ``utils/checkpoint``), which
``ServingEngine`` and ``python -m jama16_retina_tpu_torch.predict`` serve.

Not here yet (each raises where it is asked for, naming its ROADMAP
item): eval, AUC and early stopping; checkpoints and resume; the TFRecord
and other loaders; ensembles.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch import device as device_lib
from jama16_retina_tpu_torch import train_lib
from jama16_retina_tpu_torch.data import synthetic
from jama16_retina_tpu_torch.models import convert, init
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

METRICS_FILE = "metrics.jsonl"
# make_dataset seed of the train split (train.py --synthetic writes its
# train split with seed 1).
TRAIN_SPLIT_SEED = 1


def batch_indices(n: int, batch_size: int, steps: int,
                  seed: int) -> np.ndarray:
    """[steps, batch_size] example indices: consecutive batches of one
    seeded permutation of ``range(n)`` per epoch, epochs concatenated."""
    need = steps * batch_size
    epochs = -(-need // n)
    order = np.concatenate([
        np.random.default_rng([seed, e]).permutation(n)
        for e in range(epochs)])
    return order[:need].reshape(steps, batch_size)


def fit(cfg: configs.ExperimentConfig, workdir: str, n_synthetic: int,
        device: "str | torch.device | None" = None) -> dict:
    """Train on ``n_synthetic`` rendered fundus images; returns the run's
    results (steps, last loss, member dir, wall time, images per second,
    device)."""
    dev = device_lib.resolve(device)
    configs.validate_train_knobs(cfg.train)
    configs.check_supported(cfg, training=True)
    if n_synthetic < 1:
        raise ValueError(f"need at least one synthetic image, got "
                         f"{n_synthetic}")
    tc = cfg.train
    images, grades = synthetic.make_dataset(
        n_synthetic, synthetic.SynthConfig(image_size=cfg.model.image_size),
        seed=TRAIN_SPLIT_SEED)
    images = torch.from_numpy(images).to(dev)
    grades = torch.from_numpy(grades).to(dev)
    order = torch.from_numpy(batch_indices(
        n_synthetic, cfg.data.batch_size, tc.steps, tc.seed)).to(dev)
    model = init.init_flax_default(models.build(cfg.model), tc.seed)
    state = train_lib.create_state(cfg, model, dev)

    os.makedirs(workdir, exist_ok=True)
    losses = {}
    t0 = time.perf_counter()
    with open(os.path.join(workdir, METRICS_FILE), "a") as log:
        for i in range(tc.steps):
            idx = order[i]
            loss = train_lib.train_step(
                state, {"image": images[idx], "grade": grades[idx]}, cfg)
            if (i + 1) % tc.log_every == 0:
                losses[i + 1] = float(loss)
                log.write(json.dumps({"kind": "train",
                                      "t": round(time.time(), 3),
                                      "step": i + 1,
                                      "loss": losses[i + 1]}) + "\n")
                log.flush()
        last = float(loss) if tc.steps else float("nan")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    ckpt_lib.save_member(workdir,
                         convert.torch_to_flax(train_lib.eval_params(state)))
    return {
        "steps": state.step,
        "final_loss": last,
        "logged_losses": losses,
        "member_dir": workdir,
        "train_sec": seconds,
        "images_per_sec": tc.steps * cfg.data.batch_size / seconds,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
