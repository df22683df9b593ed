"""The ranks of ``tests/test_torch_parallel.py``, and the one-process forms
they are held against.

Each rank of a launch (``parallel.mesh.launch_local``) runs::

    python tests/torch_parallel_ranks.py IN.npz OUT_DIR

It joins the launch's gloo group on the CPU, runs every case below on
its block of the global inputs in ``IN.npz`` (written by the test) and
writes what it got to ``OUT_DIR/rank<r>.npz``. The test computes the
one-process forms with the same functions (``mesh=None``) and, where the
reference has one, the JAX side. This module imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# Run as a script, from the tests directory: the repository's root first.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from jama16_retina_tpu_torch import configs, models, train_lib  # noqa: E402
from jama16_retina_tpu_torch.models import common, convert  # noqa: E402
from jama16_retina_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

# Flat-dict keys of the cases: "<case>/<name>".
SEP = "|"


def batchnorm(arrays: dict, dtype, mesh=None) -> dict:
    """Train-mode ``BatchNorm`` (scale, bias and running statistics from
    ``arrays``) on this rank's rows of ``x``: its output, the gradients
    of ``sum(y * w)`` with respect to the rows and (summed over the ranks
    by the caller) the scale and bias, and the running statistics."""
    x = torch.from_numpy(arrays["x"]).to(dtype)
    w = torch.from_numpy(arrays["w"]).to(dtype)
    if mesh is not None:
        rows = mesh_lib.local_rows(x.shape[0], mesh)
        x, w = x[rows], w[rows]
    bn = common.BatchNorm(x.shape[1], use_scale=True).to(dtype)
    with torch.no_grad():
        for name in ("scale", "bias", "mean", "var"):
            getattr(bn, name).copy_(torch.from_numpy(arrays[name]))
    bn.mesh = mesh
    x.requires_grad_()
    y = bn(x, train=True)
    (y * w).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": bn.scale.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def _float64(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` computing in float64 end to end, its head included (the
    Flax heads compute in float32: here the head's spatial mean and Dense
    stay in float64, so the whole step is float64)."""
    model = model.double()
    for m in model.modules():
        if "dtype" in vars(m):
            m.dtype = torch.float64

    def forward(x, with_aux=False, train=False, generator=None):
        x = x.to(torch.float64)
        for i in range(model.n_convs):
            x = model._modules[f"conv{i}"](x, train)
        x = x.mean(dim=(2, 3))
        if train:
            x = common.dropout(x, model.dropout_rate, generator)
        return model.Logits(x), None

    model.forward = forward
    return model


def steps(arrays: dict, sets: "list[str]", n_steps: int, float64: bool,
          inject: bool, mesh=None) -> dict:
    """``n_steps`` of ``train_lib.train_step`` of the smoke preset under
    ``sets`` from the flat weights ``arrays['flat|...']``, on this rank's
    rows of the global batch; with ``inject``, the augment draws of step
    s are ``arrays['draw<s>|...']`` (global), else the step's own.
    Returns the flat state (params, statistics, the optimizer state, the
    EMA shadow) and the losses."""
    cfg = configs.override(configs.get_config("smoke"), sets)
    flat = {k.split(SEP, 1)[1].replace(SEP, "/"): v
            for k, v in arrays.items() if k.startswith("flat" + SEP)}
    model = models.build(cfg.model, mesh)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    if float64:
        model = _float64(model)
    state = train_lib.create_state(cfg, model, "cpu")
    batch = {"image": torch.from_numpy(arrays["image"]),
             "grade": torch.from_numpy(arrays["grade"])}
    if mesh is not None:
        batch = mesh_lib.shard_batch(batch, mesh)
    losses = []
    for s in range(n_steps):
        prefix = f"draw{s}{SEP}"
        draws = {k[len(prefix):]: torch.from_numpy(v)
                 for k, v in arrays.items()
                 if inject and k.startswith(prefix)}
        losses.append(float(train_lib.train_step(
            state, batch, cfg, augment_params=draws or None, mesh=mesh)))
    out = {"loss": np.asarray(losses)}
    out.update({k: np.asarray(v, np.float64) for k, v in
                convert.torch_to_flax(state.model).items()})
    out.update(convert.port_to_optax(
        state.optimizer, train_lib.moments(state),
        None if state.count is None else int(state.count),
        int(state.sched_count)))
    if state.ema is not None:
        out.update({"ema/" + k: v for k, v in
                    convert.torch_to_flax(state.ema).items()})
    return out


def eval_probs(arrays: dict, sets: "list[str]", mesh=None) -> np.ndarray:
    """``train_lib.make_eval_step`` of the weights ``arrays['flat|...']``
    on this rank's rows of ``image`` (the whole batch's probabilities
    come back)."""
    cfg = configs.override(configs.get_config("smoke"), sets)
    flat = {k.split(SEP, 1)[1].replace(SEP, "/"): v
            for k, v in arrays.items() if k.startswith("flat" + SEP)}
    model = models.build(cfg.model, mesh)
    model.load_state_dict(convert.flax_to_torch(flat, model))
    state = train_lib.create_state(cfg, model, "cpu")
    images = arrays["image"]
    if mesh is not None:
        images = images[mesh_lib.local_rows(images.shape[0], mesh)]
    return np.asarray(train_lib.make_eval_step(cfg, state, "cpu", mesh)(
        images))


def cases(arrays: dict, spec: dict, mesh=None) -> dict:
    """Every case of the launch, keyed ``<case>|<name>``."""
    out = {}

    def put(case, got):
        out.update({f"{case}{SEP}{k.replace('/', SEP)}": np.asarray(v)
                    for k, v in got.items()})

    bn = {k.split(SEP, 1)[1]: v for k, v in arrays.items()
          if k.startswith("bn" + SEP)}
    put("bn64", batchnorm(bn, torch.float64, mesh))
    put("bn32", batchnorm(bn, torch.float32, mesh))
    for name, run in spec["steps"].items():
        put(name, steps(arrays, run["sets"], run["steps"], run["float64"],
                        run["inject"], mesh))
    put("eval", {"probs": eval_probs(arrays, spec["eval_sets"], mesh)})
    return out


def _main(in_path: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed(device="cpu")
    mesh = mesh_lib.make_mesh(device="cpu")
    with np.load(in_path) as f:
        arrays = dict(f)
    spec = json.loads(str(arrays.pop("spec")))
    out = cases(arrays, spec, mesh)
    # The mesh's own pieces: its fingerprint, a broadcast from rank 0, the
    # rank-major assembly.
    t = torch.full((3,), float(mesh.rank + 1))
    mesh_lib.replicated({"t": t}, mesh)
    out.update({
        "mesh|fingerprint": np.asarray(json.dumps(
            mesh_lib.mesh_fingerprint(mesh), sort_keys=True)),
        "mesh|replicated": t.numpy(),
        "mesh|assembled": mesh.assemble(
            torch.arange(2.0) + 10 * mesh.rank).numpy()})
    mesh.barrier()
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(*sys.argv[1:]))
