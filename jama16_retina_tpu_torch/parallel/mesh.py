"""The data axis of the port: ranks, their devices and their collectives
(counterpart of the data-axis half of ``jama16_retina_tpu/parallel/mesh.py``).

The reference lays one ``jax.sharding.Mesh`` with a ``'data'`` axis over
every device of every process, shards each batch over it and lets XLA
insert the gradient mean and the global-batch BatchNorm moments. Here
one rank is one process holding one replica on one device, launched by
``python -m torch.distributed.run`` (``initialize_distributed`` reads its
environment) or, on the CPU, by ``launch_local`` (the train CLI's
``--fake_devices``). A ``Mesh`` is the launch seen from one rank: its
size, its rank, the axis name and the rank's device. Its collectives are
all-reduce and broadcast, nothing else: the gradient mean
(``all_reduce_mean_``), the BatchNorm moments (``mean_over_ranks``,
differentiable), the eval probabilities (``assemble``), the state's
replication from rank 0 (``replicated``) and the barrier.

The backend follows one rule, logged when the group forms: ``nccl`` when
every rank of the host has a card of its own, ``gloo`` when ranks share a
card or run on the CPU (gloo's all-reduce and broadcast take CUDA
tensors). Nothing retries under another backend, and the group has a
finite timeout, so a rank that dies fails the others instead of hanging
them.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from jama16_retina_tpu_torch import device as device_lib

_log = logging.getLogger(__name__)

# What torch.distributed.run sets in every rank it starts.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")
# A collective that waits longer than this fails its rank.
TIMEOUT_S = 120.0


def _launch_env_configured() -> bool:
    return any(os.environ.get(v) for v in LAUNCH_ENV)


def process_count() -> int:
    """The launch's ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device of this process's rank: the CPU when asked for, else
    ``cuda:(LOCAL_RANK % device_count)`` (``device_lib.resolve`` raises
    without a card). Without a launch, the device as resolved."""
    dev = device_lib.resolve(device)
    if dev.type == "cpu" or not _launch_env_configured():
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(dev: torch.device, local_ranks: int) -> str:
    """``nccl`` when every rank of the host has a card of its own, else
    ``gloo`` (ranks that share a card, or ranks on the CPU)."""
    if dev.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(force: bool = False,
                           device: "str | torch.device | None" = None,
                           timeout_s: float = TIMEOUT_S) -> bool:
    """Join the launch's process group, the counterpart of the
    reference's ``initialize_distributed``; the CLIs call it first.
    Without the launcher's environment it does nothing and returns
    False, so the same entry points run one process unchanged (``force``
    treats the environment as configured). A half-set environment is
    refused naming what is missing, before anything reaches the network.
    Returns True when the group is formed."""
    if dist.is_initialized():
        return True
    if not force and not _launch_env_configured():
        return False
    present = [v for v in LAUNCH_ENV if os.environ.get(v)]
    missing = [v for v in LAUNCH_ENV if not os.environ.get(v)]
    if missing:
        raise RuntimeError(
            "multi-process launch env is half-configured: "
            f"{', '.join(present) or 'nothing'} set but {missing[0]} is not "
            f"(set all of {', '.join(LAUNCH_ENV)}, as torch.distributed.run "
            "does, or none of them for one process)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device)
    backend = backend_for(dev, local_ranks)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    _log.info("rank %d of %d on %s: process group over tcp://%s:%s with "
              "backend %s (%d rank(s) on this host, %s)", rank, world, dev,
              addr, port, backend, local_ranks,
              "the CPU" if dev.type == "cpu" else
              f"{torch.cuda.device_count()} card(s)")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as one rank sees it: ``size`` ranks (1 without a
    launch), this process's ``rank``, the axis name, the rank's device,
    the backend and the process group (None for one rank)."""
    size: int
    rank: int
    data_axis: str
    device: torch.device
    backend: "str | None" = None
    group: object = None

    @property
    def axis_names(self) -> "tuple[str]":
        return (self.data_axis,)

    @property
    def shape(self) -> "dict[str, int]":
        return {self.data_axis: self.size}

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, tensors: "list[torch.Tensor]"
                         ) -> "list[torch.Tensor]":
        """Each tensor averaged over the ranks, in place: one flat
        all-reduce per dtype of the list (the reference's ``pmean``),
        the sum then divided by the size."""
        by_dtype: "dict[torch.dtype, list[int]]" = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        with torch.no_grad():
            for idx in by_dtype.values():
                flat = torch.cat([tensors[i].reshape(-1) for i in idx])
                self.all_reduce_(flat).div_(self.size)
                for i, part in zip(idx, flat.split(
                        [tensors[i].numel() for i in idx])):
                    tensors[i].copy_(part.view_as(tensors[i]))
        return tensors

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it: an
        all-reduce of one value, read on the host."""
        if self.size > 1:
            float(self.all_reduce_(torch.ones((), device=self.device)))

    def assemble(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The global rows from each rank's equal block along ``dim``,
        rank-major, on every rank: each rank writes its block into
        zeros and the blocks are summed (a value plus zeros is exact)."""
        if self.size == 1:
            return local
        x = local.movedim(dim, 0)
        out = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[self.rank] = x
        self.all_reduce_(out)
        return out.reshape((-1,) + tuple(x.shape[1:])).movedim(0, dim)


def make_mesh(num_devices: int = 0, axis: str = "data",
              device: "str | torch.device | None" = None) -> Mesh:
    """The 1-D data mesh over the launch's ranks (``parallel.num_devices``
    0: all of them). The device count is the launch's world size, so
    asking for more is refused with the reference's message; one replica
    a rank, so asking for fewer than the launch started is refused too."""
    world = process_count()
    if num_devices > world:
        raise ValueError(f"requested {num_devices} devices, have {world}")
    if num_devices and num_devices != world:
        raise ValueError(
            f"parallel.num_devices={num_devices} is fewer than the launch's "
            f"{world} ranks; each rank holds one replica, so launch "
            f"{num_devices} ranks or set 0 (all of them)")
    dev = rank_device(device)
    if world == 1:
        return Mesh(1, 0, axis, dev)
    return Mesh(world, dist.get_rank(), axis, dev, dist.get_backend(),
                dist.group.WORLD)


def mesh_fingerprint(mesh: "Mesh | None") -> dict:
    """The identity of a mesh with the reference's keys: its shape, its
    axis names and the launch's process count."""
    if mesh is None:
        return {"shape": [1], "axis_names": [],
                "process_count": process_count()}
    return {"shape": [mesh.size], "axis_names": list(mesh.axis_names),
            "process_count": process_count()}


def _batch_axis(mesh: Mesh) -> str:
    """The axis batches shard over: ``'data'`` when the mesh has it, else
    its first axis that is not ``'member'``."""
    if "data" in mesh.axis_names:
        return "data"
    non_member = [a for a in mesh.axis_names if a != "member"]
    return non_member[0] if non_member else mesh.axis_names[0]


def local_rows(n: int, mesh: Mesh, what: str = "data.batch_size") -> slice:
    """This rank's block of a global batch of ``n`` rows; an ``n`` the
    ranks do not divide is refused with the reference's message."""
    if n % mesh.size:
        raise ValueError(
            f"{what}={n} not divisible by process_count={mesh.size}")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors), as
    tensors on the rank's device; scalars whole."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.ndim:
            t = t[local_rows(t.shape[0], mesh)]
        out[k] = t.to(mesh.device)
    return out


def _tensors(tree) -> "list[torch.Tensor]":
    """The tensors of a module (parameters, then buffers), a dataclass, a
    dict, a list or a tensor, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return ([p.data for p in tree.parameters()]
                + [b for b in tree.buffers()])
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicated(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a train state, a module, dicts of
    tensors) broadcast from rank 0 in place, as the reference places a
    state with ``replicated(mesh)``; returns ``tree``. Python values (the
    step) are the caller's: every rank computes them alike."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in _tensors(tree):
                mesh.broadcast_(t)
    return tree


def place_full_local(tree, mesh: Mesh):
    """Values that every rank holds alike (numpy arrays or tensors, in
    dicts) placed whole on the rank's device."""
    if isinstance(tree, dict):
        return {k: place_full_local(v, mesh) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree) if not isinstance(
        tree, torch.Tensor) else tree).to(mesh.device)


class _MeanOverRanks(torch.autograd.Function):
    """y = (sum over ranks of x) / size; its backward is the same mean of
    the incoming gradients, so each rank's gradient through ``y`` carries
    every rank's loss."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone()).div_(mesh.size)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh.all_reduce_(g.clone()).div_(mesh.size), None


def mean_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The differentiable mean of ``x`` over the ranks (identity on one)."""
    if mesh.size == 1:
        return x
    return _MeanOverRanks.apply(x, mesh)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: "list[str]", nprocs: int,
                 timeout_s: "float | None" = None) -> int:
    """Run ``python argv`` as ``nprocs`` ranks on this host, with the
    environment ``torch.distributed.run`` would give them (a free
    localhost port): the CPU launch behind the train CLI's
    ``--fake_devices``. Rank 0 keeps this process's output; the others'
    standard output is dropped. When one rank fails, or ``timeout_s``
    passes, the others are stopped. Returns the first non-zero exit code,
    or 0."""
    port = _free_port()
    procs = []
    for r in range(nprocs):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE": str(nprocs),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL))
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed or (deadline is not None
                          and time.monotonic() > deadline):
                code = failed[0] if failed else 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return code or next((p.returncode for p in procs if p.returncode), 0)
