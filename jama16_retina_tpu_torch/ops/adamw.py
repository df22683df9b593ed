"""AdamW update, kernel B3 (counterpart of
``jama16_retina_tpu/ops/pallas_opt.py::fused_adamw_update``).

Per element of every parameter leaf, in this order and with one
rounding per operation (the Pallas kernel's order):

    mu' = 0.9 * mu + 0.1 * g
    nu' = 0.999 * nu + (0.001 * g) * g
    u   = (mu' * c1) / (sqrt(nu' * c2) + 1e-8)
    u   = u + wd * p                 (leaves of rank >= 2 only)
    p'  = p - lr * u

``scalars`` is a float32 device 3-vector ``[lr, c1, c2]`` from
``adamw_scalars``: the schedule's learning rate at its own count and the
bias corrections ``1 / (1 - b^t)`` at ``t = count + 1``. It stays on the
device so that the step needs no host value.

``fused_adamw_update`` launches one CUDA kernel (``csrc/adamw.cu``) over
every leaf when the tensors lie on the card (one per 400 leaves), counting
each launch, and
runs the plain version ``adamw_reference`` (one PyTorch operation per
line above, per leaf) when they lie on the CPU. Both update ``params``,
``mu`` and ``nu`` in place, which saves a copy of the optimizer state
per step; ``grads`` are read only. On the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# optax.adamw's defaults, as the JAX package's make_optimizer runs them.
B1, B2, EPS = 0.9, 0.999, 1e-8
# Elements one block of the kernel updates.
CHUNK = 8192

# Times the CUDA kernel was launched in this process.
launches = 0


def adamw_scalars(count: torch.Tensor, sched_count: torch.Tensor,
                  schedule) -> torch.Tensor:
    """float32 [lr, 1/(1-0.9^t), 1/(1-0.999^t)] on the counts' device,
    with ``t = count + 1`` (``pallas_opt.py:116-126``); ``schedule`` maps
    the schedule's count tensor to the learning rate."""
    t = (count + 1).float()
    c1 = 1.0 / (1.0 - torch.pow(B1, t))
    c2 = 1.0 / (1.0 - torch.pow(B2, t))
    return torch.stack([schedule(sched_count).float(), c1, c2])


def _check(params, grads, mu, nu, decay, scalars) -> None:
    n = len(params)
    if not (len(grads) == len(mu) == len(nu) == len(decay) == n) or n == 0:
        raise ValueError("params, grads, mu, nu and decay must have one "
                         "entry per leaf (at least one)")
    dev = params[0].device
    if scalars.shape != (3,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be float32 [3], got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        for t in leaf:
            if t.dtype != torch.float32 or t.shape != leaf[0].shape:
                raise ValueError(
                    f"leaf {i}: expected float32 {tuple(leaf[0].shape)}, got "
                    f"{t.dtype} {tuple(t.shape)}")
            if t.device != dev:
                raise ValueError(f"leaf {i} lies on {t.device}, not {dev}")
    if scalars.device != dev:
        raise ValueError(f"scalars lie on {scalars.device}, not {dev}")


def _dense(t: torch.Tensor) -> bool:
    return (t.is_contiguous()
            or t.is_contiguous(memory_format=torch.channels_last))


def _same_order(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Dense tensors of one shape hold their elements in the same order
    when their strides agree on every dimension longer than 1 (a 1x1
    conv kernel has two valid stride tuples for one layout)."""
    return all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
               if n > 1)


def adamw_reference(params, grads, mu, nu, decay, scalars: torch.Tensor,
                    weight_decay: float) -> None:
    """Plain version: the update above, leaf by leaf, in place."""
    _check(params, grads, mu, nu, decay, scalars)
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    with torch.no_grad():
        for p, g, m, v, decayed in zip(params, grads, mu, nu, decay):
            m.mul_(B1).add_(g * (1.0 - B1))
            v.mul_(B2).add_(g * (1.0 - B2) * g)
            u = (m * c1) / ((v * c2).sqrt() + EPS)
            if decayed:
                u = u + weight_decay * p
            p.sub_(lr * u)


# One row of the kernel's leaf table (``struct Leaf`` in csrc/adamw.cu).
_LEAF = np.dtype([("p", "<i8"), ("g", "<i8"), ("mu", "<i8"), ("nu", "<i8"),
                  ("n", "<i8"), ("first_block", "<i4"), ("decay", "<i4")])


@functools.cache
def _library():
    """The kernel's C entry points, built and bound on first use:
    (launch, most leaves per launch)."""
    from jama16_retina_tpu_torch.ops import build

    lib = build.load("adamw")
    fn = lib.adamw_launch
    ptr, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn.argtypes = [ptr, i, i, ptr, f, f, f, f, f, f, i, ptr]
    fn.restype = i
    lib.adamw_max_leaves.restype = i
    return fn, lib.adamw_max_leaves()


def _leaf_table(params, grads, mu, nu, decay) -> "tuple[np.ndarray, int]":
    """The kernel's host leaf table for these leaves, and its block
    count: each leaf's pointers, size and decay flag, and the first of
    its ``ceil(size / CHUNK)`` blocks. It is built anew at every call and
    passed by value, so tensors may move between steps."""
    table = np.zeros(len(params), _LEAF)
    for col, tensors in (("p", params), ("g", grads), ("mu", mu),
                         ("nu", nu)):
        table[col] = [t.data_ptr() for t in tensors]
    table["n"] = [p.numel() for p in params]
    table["decay"] = [bool(d) for d in decay]
    blocks = -(-table["n"] // CHUNK)
    table["first_block"] = np.cumsum(blocks) - blocks
    return table, int(blocks.sum())


def fused_adamw_update(params, grads, mu, nu, decay, scalars: torch.Tensor,
                       weight_decay: float) -> None:
    """B3: the AdamW update of every leaf in place, in one launch on the
    card per 400 leaves (lists of float32 tensors of matching shapes;
    ``decay`` is one bool per leaf). CPU tensors take the plain version."""
    global launches
    _check(params, grads, mu, nu, decay, scalars)
    dev = params[0].device
    if dev.type == "cpu":
        adamw_reference(params, grads, mu, nu, decay, scalars, weight_decay)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not scalars.is_contiguous():
        raise ValueError("scalars must be contiguous")
    for leaf in zip(params, grads, mu, nu):
        if not all(_dense(t) and _same_order(t, leaf[0]) for t in leaf):
            raise ValueError(
                "each leaf, its grad and its moments must be contiguous (or "
                "channels_last) with the same strides")
    launch, max_leaves = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(params), max_leaves):
        part = slice(lo, lo + max_leaves)
        table, n_blocks = _leaf_table(params[part], grads[part], mu[part],
                                      nu[part], decay[part])
        err = launch(table.ctypes.data, len(table), n_blocks,
                     scalars.data_ptr(), B1, 1.0 - B1, B2, 1.0 - B2, EPS,
                     float(weight_decay), CHUNK, stream)
        if err:
            raise RuntimeError(f"adamw kernel launch failed: cudaError {err} "
                               f"over {len(table)} leaves")
        launches += 1
