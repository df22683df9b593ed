"""JAX's threefry PRNG and its permutation in numpy: the batch order of the
``hbm`` loader (``data/hbm_pipeline.py``), bitwise the reference's.

The reference draws each epoch's order on the device as

    jax.random.permutation(jax.random.fold_in(jax.random.key(seed), epoch), n)

(``jama16_retina_tpu/data/hbm_pipeline.py``, ``make_batch_fn``). This
module computes the same permutation on the host, copying, under
``jax_threefry_partitionable=True`` (the default since JAX 0.5):

- ``threefry2x32``: ``jax._src.prng.threefry2x32`` (the Threefry-2x32 block
  cipher with 20 rounds and the key schedule's 0x1BD11BDA parity word);
- ``key``: ``jax.random.key(seed)`` (``threefry_seed``: the high and low
  32-bit words of the seed) for 0 <= seed < 2**63;
- ``fold_in``: ``jax.random.fold_in`` (``threefry_2x32(key,
  threefry_seed(uint32(data)))``);
- ``split``: ``jax.random.split`` (``_threefry_split_foldlike``: key i is
  the cipher of the 64-bit counter i);
- ``random_bits``: ``jax.random.bits`` for 32-bit words
  (``_threefry_random_bits_partitionable``: word i is the XOR of the two
  halves of the cipher of the 64-bit counter i);
- ``permutation``: ``jax.random.permutation(key, n)`` (``_shuffle``:
  ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a split and a stable sort
  of the order by fresh 32-bit keys).

A key is a pair of Python ints, each a 32-bit word.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_UINT32_MAX = 0xFFFFFFFF


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: "tuple[int, int]", x0: np.ndarray, x1: np.ndarray
                 ) -> "tuple[np.ndarray, np.ndarray]":
    """The cipher of the counter words (``x0``, ``x1``) under ``key``:
    two uint32 arrays of the counters' shape."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, np.uint32(int(k0) ^ int(k1) ^ _PARITY))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> "tuple[int, int]":
    """``jax.random.key(seed)``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return (seed >> 32) & _UINT32_MAX, seed & _UINT32_MAX


def _counters(n: int) -> "tuple[np.ndarray, np.ndarray]":
    """The high and low words of the 64-bit counters 0 .. n - 1."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(_UINT32_MAX)).astype(np.uint32))


def fold_in(k: "tuple[int, int]", data: int) -> "tuple[int, int]":
    """``jax.random.fold_in(k, data)``: ``data`` taken as a uint32."""
    a, b = threefry2x32(k, np.zeros(1, np.uint32),
                        np.array([int(data) & _UINT32_MAX], np.uint32))
    return int(a[0]), int(b[0])


def split(k: "tuple[int, int]", num: int = 2) -> "list[tuple[int, int]]":
    """``jax.random.split(k, num)``."""
    a, b = threefry2x32(k, *_counters(num))
    return [(int(x), int(y)) for x, y in zip(a, b)]


def random_bits(k: "tuple[int, int]", n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)``."""
    a, b = threefry2x32(k, *_counters(n))
    return a ^ b


def shuffle_rounds(n: int) -> int:
    """The sort rounds of ``_shuffle`` for ``n`` items."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))


def permutation(k: "tuple[int, int]", n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)`` as int64 [n]."""
    x = np.arange(n, dtype=np.int64)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """``permutation(fold_in(key(seed), epoch), n)``: the reference hbm
    loader's order of epoch ``epoch``."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    return permutation(fold_in(key(seed), epoch), n)
