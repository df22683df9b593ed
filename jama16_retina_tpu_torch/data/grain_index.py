"""The grain loader's record order, without the ``grain`` package: the
port's copy of pygrain's ``IndexSampler`` with its ``ShardOptions`` and
the per-epoch ``index_shuffle`` (the reference's order,
``jama16_retina_tpu/data/grain_pipeline.py:446``).

``index_shuffle(index, max_index, seed, rounds)`` is grain's compiled
``grain::random::index_shuffle``: a Simon block cipher over a block of
``max(16, even ceil(log2(max_index)))`` bits, whose ``rounds`` round keys
are ``std::seed_seq{seed}.generate(...)``, walked in cycles until the
encrypted index is at most ``max_index``. (Grain's pure-Python sibling,
``index_shuffle_python.py``, is a different function.) The block size
follows grain's arithmetic to the letter, so where ``max_index`` is a
power of two of 16 bits or more the block is one bit too narrow and the
map is not a permutation there; grain's samplers only ever ask for
``max_index = n - 1``, and this copy gives what grain gives either way.

The sampler enumerates global positions 0, 1, 2, ...: position ``g``
belongs to shard ``g % P`` and is that shard's local position ``g // P``;
epoch ``e`` of a shard of ``L`` records is the shuffle of its local
positions ``e*L .. e*L + L - 1`` at seed ``(seed + e) % 2**32``, over the
shard's consecutive slice of the records (``even_split``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

_MASK32 = 0xFFFFFFFF
_MIN_BLOCK = 16


def _seed_seq(seed: int, n: int) -> "list[int]":
    """``std::seed_seq{seed}.generate(out, out + n)``, the algorithm the
    C++ standard fixes ([rand.util.seedseq])."""
    out = [0x8B8B8B8B] * n
    if n == 0:
        return out
    v = [seed & _MASK32]
    s = len(v)
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n]
                            ^ out[(k - 1) % n])) & _MASK32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _MASK32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _MASK32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _MASK32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n]
                                + out[(k - 1) % n]) & _MASK32)) & _MASK32
        r4 = (r3 - k % n) & _MASK32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def _block_bits(max_index: int) -> int:
    """Grain's block size: ``ceil(log2(max_index))`` (in doubles, as its
    C++ computes it), made even, at least 16."""
    bits = math.ceil(math.log2(max_index))
    bits += bits % 2
    bits = max(bits, _MIN_BLOCK)
    if bits > 64:
        raise ValueError(f"max_index={max_index} needs more than 64 bits")
    return bits


def _simon(v: np.ndarray, keys: "list[int]", n: int) -> np.ndarray:
    """Simon encryption of the 2n-bit blocks ``v`` (uint64) under
    ``keys``, two round keys per pass, as grain's ``simon_encrypt<n>``."""
    mask = np.uint64((1 << n) - 1)

    def rotl(z: np.ndarray, k: int) -> np.ndarray:
        left = (z << np.uint64(k)) if k < n else np.zeros_like(z)
        return (left | (z >> np.uint64(n - k))) & mask

    def f(z: np.ndarray) -> np.ndarray:
        return (rotl(z, 1) & rotl(z, 8)) ^ rotl(z, 2)

    x = (v >> np.uint64(n)) & mask
    y = v & mask
    for i in range(0, len(keys), 2):
        x = x ^ f(y) ^ (np.uint64(keys[i]) & mask)
        y = y ^ f(x) ^ (np.uint64(keys[i + 1]) & mask)
    return (x << np.uint64(n)) | y


@functools.lru_cache(maxsize=8)
def _block_table(seed: int, rounds: int) -> np.ndarray:
    """The cipher over the whole 16-bit block at ``seed``."""
    return _simon(np.arange(1 << _MIN_BLOCK, dtype=np.uint64),
                  _seed_seq(seed, rounds), _MIN_BLOCK // 2).astype(np.int64)


def index_shuffle(index, max_index: int, seed: int,
                  rounds: int = 4) -> np.ndarray:
    """The position of each element of ``index`` (int64 array) in grain's
    permutation of ``[0, max_index]`` at ``seed``."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds={rounds} must be even and >= 4")
    index = np.asarray(index, np.int64)
    if max_index == 0:
        return np.zeros_like(index)
    bits = _block_bits(max_index)
    if bits == _MIN_BLOCK:
        return _walk_block(index, max_index, _block_table(seed, rounds))
    keys = _seed_seq(seed, rounds)

    def step(z):
        return _simon(z.astype(np.uint64), keys, bits // 2).astype(np.int64)

    out = step(index)
    walk = out > max_index
    while walk.any():
        out[walk] = step(out[walk])
        walk = out > max_index
    return out


def _walk_block(index: np.ndarray, max_index: int,
                table: np.ndarray) -> np.ndarray:
    """The cycle walk through the 16-bit block's ``table``, for a split
    small enough that a walk takes about 2**16 / n steps: every block
    value's first successor at most ``max_index`` by pointer jumping
    (each pass doubles the steps a pointer covers), instead of the walk
    itself. The cipher reads the low 16 bits of its input, as grain's
    bitsets do."""
    out = table[index & ((1 << _MIN_BLOCK) - 1)]
    far = out > max_index
    if far.any():
        ptr = table.copy()
        done = ptr <= max_index
        nodes = out[far]
        while not done[nodes].all():
            todo = ~done
            nxt = ptr[todo]
            ptr[todo], done[todo] = ptr[nxt], done[nxt]
        out[far] = ptr[nodes]
    return out


def epoch_order(length: int, seed: int, epoch: int) -> np.ndarray:
    """Grain's ``ShuffleMapDataset`` order of one epoch: element ``i`` is
    ``index_shuffle(i, length - 1, (seed + epoch) % 2**32)``."""
    return index_shuffle(np.arange(length), length - 1,
                         (seed + epoch) % 2**32)


@dataclasses.dataclass(frozen=True)
class ShardOptions:
    """Grain's ``ShardOptions`` (its repr is part of the sampler's, and so
    of the iterator state)."""

    shard_index: int
    shard_count: int
    drop_remainder: bool = False

    def __post_init__(self):
        if self.shard_count <= 0:
            raise ValueError("Number of shards must be a positive integer "
                             f"but got {self.shard_count}.")
        if self.shard_index < 0 or self.shard_index >= self.shard_count:
            raise ValueError(
                "Shard shard_index must be in [0, shard_count - 1], "
                f"shard_count was {self.shard_count} and shard_index was "
                f"{self.shard_index}.")


def even_split(num_examples: int, options: ShardOptions
               ) -> "tuple[int, int]":
    """The consecutive records [start, end) of ``options``' shard, as
    grain's ``sharding.even_split`` splits them."""
    per = num_examples // options.shard_count
    start = per * options.shard_index
    end = per * (options.shard_index + 1)
    extra = num_examples % options.shard_count
    if extra > 0 and not options.drop_remainder:
        start += min(options.shard_index, extra)
        end += min(options.shard_index + 1, extra)
    return start, end


class IndexSampler:
    """Grain's ``IndexSampler`` with ``shuffle=True`` and no epoch limit,
    the form the grain loader uses: ``record_keys(positions)`` maps global
    sampler positions to record indices."""

    def __init__(self, num_records: int, shard_options: ShardOptions,
                 seed: int):
        if num_records <= 0:
            raise ValueError(
                "Invalid number of records in Sampler. Got "
                f"{num_records} records, but number of records must be "
                "greater than 0.")
        if not isinstance(seed, int) or seed < 0 or seed.bit_length() > 32:
            raise ValueError("Seed should be positive 32-bit integer.")
        self.num_records = num_records
        self.shard_options = shard_options
        self.seed = seed
        self._start, end = even_split(num_records, shard_options)
        self.shard_len = end - self._start
        self._epochs: "dict[int, np.ndarray]" = {}

    def __repr__(self) -> str:
        return (f"IndexSampler(num_records={self.num_records}, "
                f"shard_options={self.shard_options!r}, "
                f"shuffle=True, num_epochs=None, seed={self.seed})")

    def _epoch(self, epoch: int) -> np.ndarray:
        order = self._epochs.get(epoch)
        if order is None:
            if len(self._epochs) > 2:
                self._epochs.clear()
            order = self._epochs[epoch] = epoch_order(self.shard_len,
                                                      self.seed, epoch)
        return order

    def record_keys(self, positions) -> np.ndarray:
        """Record indices of global positions ``positions`` (each must lie
        in this sampler's shard: ``g % shard_count == shard_index``)."""
        local = np.asarray(positions, np.int64) // \
            self.shard_options.shard_count
        epochs, within = np.divmod(local, self.shard_len)
        out = np.empty_like(local)
        for e in np.unique(epochs):
            sel = epochs == e
            out[sel] = self._epoch(int(e))[within[sel]]
        return out + self._start
