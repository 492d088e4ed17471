"""The per-epoch shuffle of the checkpointable input pipeline: a keyed
permutation of `[0, max_index]` computed one index at a time, so that the
order of any record of any epoch is known without storing the epoch.

`index_shuffle(index, max_index, seed, rounds)` is the permutation that
grain's `index_shuffle` computes (the JAX package's `data/grain_loader.py`
shuffles with it), bit for bit:

* the block is W bits: `ceil(log2(max_index))` in double precision, raised
  to an even count and to at least 16 (so for `max_index == 2**k` with k
  even the block holds `[0, 2**k)`, one short of `max_index`: the index
  `max_index` itself walks out of the block, as in grain);
* the round keys are `rounds` 32-bit words of `std::seed_seq{seed}.generate`
  (C++11 [rand.util.seedseq]), each cut to W/2 bits;
* the cipher is the Simon Feistel network on two W/2-bit halves (left = the
  high half), `f(x) = (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)`, two keys a
  pass: `left ^= f(right) ^ k[2i]`, then `right ^= f(left) ^ k[2i+1]`;
* cycle-walking: encrypt at least once, and again while the value exceeds
  `max_index`.

`epoch_permutation(length, seed)` gives `index_shuffle(i, length - 1, seed)`
for every i at once (numpy over the whole block where the block is small,
else over the epoch's indices).
"""

from __future__ import annotations

import functools
import math

import numpy as np

MIN_BLOCK_BITS = 16
_MASK32 = 0xFFFFFFFF


def block_bits(max_index: int) -> int:
    """The cipher's block width W for `max_index` (>= 1)."""
    bits = math.ceil(math.log2(float(max_index)))  # double precision, as in grain
    bits += bits % 2
    return max(bits, MIN_BLOCK_BITS)


@functools.lru_cache(maxsize=64)
def round_keys(seed: int, rounds: int) -> tuple:
    """`rounds` words of `std::seed_seq{seed}.generate(...)`."""
    n = rounds
    b = [0x8B8B8B8B] * n
    s = 1
    v = [seed & _MASK32]
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _MASK32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _MASK32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _MASK32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _MASK32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _MASK32)) & _MASK32
        r4 = (r3 - k % n) & _MASK32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return tuple(b)


def _check(max_index: int, seed: int, rounds: int) -> None:
    if not 0 <= max_index < 2**64:
        raise ValueError(f"max_index {max_index} not in [0, 2**64)")
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} not in [0, 2**32)")
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds {rounds}: an even count of at least 4")


def simon_encrypt(value, half: int, keys):
    """One Simon encryption of `value` over two `half`-bit words: a Python
    int, or a numpy uint64 array element-wise (the same shifts and masks
    serve both)."""
    mask = (1 << half) - 1

    def f(x):
        def rotl(d):
            return ((x << d) | (x >> (half - d))) & mask

        return (rotl(1) & rotl(8)) ^ rotl(2)

    left, right = (value >> half) & mask, value & mask
    for k_left, k_right in zip(keys[::2], keys[1::2]):
        left = left ^ f(right) ^ (k_left & mask)
        right = right ^ f(left) ^ (k_right & mask)
    return (left << half) | right


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """The position of `index` in the keyed permutation of `[0, max_index]`."""
    _check(max_index, seed, rounds)
    if max_index == 0:
        return 0
    half = block_bits(max_index) // 2
    keys = round_keys(seed, rounds)
    value = simon_encrypt(int(index), half, keys)
    while value > max_index:
        value = simon_encrypt(value, half, keys)
    return value


# a whole block is encrypted at once up to this width; wider blocks hold
# `max_index` above a quarter of their range, so a walk is short
_TABLE_BITS = 20


def epoch_permutation(length: int, seed: int, rounds: int = 4) -> np.ndarray:
    """`[index_shuffle(i, length - 1, seed, rounds) for i in range(length)]`
    as an int64 array."""
    if length <= 0:
        raise ValueError(f"length {length} must be positive")
    max_index = length - 1
    _check(max_index, seed, rounds)
    if max_index == 0:
        return np.zeros(1, np.int64)
    bits = block_bits(max_index)
    keys = round_keys(seed, rounds)
    if bits <= _TABLE_BITS:
        # the cipher over the whole block, then each walk along its cycle
        table = simon_encrypt(np.arange(1 << bits, dtype=np.uint64), bits // 2, keys).tolist()
        out = np.empty(length, np.int64)
        for i in range(length):
            v = table[i]
            while v > max_index:
                v = table[v]
            out[i] = v
        return out
    values = simon_encrypt(np.arange(length, dtype=np.uint64), bits // 2, keys)
    walk = values > np.uint64(max_index)
    while walk.any():
        values[walk] = simon_encrypt(values[walk], bits // 2, keys)
        walk = values > np.uint64(max_index)
    return values.astype(np.int64)
