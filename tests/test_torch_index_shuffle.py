"""The port's `index_shuffle` (`anystereo_tpu_torch/data/index_shuffle.py`)
against grain's compiled one, which the JAX package's `GrainLoader` shuffles
with: equal on seeded (index, max_index, seed) draws in every block width
from 16 to 64 bits, at the widths' edges (max_index 1, 2, 2**k - 1, 2**k,
2**k + 1), at seeds 0 and 2**32 - 1 and at other round counts; and
`epoch_permutation` against the scalar function, a permutation of the
epoch."""

import numpy as np
import pytest

from anystereo_tpu_torch.data.index_shuffle import block_bits, epoch_permutation, index_shuffle

grain_shuffle = pytest.importorskip(
    "grain._src.python.experimental.index_shuffle.python.index_shuffle_module").index_shuffle

WIDTHS = list(range(16, 66, 2))


def _max_indices(width, rng):
    """max_index values whose block is `width` bits: the edges and draws."""
    lo = 1 if width == 16 else 2 ** (width - 2) + 1
    hi = 2**width if width < 64 else 2**64 - 1
    edges = {lo, lo + 1, 2 ** (width - 1) - 1, 2 ** (width - 1), 2 ** (width - 1) + 1, hi - 1, hi}
    if width == 16:
        edges |= {1, 2, 3, 11}
    draws = {int(x) for x in rng.integers(lo, hi, 6, dtype=np.uint64, endpoint=True)}
    return sorted(m for m in edges | draws if block_bits(m) == width)


@pytest.mark.parametrize("width", WIDTHS)
def test_equal_to_grains_in_every_width(width):
    rng = np.random.default_rng(width)
    cases = 0
    for max_index in _max_indices(width, rng):
        for seed in (0, 2**32 - 1, int(rng.integers(0, 2**32))):
            for index in {0, 1, max_index // 2, max_index - 1, max_index,
                          int(rng.integers(0, max_index, dtype=np.uint64, endpoint=True))}:
                want = grain_shuffle(index, max_index=max_index, seed=seed, rounds=4)
                assert index_shuffle(index, max_index, seed) == want, (index, max_index, seed)
                cases += 1
    assert cases >= 50


def test_block_widths_cover_2_to_the_63():
    """Each width 16..64 is reached, 2**k itself included, and max_index
    2**63 (in double precision log2 gives 63: the block is 64 bits)."""
    assert block_bits(1) == block_bits(2**16) == 16
    assert block_bits(2**16 + 1) == 18 and block_bits(2**63) == 64
    assert sorted({block_bits(2**k + 1) for k in range(1, 64)}) == WIDTHS


@pytest.mark.parametrize("rounds", [6, 8, 16])
def test_other_round_counts(rounds):
    rng = np.random.default_rng(rounds)
    for max_index in (1000, 2**20 + 3, 2**40 - 5):
        seed, index = int(rng.integers(0, 2**32)), int(rng.integers(0, max_index + 1))
        want = grain_shuffle(index, max_index=max_index, seed=seed, rounds=rounds)
        assert index_shuffle(index, max_index, seed, rounds) == want


def test_refuses_what_grain_asserts():
    for bad in (dict(rounds=3), dict(rounds=5), dict(seed=2**32), dict(seed=-1)):
        kw = {"index": 0, "max_index": 10, "seed": 0, "rounds": 4, **bad}
        with pytest.raises(ValueError):
            index_shuffle(**kw)
    assert index_shuffle(0, 0, 5) == 0


@pytest.mark.parametrize("length", [1, 2, 12, 255, 35453, 2**20 + 7])
@pytest.mark.parametrize("seed", [7, 2**32 - 1])
def test_epoch_permutation(length, seed):
    perm = epoch_permutation(length, seed)
    assert perm.dtype == np.int64 and np.array_equal(np.sort(perm), np.arange(length))
    idx = np.random.default_rng(length).integers(0, length, min(length, 300))
    want = [grain_shuffle(int(i), max_index=length - 1, seed=seed, rounds=4) for i in idx]
    assert perm[idx].tolist() == want
    assert [index_shuffle(int(i), length - 1, seed) for i in idx[:50]] == want[:50]
