"""Device count_and_rank vs a Counter-based python emulation."""

from collections import Counter

import numpy as np

from sctagger.ops.topk_count import count_and_rank


def _python_ref(vals):
    C = Counter()
    for v in vals:
        C[int(v)] += 1
    # insertion-ordered items, stable sort by count desc (reference
    # scTagger.py:828 semantics)
    items = sorted(C.items(), key=lambda x: x[1], reverse=True)
    return items


def test_count_and_rank_random():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 50, size=500).astype(np.uint32)
    keys, counts = count_and_rank(vals)
    ref = _python_ref(vals)
    assert list(zip(keys.tolist(), counts.tolist())) == ref


def test_count_and_rank_tie_order():
    # equal counts must keep first-occurrence order
    vals = np.array([7, 3, 7, 3, 9, 9, 5], dtype=np.uint32)
    keys, counts = count_and_rank(vals)
    assert list(zip(keys.tolist(), counts.tolist())) == [
        (7, 2), (3, 2), (9, 2), (5, 1)
    ]


def test_count_and_rank_valid_mask_and_empty():
    vals = np.array([1, 2, 1, 3], dtype=np.uint32)
    valid = np.array([True, False, True, True])
    keys, counts = count_and_rank(vals, valid)
    assert list(zip(keys.tolist(), counts.tolist())) == [(1, 2), (3, 1)]

    keys, counts = count_and_rank(np.empty(0, np.uint32))
    assert keys.size == 0 and counts.size == 0

    # all invalid
    keys, counts = count_and_rank(vals, np.zeros(4, bool))
    assert keys.size == 0


def test_count_and_rank_max_key():
    # 0xFFFFFFFF is a legitimate key (an all-T packed 16-mer) and must count
    vals = np.array([0, 0, 0xFFFFFFFF, 2**31 - 1, 0xFFFFFFFF], dtype=np.uint32)
    keys, counts = count_and_rank(vals)
    assert list(zip(keys.tolist(), counts.tolist())) == [
        (0, 2), (0xFFFFFFFF, 2), (2**31 - 1, 1)
    ]


def test_count_and_rank_host_twin():
    """count_and_rank_host (the production path) orders identically to the
    device version across random sizes, masks, and tie patterns."""
    from sctagger.ops.topk_count import count_and_rank_host

    rng = np.random.default_rng(7)
    for trial in range(20):
        vals = rng.integers(0, 60, size=int(rng.integers(1, 3000))).astype(
            np.uint32
        )
        valid = rng.random(vals.size) < 0.9 if trial % 2 else None
        kh, ch = count_and_rank_host(vals, valid)
        kd, cd = count_and_rank(vals, valid)
        np.testing.assert_array_equal(kh, kd)
        np.testing.assert_array_equal(ch, cd)
    assert count_and_rank_host(np.empty(0, np.uint32))[0].size == 0
