"""Multi-word Myers (m > 32) vs the brute-force DP oracle."""

import numpy as np
import pytest

from sctagger.core import STRICT_TABLE, encode_seqs, encode_str
from sctagger.ops.myers import (
    build_peq_multi_mw,
    build_peq_single_mw,
    hw_scores_scan_mw,
    match_block_min_mw,
    n_words,
    shw_scores_scan_mw,
)

from oracle import hw_score_columns, shw_score_columns, mutate, random_dna


@pytest.mark.parametrize("m", [5, 31, 32, 33, 48, 64, 65, 90])
@pytest.mark.parametrize("shw", [False, True])
def test_mw_scores_vs_oracle(m, shw):
    rng = np.random.default_rng(m * 2 + shw)
    pattern = random_dna(rng, m)
    assert n_words(m) == (m + 31) // 32
    texts = []
    for _ in range(6):
        n = int(rng.integers(1, 2 * m + 40))
        t = random_dna(rng, n)
        if rng.random() < 0.6:
            pos = int(rng.integers(0, max(1, n - 3)))
            t = t[:pos] + mutate(rng, pattern, int(rng.integers(0, 5))) + t[pos:]
        texts.append(t)
    L = max(len(t) for t in texts)
    codes, _ = encode_seqs(texts, pad_to=L)
    peq = build_peq_single_mw(encode_str(pattern))
    fn = shw_scores_scan_mw if shw else hw_scores_scan_mw
    got = np.asarray(fn(codes.astype(np.int32).T, peq, m)).T
    ref_fn = shw_score_columns if shw else hw_score_columns
    for b, t in enumerate(texts):
        np.testing.assert_array_equal(
            got[b, : len(t)], ref_fn(pattern, t), err_msg=f"text {b}"
        )


def test_mw_match_block_min():
    rng = np.random.default_rng(9)
    m = 40
    barcodes = [random_dna(rng, m) for _ in range(9)]
    segs = []
    for _ in range(11):
        s = random_dna(rng, int(rng.integers(m, m + 30)))
        if rng.random() < 0.7:
            bc = mutate(rng, barcodes[rng.integers(9)], int(rng.integers(0, 4)))
            segs.append(s[:5] + bc + s[5:])
        else:
            segs.append(s)
    L = max(len(s) for s in segs)
    seg_codes, _ = encode_seqs(segs, pad_to=L)
    peq = build_peq_multi_mw(encode_seqs(barcodes, pad_to=m)[0])
    got = np.asarray(
        match_block_min_mw(seg_codes.astype(np.int32).T, peq, m)
    )
    for r, s in enumerate(segs):
        exp = min(hw_score_columns(b, s).min() for b in barcodes)
        assert got[r] == exp, r
