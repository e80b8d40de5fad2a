import numpy as np
import pytest

from sctagger.core import STRICT_TABLE, LENIENT_TABLE, encode_seqs, encode_str
from sctagger.ops import (
    build_peq_multi,
    build_peq_single,
    hw_scores_scan,
    match_block_min,
    match_block_mask,
    shw_scores_scan,
)

from oracle import hw_score_columns, shw_score_columns, mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"  # reference default, scTagger.py:42


def test_exact_32bp_pattern():
    """m == 32 is the single-word boundary: 1 << 31 must not overflow."""
    rng = np.random.default_rng(31)
    pat = random_dna(rng, 32)
    texts = [random_dna(rng, 60), "AA" + pat + "CC", mutate(rng, pat, 2)]
    got = _scores_single(pat, texts)
    for b, t in enumerate(texts):
        np.testing.assert_array_equal(got[b, : len(t)], hw_score_columns(pat, t))


def _scores_single(pattern: str, texts: list[str], shw=False) -> np.ndarray:
    L = max(len(t) for t in texts)
    codes, _ = encode_seqs(texts, pad_to=L)
    peq = build_peq_single(encode_str(pattern))
    fn = shw_scores_scan if shw else hw_scores_scan
    out = fn(codes.astype(np.int32).T, peq, len(pattern))
    return np.asarray(out).T  # (B, L)


@pytest.mark.parametrize("shw", [False, True])
def test_scores_vs_oracle_random(shw):
    rng = np.random.default_rng(42)
    texts = []
    for _ in range(20):
        n = int(rng.integers(1, 120))
        t = random_dna(rng, n)
        if rng.random() < 0.5:  # plant a mutated adapter
            pos = int(rng.integers(0, max(1, n - 10)))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 4))) + t[pos:]
        texts.append(t)
    got = _scores_single(ADAPTER, texts, shw=shw)
    ref_fn = shw_score_columns if shw else hw_score_columns
    for b, t in enumerate(texts):
        ref = ref_fn(ADAPTER, t)
        np.testing.assert_array_equal(got[b, : len(t)], ref, err_msg=f"text {b}")


def test_scores_with_n_chars():
    # N must match nothing in strict mode (edlib semantics)
    texts = ["NNNNNNNNNNNNNNNNNNNNNNNNNNNNNN", "ACGTNNACGT" + ADAPTER + "NNNN"]
    got = _scores_single(ADAPTER, texts)
    for b, t in enumerate(texts):
        ref = hw_score_columns(ADAPTER, t)
        np.testing.assert_array_equal(got[b, : len(t)], ref)


def test_short_pattern_and_16bp_barcode():
    rng = np.random.default_rng(7)
    bc = random_dna(rng, 16)
    texts = [random_dna(rng, 30) for _ in range(8)] + [
        "AA" + bc + "CC",
        "AA" + mutate(rng, bc, 2) + "CC",
    ]
    got = _scores_single(bc, texts)
    for b, t in enumerate(texts):
        np.testing.assert_array_equal(got[b, : len(t)], hw_score_columns(bc, t))


def test_match_block_min_vs_oracle():
    rng = np.random.default_rng(3)
    barcodes = [random_dna(rng, 16) for _ in range(33)]
    segs = []
    for _ in range(17):
        n = int(rng.integers(0, 40))
        s = random_dna(rng, n)
        if rng.random() < 0.7 and barcodes:
            bc = barcodes[rng.integers(len(barcodes))]
            s = s[: n // 2] + mutate(rng, bc, int(rng.integers(0, 3))) + s[n // 2 :]
        segs.append(s)
    Ls = max((len(s) for s in segs), default=1) or 1
    seg_codes, _ = encode_seqs(segs, pad_to=Ls, table=LENIENT_TABLE)
    bc_codes, _ = encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)
    peq = build_peq_multi(bc_codes)
    got = np.asarray(match_block_min(seg_codes.astype(np.int32).T, peq, 16))
    for r, s in enumerate(segs):
        exp = min(
            (hw_score_columns(b, s).min() if s else 16) for b in barcodes
        ) if s else 16
        assert got[r] == exp, (r, s)


def test_match_block_mask_vs_oracle():
    rng = np.random.default_rng(5)
    barcodes = [random_dna(rng, 16) for _ in range(12)]
    # make two barcodes distance-1 apart so ties happen
    barcodes.append(barcodes[0][:-1] + ("A" if barcodes[0][-1] != "A" else "C"))
    segs = ["GG" + barcodes[0] + "TT", "C" + mutate(rng, barcodes[3], 1)]
    seg_codes, _ = encode_seqs(segs, pad_to=24, table=LENIENT_TABLE)
    bc_codes, _ = encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)
    peq = build_peq_multi(bc_codes)
    seg_T = seg_codes.astype(np.int32).T
    mins = np.asarray(match_block_min(seg_T, peq, 16))
    mask = np.asarray(match_block_mask(seg_T, peq, 16, mins))
    for r, s in enumerate(segs):
        dists = np.array([hw_score_columns(b, s).min() for b in barcodes])
        np.testing.assert_array_equal(mask[r], dists == dists.min())
        assert mins[r] == dists.min()
