"""Stage-3 Pallas kernel (Triton route, interpret mode on the CPU) vs the
plain jnp sweep, the brute-force DP oracle and the C++ oracle."""

import pathlib
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from sctagger.core import LENIENT_TABLE, encode_seqs, rev_compl
from sctagger.ops import build_peq_multi, match_block_min
from sctagger.ops.match_pallas import (
    BIG,
    DEF_BP,
    DEF_BR,
    TIES_K,
    match_full,
    prep_peq_rows,
    prep_segs_T,
    tile_maxlens,
)

from oracle import hw_best, mutate, random_dna


def _run_kernel(seg_codes, lens, peq, m, ls):
    seg_T = prep_segs_T(seg_codes, ls=ls)
    ml = tile_maxlens(np.asarray(lens), seg_T.shape[1])
    return np.asarray(
        match_full(jnp.asarray(seg_T), jnp.asarray(prep_peq_rows(peq)),
                   jnp.asarray(ml), m, interpret=True)
    )


@pytest.fixture(scope="module")
def small_problem():
    rng = np.random.default_rng(11)
    barcodes = [random_dna(rng, 16) for _ in range(40)]
    segs = []
    for _ in range(70):
        n = int(rng.integers(0, 36))
        s = random_dna(rng, n)
        if rng.random() < 0.6:
            bc = barcodes[rng.integers(len(barcodes))]
            s = s[: n // 2] + mutate(rng, bc, int(rng.integers(0, 3))) + s[n // 2 :]
        segs.append(s)
    seg_codes, lens = encode_seqs(segs, pad_to=64, table=LENIENT_TABLE)
    peq = build_peq_multi(encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)[0])
    return segs, barcodes, seg_codes, lens, peq


def test_pallas_min_matches_jnp(small_problem):
    segs, barcodes, seg_codes, lens, peq = small_problem
    got = _run_kernel(seg_codes, lens, peq, 16, 64)[0]
    ref = np.asarray(
        match_block_min(jnp.asarray(seg_codes.T.astype(np.int32)),
                        jnp.asarray(peq), 16)
    )
    np.testing.assert_array_equal(got[: len(segs)], ref)


def test_pallas_full_kernel(small_problem):
    """Single sweep: min + running-min tie collection."""
    from sctagger.models.matcher import _best_matrix_jnp_t

    segs, barcodes, seg_codes, lens, peq = small_problem
    out = _run_kernel(seg_codes, lens, peq, 16, 64)[:, : len(segs)]
    best = np.asarray(_best_matrix_jnp_t(seg_codes, np.asarray(peq), 16))
    for rr in range(len(segs)):
        col = best[: len(barcodes), rr]
        d = col.min()
        hits = np.flatnonzero(col == d)
        assert out[0, rr] == d
        assert out[1, rr] == len(hits), rr
        k = min(TIES_K, len(hits))
        np.testing.assert_array_equal(out[2 : 2 + k, rr], hits[:k])
        assert (out[2 + k :, rr] == BIG).all()


def test_pallas_min_bl32_single_word():
    """Regression: bl=32 barcodes stay on the single-word path (high_bit(32)
    wraps to the int32 sign bit)."""
    rng = np.random.default_rng(32)
    barcodes = [random_dna(rng, 32) for _ in range(8)]
    segs = []
    for _ in range(40):
        n = int(rng.integers(0, 30))
        s = random_dna(rng, n)
        if rng.random() < 0.7:
            bc = barcodes[rng.integers(len(barcodes))]
            s = s[: n // 2] + mutate(rng, bc, int(rng.integers(0, 4))) + s[n // 2 :]
        segs.append(s)
    seg_codes, lens = encode_seqs(segs, pad_to=64, table=LENIENT_TABLE)
    peq = build_peq_multi(encode_seqs(barcodes, pad_to=32, table=LENIENT_TABLE)[0])
    got = _run_kernel(seg_codes, lens, peq, 32, 64)[0][: len(segs)]
    ref = np.asarray(
        match_block_min(jnp.asarray(seg_codes.T.astype(np.int32)),
                        jnp.asarray(peq), 32)
    )
    np.testing.assert_array_equal(got, ref)
    # and against the brute-force DP oracle, independent of the Myers code
    want = np.array(
        [min(hw_best(bc, s) for bc in barcodes) for s in segs], np.int32
    )
    np.testing.assert_array_equal(np.minimum(ref, 32), np.minimum(want, 32))


def test_match_full_variants_parity():
    """The per-tile length bound (maxlens) is exact: a tight bound on
    length-sorted ragged segments == sweeping every tile to the padded
    length."""
    rng = np.random.default_rng(17)
    bl = 16
    bcs = ["".join(rng.choice(list("ACGT"), size=bl)) for _ in range(12)]
    pats = []
    for b in bcs:
        pats.append(rev_compl(b))
        pats.append(b)
    peq = build_peq_multi(encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)[0])
    segs = []
    for i in range(7 * DEF_BR - 5):
        s = "".join(rng.choice(list("ACGT"), size=int(rng.integers(8, 28))))
        if rng.random() < 0.6:
            s = s[:4] + bcs[int(rng.integers(len(bcs)))] + s[4:]
        segs.append(s)
    segs.sort(key=len)
    ls = 48
    codes, lens = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    seg_T = jnp.asarray(prep_segs_T(codes, ls=ls))
    rp = seg_T.shape[1]
    peq_rows = jnp.asarray(prep_peq_rows(peq))
    tight = tile_maxlens(lens, rp)
    assert tight.min() < ls  # the bound really cuts the sweep
    got = np.asarray(match_full(seg_T, peq_rows, jnp.asarray(tight), bl,
                                interpret=True))
    full = np.asarray(match_full(seg_T, peq_rows,
                                 jnp.full(rp // DEF_BR, ls, jnp.int32), bl,
                                 interpret=True))
    np.testing.assert_array_equal(got, full)


def test_prep_layouts():
    """Wrapper shapes and padding: segments position-major with pad code 4,
    Peq base-major padded with empty patterns, per-tile length bounds."""
    codes = np.array([[0, 1, 2], [3, 3, 4]], np.uint8)
    seg_T = prep_segs_T(codes, ls=4)
    assert seg_T.shape == (4, DEF_BR) and seg_T.dtype == np.int8
    np.testing.assert_array_equal(seg_T[:3, :2], codes.T)
    assert (seg_T[3] == 4).all() and (seg_T[:, 2:] == 4).all()
    peq = np.arange(15, dtype=np.int32).reshape(5, 3)
    rows = prep_peq_rows(peq)
    assert rows.shape == (8, DEF_BP)
    np.testing.assert_array_equal(rows[:5, :3], peq)
    assert not rows[:, 3:].any() and not rows[5:].any()
    ml = tile_maxlens(np.array([3] * DEF_BR + [9, 2]), 3 * DEF_BR)
    np.testing.assert_array_equal(ml, [3, 9, 0])


def _oracle_match(segs, barcodes, bl, mr):
    """(rid, dist, sorted tie pattern ids) per matched segment, from the C++
    dense-match oracle (tools/refbench.cpp) — independent Myers code."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
    import native_oracles

    pats = []
    for b in barcodes:
        pats.append(rev_compl(b))
        pats.append(b)
    pc, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    ls = max(max(len(s) for s in segs), 1)
    sc, lens = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    out = native_oracles.match_full(sc, lens, pc, len(pats))
    rows = []
    for r in range(len(segs)):
        if out[0, r] <= mr:
            rows.append((r, int(out[0, r]), out[2 : 2 + out[1, r], r].tolist()))
    return rows


@pytest.mark.parametrize("mr", [0, 1, 2, 3])
@pytest.mark.parametrize("bl", [8, 16, 24, 31])
def test_kernel_path_vs_oracle(monkeypatch, bl, mr):
    """match_segments on the kernel path (interpret mode) == the C++ oracle
    == the plain jnp path: read and pattern counts off the tile multiples,
    ragged lengths under the per-tile bound, N bytes, > TIES_K ties."""
    import sctagger.models.matcher as matcher

    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")  # all reads on device
    rng = np.random.default_rng(100 * bl + mr)
    base = [random_dna(rng, bl) for _ in range(9)]
    barcodes = base + [base[0]] * 9  # 36 patterns; base[0] ties 10 ways
    segs = []
    for r in range(150):
        L = int(rng.integers(0, 2 * bl + 9))
        s = random_dna(rng, L)
        roll = rng.random()
        if roll < 0.3:
            s = s[: L // 2] + mutate(rng, base[0], int(rng.integers(0, mr + 1)))
        elif roll < 0.7:
            b = base[int(rng.integers(len(base)))]
            s = s[: L // 3] + mutate(rng, b, int(rng.integers(0, mr + 2))) + s[L // 3 :]
        if rng.random() < 0.1 and s:
            p = int(rng.integers(len(s)))
            s = s[:p] + "N" + s[p + 1 :]
        segs.append(s)

    def run(fk):
        res = matcher.match_segments(segs, barcodes, max_error=mr,
                                     force_kernel=fk)
        return [
            (int(res.rids[i]), int(res.dists[i]), res.ties_of(i).tolist())
            for i in range(res.rids.size)
        ]

    got = run(True)
    assert got == _oracle_match(segs, barcodes, bl, mr)
    assert got == run(False)
    assert any(len(t) > TIES_K for _, _, t in got)
