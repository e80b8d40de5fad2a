"""Stage-1 device scan (ops/adapter_scan.py) vs the jnp mask path and the
brute-force DP oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from sctagger.core import encode_seqs, encode_str, rev_compl
from sctagger.models.adapter import _hw_block
from sctagger.ops.adapter_scan import (
    READ_TILE,
    SLOTS_K,
    adapter_scan,
    n_out_for,
    unpack_scan_out,
)
from sctagger.ops.myers import build_peq_multi

from oracle import edlib_hw_locations, mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _expected(texts, adapter=ADAPTER):
    a2 = rev_compl(adapter)
    peq2 = build_peq_multi(np.stack([encode_str(adapter), encode_str(a2)]))
    L = max(max((len(t) for t in texts), default=1), 1)
    codes, lens = encode_seqs(texts, pad_to=L)
    d, mask = _hw_block(
        jnp.asarray(codes.astype(np.int32).T),
        jnp.asarray(peq2),
        jnp.asarray(lens.astype(np.int32)),
        len(adapter),
    )
    return codes, lens, peq2, np.asarray(d), np.asarray(mask)


def _check(texts, fwd, rc, d_ref, mask_ref, m):
    for p, got in ((0, fwd), (1, rc)):
        np.testing.assert_array_equal(got["d"], np.minimum(d_ref[:, p], m))
        for b in range(len(texts)):
            ends = np.flatnonzero(mask_ref[:, b, p])
            assert got["cnt"][b] == len(ends), (b, p, ends, got["cnt"][b])
            k = min(SLOTS_K, len(ends))
            np.testing.assert_array_equal(got["slots"][b][:k], ends[:k])


def test_adapter_kernel_matches_jnp():
    rng = np.random.default_rng(50)
    texts = []
    for i in range(40):
        n = int(rng.integers(30, 700))
        t = random_dna(rng, n)
        r = rng.random()
        if r < 0.4:
            pos = int(rng.integers(0, 25))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 4))) + t[pos:]
        elif r < 0.8:
            pos = max(0, n - int(rng.integers(5, 30)))
            t = t[:pos] + mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 4))) + t[pos:]
        if i == 0:
            t = "A" * 40  # degenerate homopolymer read
        texts.append(t)
    texts.append("")  # empty read
    # NOTE: reads with in-sequence junk ('N') are OUTSIDE the packed scan's
    # contract — models/adapter.scan_adapters routes them to the mask
    # fallback (covered by test_scan_kernel_path.py).
    codes, lens, peq2, d_ref, mask_ref = _expected(texts)
    fwd, rc = adapter_scan(codes, lens, peq2, len(ADAPTER))
    _check(texts, fwd, rc, d_ref, mask_ref, len(ADAPTER))


def test_adapter_kernel_multi_chunk_state():
    """Reads long enough to span many packed words and long-read padding."""
    rng = np.random.default_rng(51)
    texts = []
    for _ in range(8):
        t = random_dna(rng, int(rng.integers(1200, 2000)))
        pos = int(rng.integers(600, 1100))  # adapter mid-read
        t = t[:pos] + ADAPTER + t[pos:]
        texts.append(t)
    codes, lens, peq2, d_ref, mask_ref = _expected(texts)
    fwd, rc = adapter_scan(codes, lens, peq2, len(ADAPTER))
    _check(texts, fwd, rc, d_ref, mask_ref, len(ADAPTER))


def test_adapter_scan_wide_layout_long_reads():
    """Reads longer than 64K positions take the wide 16-row layout (ends do
    not fit 16 bits); results stay exact past position 65535."""
    rng = np.random.default_rng(52)
    texts = []
    for i in range(3):
        t = random_dna(rng, 66_000 + 500 * i)
        pos = 65_600 + 100 * i  # the only planted hit lies beyond 2^16
        texts.append(t[:pos] + ADAPTER + t[pos:])
    codes, lens, peq2, d_ref, mask_ref = _expected(texts)
    fwd, rc = adapter_scan(codes, lens, peq2, len(ADAPTER))
    assert n_out_for(codes.shape[1]) == 16
    assert (fwd["slots"][:, 0] > 0xFFFF).all()
    _check(texts, fwd, rc, d_ref, mask_ref, len(ADAPTER))


@pytest.mark.parametrize("adapter", ["ACGTTGCAAG", ADAPTER, "CTACACGACGCTCTTCCGATCTAAGGTTCCAA"])
def test_adapter_scan_vs_oracle(adapter):
    """Distance, optimal end count and first ends == the DP oracle
    (edlib HW semantics), for adapters of 10, 22 and 32 bp, on a batch that
    is not a multiple of the batch granularity."""
    rng = np.random.default_rng(len(adapter))
    texts = []
    for _ in range(READ_TILE + 5):
        t = random_dna(rng, int(rng.integers(0, 120)))
        if rng.random() < 0.6:
            a = adapter if rng.random() < 0.5 else rev_compl(adapter)
            p = int(rng.integers(0, len(t) + 1))
            t = t[:p] + mutate(rng, a, int(rng.integers(0, 4))) + t[p:]
        texts.append(t)
    m = len(adapter)
    codes, lens, peq2, _, _ = _expected(texts, adapter)
    fwd, rc = adapter_scan(codes, lens, peq2, m)
    for q, got in ((adapter, fwd), (rev_compl(adapter), rc)):
        for b, t in enumerate(texts):
            d, locs = edlib_hw_locations(q, t)
            ends = [e for _s, e in locs]
            assert int(got["d"][b]) == min(d, m), (b, q)
            assert int(got["cnt"][b]) == len(ends), (b, q)
            k = min(SLOTS_K, len(ends))
            assert got["slots"][b][:k].tolist() == ends[:k], (b, q)


def test_unpack_packed_rows_sign_bit():
    """16-bit packed output rows: slots >= 32768 set the int32 sign bit via
    s<<16; the unpack must recover them exactly (n_out_for packs whenever
    l_total <= 0xffff, so positions up to 65535 are representable)."""
    assert n_out_for(65535) == 8 and n_out_for(65536) == 16
    rng = np.random.default_rng(3)
    B = READ_TILE
    d = rng.integers(0, 23, B).astype(np.int32)
    cnt = rng.integers(0, 255, B).astype(np.int32)
    slots = rng.integers(0, 65536, (B, 4)).astype(np.int32)
    d2 = rng.integers(0, 23, B).astype(np.int32)
    cnt2 = rng.integers(0, 255, B).astype(np.int32)
    slots2 = rng.integers(0, 65536, (B, 4)).astype(np.int32)

    def pack(dd, cc, ss):
        return [
            dd | (cc << 16),
            ss[:, 0] | (ss[:, 1] << 16),
            ss[:, 2] | (ss[:, 3] << 16),
        ]

    out = np.stack(
        pack(d, cnt, slots) + pack(d2, cnt2, slots2)
        + [np.zeros(B, np.int32)] * 2
    )
    fwd, rc = unpack_scan_out(out, B)
    np.testing.assert_array_equal(fwd["d"], d)
    np.testing.assert_array_equal(fwd["cnt"], cnt)
    np.testing.assert_array_equal(fwd["slots"], slots)
    np.testing.assert_array_equal(rc["d"], d2)
    np.testing.assert_array_equal(rc["cnt"], cnt2)
    np.testing.assert_array_equal(rc["slots"], slots2)
