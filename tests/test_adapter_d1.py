"""Host dist<=1 adapter scan (native/adapter_d1.cpp) vs the DP oracle.

The native scan claims EXACT per-strand HW end sets at distance 0 and 1
(pigeonhole screen + verify). The oracle here is hw_score_columns: the set
of ends at distance d is {j : scores[j] == d}, independent of the overall
minimum — so both tiers are checked even on reads whose min is 0 or >= 2.
Reverse-strand distance-1 starts are checked against edlib_hw_locations
(minimal optimal start per end) on reads whose rc minimum is exactly 1.
"""

import numpy as np
import pytest

from sctagger.core.packing import STRICT_TABLE, encode_str, rev_compl

from oracle import (
    edlib_hw_locations,
    hw_score_columns,
    mutate,
    random_dna,
)
from test_stream_scan import make_sb

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _scanner(adapter=ADAPTER):
    from sctagger.models.adapter import _D1Scanner
    from sctagger.native.build import load

    pat = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(rev_compl(adapter), STRICT_TABLE),
    ])
    return _D1Scanner(load(), pat, len(adapter))


def _edge_fixture(rng, adapter):
    rc = rev_compl(adapter)
    m = len(adapter)
    reads = []
    for core in (adapter, rc):
        reads.append("ACAC" + core + "GTGT")                      # exact
        reads.append(core)                                        # bare
        reads.append(core[1:] + random_dna(rng, 30))              # clip left
        reads.append(random_dna(rng, 30) + core[:-1])             # clip right
        for k in (3, 10, m - 1):                                  # 1 sub
            t = list(core)
            t[k] = {"A": "C", "C": "A", "G": "T", "T": "G"}[t[k]]
            reads.append(random_dna(rng, 8) + "".join(t) + random_dna(rng, 8))
        reads.append("GG" + core[:7] + core[8:] + "TT")           # 1 del
        reads.append("GG" + core[:9] + "T" + core[9:] + "TT")     # 1 ins
        t = list(core)
        t[5] = "N"                                                # junk sub
        reads.append("AA" + "".join(t) + "CC")
        reads.append("AA" + mutate(rng, core, 2) + "CC")          # 2 edits
        reads.append((core + "ATAT") * 3)                         # multi-hit
    # cross-strand distance-1 tie
    t1 = list(adapter)
    t1[4] = {"A": "C", "C": "A", "G": "T", "T": "G"}[t1[4]]
    t2 = list(rc)
    t2[6] = {"A": "C", "C": "A", "G": "T", "T": "G"}[t2[6]]
    reads.append("".join(t1) + "TTTT" + "".join(t2))
    reads += ["", "A", "A" * (m - 2), "A" * 500, "N" * 60]
    reads += [random_dna(rng, int(rng.integers(10, 300))) for _ in range(40)]
    return reads


@pytest.mark.parametrize("adapter", [ADAPTER, "GATTACAGATTACAG"])
def test_scan1_end_sets_vs_oracle(adapter):
    rng = np.random.default_rng(hash(adapter) % 2**31)
    reads = _edge_fixture(rng, adapter)
    sc = _scanner(adapter)
    f0, r0, f1, r1, ends0, ends1, flags, offs = sc.raw(make_sb(reads))
    K = sc.K
    rc_adapter = rev_compl(adapter)
    for i, read in enumerate(reads):
        if flags[i]:
            continue  # candidate overflow: read defers, nothing claimed
        for strand, (c0, c1) in (
            (adapter, (f0[i], f1[i])),
            (rc_adapter, (r0[i], r1[i])),
        ):
            half = 0 if strand == adapter else K
            cols = (
                hw_score_columns(strand, read)
                if read
                else np.zeros(0, np.int64)
            )
            want0 = np.flatnonzero(cols == 0).tolist()
            want1 = np.flatnonzero(cols == 1).tolist()
            assert c0 == len(want0), (i, read, strand)
            assert ends0[i, half : half + min(c0, K)].tolist() == want0[:K]
            assert c1 == len(want1), (i, read, strand)
            if strand == adapter:
                assert (
                    ends1[i, half : half + min(c1, K)].tolist() == want1[:K]
                )
        # rc distance-1 starts: minimal optimal start per end (only checked
        # when the rc minimum is exactly 1 — the only case apply() consumes)
        if read and r0[i] == 0 and 0 < r1[i] <= K:
            d, locs = edlib_hw_locations(rc_adapter, read)
            if d == 1:
                want_starts = [s for s, _ in locs]
                assert ends1[i, K : K + r1[i]].tolist() == want_starts[:K]


def test_scan1_matches_d0_scanner_on_tier0():
    """The d1 scanner's distance-0 tier must agree with the proven d0-only
    scanner (same counts, same end slots) on a mixed fixture."""
    from sctagger.models.adapter import _D0Scanner
    from sctagger.native.build import load

    rng = np.random.default_rng(5)
    reads = _edge_fixture(rng, ADAPTER)
    sb = make_sb(reads)
    sc1 = _scanner()
    pat = np.stack([
        encode_str(ADAPTER, STRICT_TABLE),
        encode_str(rev_compl(ADAPTER), STRICT_TABLE),
    ])
    sc0 = _D0Scanner(load(), pat, len(ADAPTER))
    f0, r0, _, _, ends0, _, flags, _ = sc1.raw(sb)
    fc, rcnt, ends, _ = sc0.raw(sb)
    K = sc1.K
    for i in range(len(reads)):
        if flags[i]:
            continue
        assert f0[i] == fc[i] and r0[i] == rcnt[i], (i, reads[i])
        k = min(int(fc[i]), K)
        assert ends0[i, :k].tolist() == ends[i, :k].tolist()
        k = min(int(rcnt[i]), K)
        assert ends0[i, K : K + k].tolist() == ends[i, K : K + k].tolist()
