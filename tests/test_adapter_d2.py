"""Host dist<=2 adapter scan (native/adapter_d2.cpp) vs the DP oracle.

Same contract as test_adapter_d1 one tier up: per-strand end sets at
distances 0, 1 AND 2 must equal {j : hw_score_columns == d}, reverse-strand
starts at the read's minimum must be edlib's minimal optimal starts, and
the whole tier is output-invisible at the stream level.
"""

import numpy as np
import pytest

from sctagger.core.packing import STRICT_TABLE, encode_str, rev_compl

from oracle import edlib_hw_locations, hw_score_columns, mutate, random_dna
from test_stream_scan import ADAPTER, _flatten, _gen_reads, make_sb


def _scanner(adapter=ADAPTER):
    from sctagger.models.adapter import _D2Scanner
    from sctagger.native.build import load

    pat = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(rev_compl(adapter), STRICT_TABLE),
    ])
    return _D2Scanner(load(), pat, len(adapter))


def _flip(c):
    return {"A": "C", "C": "A", "G": "T", "T": "G"}[c]


def _two_edit_fixture(rng, adapter):
    rc = rev_compl(adapter)
    m = len(adapter)
    reads = []
    for core in (adapter, rc):
        # exact / one edit (regression vs the d1 tier)
        reads.append("ACAC" + core + "GTGT")
        t = list(core)
        t[4] = _flip(t[4])
        reads.append("GG" + "".join(t) + "TT")
        # two substitutions (near and far apart)
        for a, b in ((2, 5), (1, m - 2), (m // 2, m // 2 + 1)):
            t = list(core)
            t[a] = _flip(t[a])
            t[b] = _flip(t[b])
            reads.append(random_dna(rng, 6) + "".join(t) + random_dna(rng, 6))
        # sub + del, sub + ins, 2 dels, 2 ins
        t = list(core)
        t[3] = _flip(t[3])
        del t[m // 2]
        reads.append("AA" + "".join(t) + "CC")
        t = list(core)
        t[m - 3] = _flip(t[m - 3])
        t.insert(6, "T")
        reads.append("AA" + "".join(t) + "CC")
        reads.append(
            "GG" + core[:5] + core[6 : m - 2] + core[m - 1 :] + "TT"
        )
        t = list(core)
        t.insert(3, "A")
        t.insert(m - 5, "G")
        reads.append("CC" + "".join(t) + "AA")
        # clipped by two at either boundary
        reads.append(core[2:] + random_dna(rng, 25))
        reads.append(random_dna(rng, 25) + core[:-2])
        # junk byte + substitution = two edits
        t = list(core)
        t[5] = "N"
        t[m - 4] = _flip(t[m - 4])
        reads.append("AA" + "".join(t) + "CC")
        # three edits: must NOT resolve at any tier
        reads.append("AA" + mutate(rng, core, 3) + "CC")
        # trailing double insertion after the pattern (part-C edge)
        reads.append(random_dna(rng, 10) + core + "TT")
        # multi-hit at distance 2
        t = list(core)
        t[2] = _flip(t[2])
        t[m - 3] = _flip(t[m - 3])
        reads.append(("".join(t) + "ATA") * 3)
    # cross-strand 2/2 tie
    t1 = list(adapter)
    t1[4] = _flip(t1[4])
    t1[m - 6] = _flip(t1[m - 6])
    t2 = list(rc)
    t2[6] = _flip(t2[6])
    t2[m - 5] = _flip(t2[m - 5])
    reads.append("".join(t1) + "TT" + "".join(t2))
    reads += ["", "A" * (m - 3), "N" * 50]
    reads += [random_dna(rng, int(rng.integers(10, 300))) for _ in range(40)]
    return reads


@pytest.mark.parametrize("adapter", [ADAPTER, "GATTACAGATTACAG"])
def test_scan2_end_sets_vs_oracle(adapter):
    rng = np.random.default_rng(len(adapter))
    reads = _two_edit_fixture(rng, adapter)
    sc = _scanner(adapter)
    cnts, ends, flags, offs = sc.raw(make_sb(reads))
    f = [cnts[0], cnts[2], cnts[4]]
    r = [cnts[1], cnts[3], cnts[5]]
    K = sc.K
    rc_adapter = rev_compl(adapter)
    m = len(adapter)
    for i, read in enumerate(reads):
        if flags[i]:
            continue
        # tier-2 outputs are defined only when both strands' tier-0/1 are
        # empty (the one case the decision cascade consumes them)
        no01 = all(cs[d][i] == 0 for cs in (f, r) for d in (0, 1))
        for strand, cs in ((adapter, f), (rc_adapter, r)):
            half = 0 if strand == adapter else K
            cols = (
                hw_score_columns(strand, read)
                if read
                else np.zeros(0, np.int64)
            )
            for d in range(3):
                if d == 2 and not no01:
                    continue
                want = np.flatnonzero(cols == d).tolist()
                assert cs[d][i] == len(want), (i, d, read, strand)
                if strand == adapter or d == 0:
                    got = ends[d][i, half : half + min(int(cs[d][i]), K)]
                    assert got.tolist() == want[: K], (i, d, read)
        # rc starts at the read's rc minimum (the only slots apply() uses)
        if read:
            rmin = next((d for d in range(3) if r[d][i] > 0), 3)
            if rmin in (1, 2) and r[rmin][i] <= K:
                d_o, locs = edlib_hw_locations(rc_adapter, read)
                if d_o == rmin:
                    want_starts = [s for s, _ in locs]
                    got = ends[rmin][i, K : K + int(r[rmin][i])]
                    assert got.tolist() == want_starts[: K], (i, read)


def test_stream_d2_prefilter_parity(monkeypatch):
    """The dist<=2 tier is output-invisible: d2 == d1 == d0-only == off on
    a fixture rich in 0/1/2-edit adapters both strands + 2/2 ties."""
    from sctagger.models.adapter import scan_adapters_stream
    from sctagger.utils.misc import PROF

    rng = np.random.default_rng(61)
    reads = _gen_reads(rng, 50)  # plants 0-2 edit adapters
    reads += _two_edit_fixture(rng, ADAPTER)[:20]
    batches = lambda: iter([(["x"] * len(reads), make_sb(reads))])

    monkeypatch.setenv("SCTAG_ADAPTER_D0", "1")
    monkeypatch.setenv("SCTAG_ADAPTER_D1", "1")
    monkeypatch.setenv("SCTAG_ADAPTER_D2", "1")
    PROF.pop("scan.d2_resolved_reads", None)
    _, _, d2 = scan_adapters_stream(batches(), ADAPTER)
    assert PROF.get("scan.d2_resolved_reads", 0) > 0
    monkeypatch.setenv("SCTAG_ADAPTER_D2", "0")
    _, _, d1 = scan_adapters_stream(batches(), ADAPTER)
    monkeypatch.setenv("SCTAG_ADAPTER_D0", "0")
    _, _, off = scan_adapters_stream(batches(), ADAPTER)
    assert _flatten(d2) == _flatten(off)
    assert _flatten(d1) == _flatten(off)


def test_scan2_agrees_with_scan1_on_lower_tiers():
    """Tier-0/1 counts and slots must equal the proven d1 scanner's."""
    from sctagger.models.adapter import _D1Scanner
    from sctagger.native.build import load
    from test_adapter_d1 import _edge_fixture

    rng = np.random.default_rng(8)
    reads = _edge_fixture(rng, ADAPTER) + _two_edit_fixture(rng, ADAPTER)
    sb = make_sb(reads)
    sc2 = _scanner()
    pat = np.stack([
        encode_str(ADAPTER, STRICT_TABLE),
        encode_str(rev_compl(ADAPTER), STRICT_TABLE),
    ])
    sc1 = _D1Scanner(load(), pat, len(ADAPTER))
    cnts, ends, flags2, _ = sc2.raw(sb)
    f0, r0, f1, r1, e0, e1, flags1, _ = sc1.raw(sb)
    K = sc2.K
    for i in range(len(reads)):
        if flags2[i] or flags1[i]:
            continue
        assert cnts[0][i] == f0[i] and cnts[1][i] == r0[i], (i, reads[i])
        assert cnts[2][i] == f1[i] and cnts[3][i] == r1[i], (i, reads[i])
        k = min(int(f0[i]), K)
        assert ends[0][i, :k].tolist() == e0[i, :k].tolist()
        k = min(int(f1[i]), K)
        assert ends[1][i, :k].tolist() == e1[i, :k].tolist()
