"""scan_adapters (the packed device scan, on every backend) must equal the
brute-force DP oracle under the reference's get_alns rules, including the
mask fallback for reads with >SLOTS_K optimal ends or in-sequence junk."""

import numpy as np

from sctagger.models.adapter import scan_adapters
from sctagger.core import rev_compl

from oracle import edlib_hw_locations, mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _flatten(res):
    out = []
    off = 0
    for i in range(len(res.strands)):
        c = int(res.loc_counts[i])
        out.append(
            (
                int(res.strands[i]),
                int(res.dists[i]),
                tuple(res.flat_locs[off : off + c].tolist()),
            )
        )
        off += c
    return out


def _oracle_alns(seqs, adapter=ADAPTER):
    """The reference's get_alns per read: the strand with the smaller HW
    distance wins ('+': optimal ends; '-': minimal optimal start of each
    end as start - len - 1); equal distances are NA."""
    out = []
    for t in seqs:
        d1, l1 = edlib_hw_locations(adapter, t)
        d2, l2 = edlib_hw_locations(rev_compl(adapter), t)
        if d1 == d2:
            out.append((-1, -1, ()))
        elif d1 < d2:
            out.append((0, d1, tuple(e for _s, e in l1)))
        else:
            out.append((1, d2, tuple(s - len(t) - 1 for s, _e in l2)))
    return out


def test_kernel_path_equals_mask_path():
    """The packed scan, with its overflow and junk fallbacks, == the DP
    oracle under get_alns rules."""
    rng = np.random.default_rng(60)
    seqs = []
    for i in range(50):
        n = int(rng.integers(50, 400))
        t = random_dna(rng, n)
        r = rng.random()
        if r < 0.35:
            pos = int(rng.integers(0, 25))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 3))) + t[pos:]
        elif r < 0.7:
            pos = max(0, n - int(rng.integers(5, 30)))
            t = (
                t[:pos]
                + mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 3)))
                + t[pos:]
            )
        seqs.append(t)
    # a read with MANY adapter copies -> cnt > SLOTS_K (overflow fallback)
    seqs.append("CC" + (ADAPTER + "TTT") * 8 + "GG")
    # same for reverse strand
    seqs.append("CC" + (rev_compl(ADAPTER) + "TTT") * 8 + "GG")
    # in-sequence junk chars -> packed-kernel contract violation -> exact
    # mask fallback (junk must NOT match the adapter's 'A's)
    seqs.append("GG" + "N" * 30 + ADAPTER + random_dna(rng, 60))
    seqs.append(ADAPTER.replace("A", "N") + random_dna(rng, 80))
    seqs.append("N" * 40)  # all-junk read

    ref = _oracle_alns(seqs)
    got = scan_adapters(seqs, ADAPTER)
    assert _flatten(got) == ref

    # Same fixture through a SeqBuffer: the scan then uses the NATIVE
    # encode+pack+junk pass (io/fastq.py encode_packed) instead of the numpy
    # pack — must equal the oracle too.
    import tempfile, pathlib

    from sctagger.io.fastq import read_fastqs

    with tempfile.TemporaryDirectory() as td:
        fq = pathlib.Path(td) / "reads.fastq"
        fq.write_text(
            "".join(
                f"@r{i} x\n{s}\n+\n{'I' * len(s)}\n"
                for i, s in enumerate(seqs)
            )
        )
        _, sb = read_fastqs([str(fq)], gzipped=False)
    assert hasattr(sb, "encode_packed")
    got_native = scan_adapters(sb, ADAPTER)
    assert _flatten(got_native) == ref


def test_kernel_wide_output_layout(monkeypatch):
    """SCTAG_PACK_LIMIT=1 forces the wide 16-row output layout on short
    reads (the layout ultra-long >64K-char buckets use in production) —
    results must be identical to the default packed 8-row layout."""
    monkeypatch.setenv("SCTAG_PACK_LIMIT", "1")
    rng = np.random.default_rng(61)
    seqs = []
    for i in range(30):
        n = int(rng.integers(50, 300))
        t = random_dna(rng, n)
        if rng.random() < 0.5:
            pos = int(rng.integers(0, 20))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 3))) + t[pos:]
        else:
            pos = max(0, n - int(rng.integers(5, 30)))
            t = (
                t[:pos]
                + mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 3)))
                + t[pos:]
            )
        seqs.append(t)
    wide = scan_adapters(seqs, ADAPTER)
    monkeypatch.delenv("SCTAG_PACK_LIMIT")
    packed = scan_adapters(seqs, ADAPTER)
    assert _flatten(wide) == _flatten(packed)
