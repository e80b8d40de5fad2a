"""Streaming stage-1 ingest: ChainSeqBuffer semantics and
scan_adapters_stream parity with the one-shot scan (device scan path
forced on the CPU, multi-batch, bucket extension, junk + overflow
fallbacks), plus driver-level byte parity of SCTAG_STREAM on/off."""

import gzip
import pathlib

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl
from sctagger.io.fastq import ChainSeqBuffer, SeqBuffer
from sctagger.models.adapter import scan_adapters, scan_adapters_stream

from oracle import mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def make_sb(seqs):
    buf = np.frombuffer("".join(seqs).encode("latin-1"), dtype=np.uint8).copy()
    offs = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    return SeqBuffer(buf if buf.size else np.zeros(0, np.uint8), offs)


def test_chain_seqbuffer_surface():
    a = ["ACGT", "", "GGGTTT"]
    b = ["TTAACC"]
    c = ["A" * 50, "CGCG"]
    chain = ChainSeqBuffer([make_sb(a), make_sb(b), make_sb(c)])
    ref = a + b + c
    assert len(chain) == len(ref)
    assert [chain[i] for i in range(len(ref))] == ref
    assert list(chain) == ref
    assert chain.lengths.tolist() == [len(s) for s in ref]
    # substr with pythonic slices incl. negatives and e=None
    for i, s in enumerate(ref):
        assert chain.substr(i, 1, -1) == s[1:-1]
        assert chain.substr(i, -3, None) == s[-3:]
        assert chain.substr(i, 0, 0) == ""
    # negative global index
    assert chain[-1] == ref[-1]
    with pytest.raises(IndexError):
        chain[len(ref)]


def test_chain_encode_routes_across_parts():
    from sctagger.core.packing import CODE_PAD, STRICT_TABLE, encode_seqs

    parts = [["ACGTACGT", "TTTT"], ["GGCCGGCC", "ACGTN" + "ACG"], ["T" * 12]]
    flat = [s for p in parts for s in p]
    chain = ChainSeqBuffer([make_sb(p) for p in parts])
    idx = np.array([4, 0, 3, 2, 1], np.int64)  # crosses all three parts
    got, lens = chain.encode_batch(idx, 16, STRICT_TABLE, CODE_PAD)
    want, wlens = encode_seqs([flat[i] for i in idx], 16, STRICT_TABLE)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lens, wlens)
    # packed twin: junk flag set exactly for the 'N' row
    pk, plens, junk = chain.encode_packed(idx, 16, STRICT_TABLE)
    one = ChainSeqBuffer([make_sb(flat)])
    pk1, plens1, junk1 = one.encode_packed(idx, 16, STRICT_TABLE)
    np.testing.assert_array_equal(pk, pk1)
    np.testing.assert_array_equal(plens, plens1)
    np.testing.assert_array_equal(junk, junk1)
    assert junk.tolist() == [flat[i].count("N") > 0 for i in idx]


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


def _gen_reads(rng, n, lo=50, hi=400):
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        t = random_dna(rng, ln)
        r = rng.random()
        if r < 0.35:
            pos = int(rng.integers(0, 25))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 3))) + t[pos:]
        elif r < 0.7:
            pos = max(0, ln - int(rng.integers(5, 30)))
            t = (
                t[:pos]
                + mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 3)))
                + t[pos:]
            )
        seqs.append(t)
    return seqs


def test_stream_d0_prefilter_parity(monkeypatch):
    """The host exact-adapter (d0) prefilter must be output-invisible:
    stream results with it on == off, on a fixture rich in exact fwd hits,
    exact rc hits, both-strand exact ties (=> NA), many-site reads at the
    host cap boundary, and junk reads carrying an exact hit."""
    rng = np.random.default_rng(31)
    reads = _gen_reads(rng, 50)
    reads.append("AC" + ADAPTER + "T" * 9 + rev_compl(ADAPTER) + "GG")  # tie
    reads.append((ADAPTER + "AT") * 9)  # 9 exact fwd hits > host K=8
    reads.append("NN" + ADAPTER + "N" * 20)  # junk read, exact hit
    reads.append("N" * 10 + rev_compl(ADAPTER))  # junk read, exact rc hit
    batches = lambda: iter([(["x"] * len(reads), make_sb(reads))])

    monkeypatch.setenv("SCTAG_ADAPTER_D0", "1")
    _, _, on = scan_adapters_stream(batches(), ADAPTER)
    monkeypatch.setenv("SCTAG_ADAPTER_D0", "0")
    _, _, off = scan_adapters_stream(batches(), ADAPTER)
    assert _flatten(on) == _flatten(off)
    # the prefilter really resolved reads (count rides the PROF dict)
    from sctagger.utils.misc import PROF

    assert PROF.get("scan.d0_resolved_reads", 0) > 0


def test_stream_d1_prefilter_parity(monkeypatch):
    """The dist<=1 host prefilter tier (r5, native/adapter_d1.cpp) must be
    output-invisible: stream results with the full d<=1 scanner == d0-only
    == prefilter fully off, on a fixture rich in 1-edit adapters (subs,
    indels, junk-substitutions, boundary clips) and cross-strand d1 ties."""
    rng = np.random.default_rng(47)
    reads = _gen_reads(rng, 60)  # mutate() plants 0-2 edit adapters
    sub = list(ADAPTER)
    sub[7] = {"A": "C", "C": "A", "G": "T", "T": "G"}[sub[7]]
    reads.append("AAAA" + "".join(sub) + "TT")  # clean 1-sub fwd
    reads.append("GG" + rev_compl(ADAPTER)[:-1])  # rc clipped: 1 del
    reads.append("".join(sub) + "ACGT" + rev_compl("".join(sub)))  # 1-1 tie
    junk = list(ADAPTER)
    junk[3] = "N"
    reads.append("CC" + "".join(junk) + "GG")  # junk byte as the one edit
    reads.append(("".join(sub) + "AT") * 9)  # 9 dist-1 hits > host K=8
    batches = lambda: iter([(["x"] * len(reads), make_sb(reads))])

    from sctagger.utils.misc import PROF

    monkeypatch.setenv("SCTAG_ADAPTER_D0", "1")
    monkeypatch.setenv("SCTAG_ADAPTER_D1", "1")
    monkeypatch.setenv("SCTAG_ADAPTER_D2", "0")  # pin the d1 scanner
    PROF.pop("scan.d1_resolved_reads", None)
    _, _, d1 = scan_adapters_stream(batches(), ADAPTER)
    assert PROF.get("scan.d1_resolved_reads", 0) > 0
    monkeypatch.setenv("SCTAG_ADAPTER_D1", "0")
    _, _, d0 = scan_adapters_stream(batches(), ADAPTER)
    monkeypatch.setenv("SCTAG_ADAPTER_D0", "0")
    _, _, off = scan_adapters_stream(batches(), ADAPTER)
    assert _flatten(d1) == _flatten(off)
    assert _flatten(d0) == _flatten(off)


def test_d0_scanner_declines_non_acgt_adapter(monkeypatch):
    """Regression (r4 review): an adapter with a non-ACGT char must DISABLE
    the d0 prefilter (the packed keys cannot represent it), not crash —
    stage 1 with such an adapter runs the kernel path where the junk char
    simply never matches."""
    from sctagger.models.adapter import make_d0_scanner

    monkeypatch.setenv("SCTAG_ADAPTER_D0", "1")
    assert make_d0_scanner("CTACACGACGCTNTTCCGATCT") is None
    assert make_d0_scanner("ctacacgacgctcttccgatct") is None  # lowercase
    assert make_d0_scanner(ADAPTER) is not None
    # and the stream scan runs end to end with the junk adapter
    rng = np.random.default_rng(13)
    reads = [random_dna(rng, 60) for _ in range(50)]
    _, _, res = scan_adapters_stream(
        iter([(["x"] * len(reads), make_sb(reads))]),
        "CTACACGACGCTNTTCCGATCT",
    )
    assert res.dists.shape[0] == len(reads)


def test_stream_kernel_equals_oneshot():
    rng = np.random.default_rng(77)
    b1 = _gen_reads(rng, 40)
    # batch 2 brings longer reads (bucket extension) + junk + overflow rows
    b2 = _gen_reads(rng, 30, lo=500, hi=900)
    b2.append("CC" + (ADAPTER + "TTT") * 8 + "GG")  # cnt > SLOTS_K
    b2.append("GG" + "N" * 30 + ADAPTER + random_dna(rng, 60))  # junk
    b3 = _gen_reads(rng, 25) + ["", "N" * 40]
    all_reads = b1 + b2 + b3

    ref = scan_adapters(all_reads, ADAPTER)
    batches = [
        ([f"r{i}" for i in range(len(b1))], make_sb(b1)),
        ([f"s{i}" for i in range(len(b2))], make_sb(b2)),
        ([f"t{i}" for i in range(len(b3))], make_sb(b3)),
    ]
    names, chain, got = scan_adapters_stream(
        iter(batches), ADAPTER
    )
    assert len(names) == len(all_reads)
    assert list(chain) == all_reads
    assert _flatten(got) == _flatten(ref)


def test_stream_empty_input():
    names, chain, got = scan_adapters_stream(iter([]), ADAPTER)
    assert names == [] and len(chain) == 0
    assert got.strands.size == 0 and got.loc_counts.size == 0


def _make_fastq(tmp_path: pathlib.Path, rng, n_reads):
    lines = []
    for i in range(n_reads):
        n = int(rng.integers(60, 280))
        seq = random_dna(rng, n)
        r = rng.random()
        if r < 0.45:
            pos = int(rng.integers(5, 30))
            seq = seq[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 4))) + seq[pos:]
        elif r < 0.85:
            cut = max(0, len(seq) - int(rng.integers(5, 30)))
            seq = (
                seq[:cut]
                + mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 4)))
                + seq[cut:]
            )
        lines.append(f"@read{i} x\n{seq}\n+\n{'I' * len(seq)}\n")
    path = tmp_path / "reads.fastq"
    path.write_text("".join(lines))
    return path


def test_driver_stream_matches_oneshot(tmp_path, monkeypatch):
    rng = np.random.default_rng(91)
    fq = _make_fastq(tmp_path, rng, 120)
    out_a = tmp_path / "a.tsv.gz"
    out_b = tmp_path / "b.tsv.gz"
    monkeypatch.setenv("SCTAG_STREAM", "1")
    cli_main(["extract_lr_bc", "-r", str(fq), "-o", str(out_a)])
    monkeypatch.setenv("SCTAG_STREAM", "0")
    cli_main(["extract_lr_bc", "-r", str(fq), "-o", str(out_b)])
    assert gzip.decompress(out_a.read_bytes()) == gzip.decompress(
        out_b.read_bytes()
    )
