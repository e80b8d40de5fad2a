"""Native C++ LR-TSV reader vs the Python reference loop, plus SeqBuffer.take."""

import gzip

import numpy as np
import pytest

from sctagger.io.fastq import SeqBuffer
from sctagger.io.tsv import read_lr_segments_tsv, read_lr_segments_tsv_py

from oracle import random_dna


def _write(tmp_path, name, text, gz=False):
    p = tmp_path / name
    if gz:
        p.write_bytes(gzip.compress(text.encode()))
    else:
        p.write_text(text)
    return str(p)


def _rows(rng, n):
    out = []
    for i in range(n):
        if i % 7 == 3:
            out.append(f"r{i}\t-1\tNA\t\n")  # invalid row, empty segment
        else:
            seg = random_dna(rng, int(rng.integers(18, 30)))
            out.append(f"r{i}\t{i % 3}\t{int(rng.integers(-50, 90))}\t{seg}\n")
    return "".join(out)


@pytest.mark.parametrize("gz", [False, True])
def test_native_matches_python(tmp_path, gz):
    rng = np.random.default_rng(3)
    text = _rows(rng, 60)
    p = _write(tmp_path, "lr.tsv.gz" if gz else "lr.tsv", text, gz=gz)
    ref = read_lr_segments_tsv_py(p)
    names, dists, locs, segs = read_lr_segments_tsv(p)
    assert isinstance(segs, SeqBuffer)
    assert (names, dists, locs) == (ref[0], ref[1], ref[2])
    assert list(segs) == ref[3]


def test_extra_fields_and_no_trailing_newline(tmp_path):
    # 5 fields: col3 ends at the 4th tab (python c[3] semantics); final row
    # lacks the newline terminator
    text = "a\t0\t5\tACGT\textra\nb\t1\t6\tTTTT"
    p = _write(tmp_path, "x.tsv", text)
    ref = read_lr_segments_tsv_py(p)
    got = read_lr_segments_tsv(p)
    assert got[0] == ref[0] == ["a", "b"]
    assert list(got[3]) == ref[3] == ["ACGT", "TTTT"]


def test_short_row_falls_back(tmp_path):
    # fewer than 4 fields: native errors -> wrapper falls back to the python
    # reader, which raises IndexError (reference behavior)
    p = _write(tmp_path, "bad.tsv", "a\t0\t5\tACGT\nonly\ttwo\n")
    with pytest.raises(IndexError):
        read_lr_segments_tsv(p)


def test_seqbuffer_take(tmp_path):
    rng = np.random.default_rng(5)
    p = _write(tmp_path, "t.tsv", _rows(rng, 40))
    _, _, locs, segs = read_lr_segments_tsv(p)
    py = list(segs)
    idx = [i for i, l in enumerate(locs) if l != "NA"][::2] + [0, 0]
    sub = segs.take(np.array(idx))
    assert list(sub) == [py[i] for i in idx]
    assert segs.take(np.array([], dtype=np.int64)) == []


def test_native_lr_writer_matches_python_rows(tmp_path):
    """sctag_write_lr_tsv_gz vs the reference row format (scTagger.py:317-320),
    covering negative s/e, e==0 (-> slice to end), invalid rows, empty reads,
    and a multi-part ChainSeqBuffer arena."""
    import gzip

    from sctagger.io.fastq import ChainSeqBuffer, SeqBuffer
    from sctagger.io.tsv import write_lr_tsv_gz_native

    def make_sb(seqs):
        buf = np.frombuffer(
            "".join(seqs).encode("latin-1"), dtype=np.uint8
        ).copy()
        offs = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offs[1:])
        return SeqBuffer(buf if buf.size else np.zeros(0, np.uint8), offs)

    reads = [
        "ACGTACGTACGTACGTACGT",  # fwd-ish: s>=0, e>0
        "TTTTGGGGCCCCAAAA",      # rev-ish: negative s, e==0 -> to end
        "",                      # empty read, invalid
        "AACCGGTT",              # invalid row
        "ACGT" * 30,             # negative s and negative e
        "GG",                    # s clamped past length
    ]
    chain = ChainSeqBuffer([make_sb(reads[:2]), make_sb(reads[2:])])
    rnames = [f"read{i}" for i in range(len(reads))]
    dist = np.array([2, 0, -1, -1, 3, 1], np.int64)
    s = np.array([3, -10, -1, -1, -25, 5], np.int64)
    e = np.array([15, 0, -1, -1, -5, 99], np.int64)
    valid = np.array([1, 1, 0, 0, 1, 1], bool)
    loc = np.where(valid, np.where(s >= 0, s, e), 0).astype(np.int64)

    def py_rows():
        out = []
        for i in range(len(reads)):
            if valid[i]:
                seg = reads[i][int(s[i]) : int(e[i]) or None]
                out.append(f"{rnames[i]}\t{dist[i]}\t{loc[i]}\t{seg}\n")
            else:
                out.append(f"{rnames[i]}\t-1\tNA\t\n")
        return "".join(out)

    p = tmp_path / "out.tsv.gz"
    assert write_lr_tsv_gz_native(
        str(p), rnames, chain, dist, loc, s, e, valid
    )
    assert gzip.decompress(p.read_bytes()).decode() == py_rows()
    # list[str] seqs (no row_ptrs): native path declines
    assert not write_lr_tsv_gz_native(
        str(p), rnames, reads, dist, loc, s, e, valid
    )


def test_native_match_writer_matches_render_rows(tmp_path):
    """sctag_write_match_tsv vs stages.match_trie._render_rows on a synthetic
    MatchResult with slot ties, an overflow tie set (> K slots), rc/fwd
    pattern printing, and both gz and plain outputs."""
    import gzip

    from sctagger.io.fastq import SeqBuffer
    from sctagger.io.tsv import write_match_tsv_native
    from sctagger.models.matcher import MatchResult
    from sctagger.stages.match_trie import _render_rows

    rng = np.random.default_rng(8)
    barcodes = [
        "".join(rng.choice(list("ACGT"), 16)) for _ in range(30)
    ]
    segs_list = ["ACGTACGTACGTACGTACGTACGT", "", "TTTTCCCCGGGGAAAA", "ACG"]
    buf = np.frombuffer(
        "".join(segs_list).encode(), dtype=np.uint8
    ).copy()
    offs = np.zeros(len(segs_list) + 1, np.int64)
    np.cumsum([len(s) for s in segs_list], out=offs[1:])
    segs = SeqBuffer(buf, offs)
    names = [f"lr{i}" for i in range(len(segs_list))]

    K = 16
    rids = np.array([0, 2, 3], np.int64)
    dists = np.array([0, 2, 1], np.int32)
    tie_counts = np.array([2, 20, 1], np.int64)  # row 1 overflows K slots
    tie_slots = np.zeros((3, K), np.int64)
    tie_slots[0, :2] = [5, 8]  # rc bid 2, fwd bid 4
    over = np.sort(rng.choice(60, 20, replace=False)).astype(np.int64)
    tie_slots[1] = over[:K]
    tie_slots[2, :1] = [59]
    result = MatchResult(
        rids=rids, dists=dists, tie_counts=tie_counts,
        tie_slots=tie_slots, overflow={2: over},
    )
    want = _render_rows(result, names, segs, barcodes)

    p = tmp_path / "m.tsv.gz"
    assert write_match_tsv_native(str(p), names, segs, barcodes, result)
    assert gzip.decompress(p.read_bytes()).decode() == want
    q = tmp_path / "m.tsv"
    assert write_match_tsv_native(str(q), names, segs, barcodes, result)
    assert q.read_text() == want
    # list[str] segments: native path declines
    assert not write_match_tsv_native(
        str(q), names, segs_list, barcodes, result
    )
