"""Native C++ FASTQ reader/packer vs the pure-Python reference reader.

The Python reader (read_fastqs_py) is a transliteration of the reference
parser (scTagger.py:159-173); the native parser must match it byte-for-byte
on names and sequences across gzip/plain files, odd whitespace, universal
newlines, and missing trailing newlines.
"""

import gzip

import numpy as np
import pytest

from sctagger.core.packing import (
    CODE_PAD,
    LENIENT_TABLE,
    STRICT_TABLE,
    encode_rows,
    encode_seqs,
    seq_lengths,
)
from sctagger.io.fastq import SeqBuffer, read_fastqs, read_fastqs_py

from oracle import random_dna


def _write(tmp_path, name, text, gz=False):
    p = tmp_path / name
    if gz:
        p.write_bytes(gzip.compress(text.encode()))
    else:
        p.write_text(text)
    return str(p)


def _records(rng, n, with_tricks=False):
    lines = []
    for i in range(n):
        s = random_dna(rng, int(rng.integers(0, 80)))
        if with_tricks and i % 5 == 1:
            s = s[:10] + "N" + s[10:]  # non-ACGT
        if with_tricks and i % 7 == 2:
            s = s.lower()
        hdr = f"@r{i} some comment\tfields" if i % 3 else f"@r{i}"
        if with_tricks and i % 11 == 3:
            hdr = f"  @r{i}\twith-leading-ws"
        lines.append(f"{hdr}\n{s}  \n+\n{'I' * len(s)}\n")
    return "".join(lines)


@pytest.mark.parametrize("gz", [False, True])
def test_native_matches_python(tmp_path, gz):
    rng = np.random.default_rng(7)
    text = _records(rng, 40, with_tricks=True)
    p = _write(tmp_path, "a.fastq.gz" if gz else "a.fastq", text, gz=gz)
    ref_names, ref_seqs = read_fastqs_py([p], gzipped=False, quiet=True)
    names, seqs = read_fastqs([p], gzipped=False, quiet=True)
    assert isinstance(seqs, SeqBuffer)
    assert names == ref_names
    assert list(seqs) == ref_seqs
    assert seqs == ref_seqs  # __eq__ path


def test_multi_file_and_empty(tmp_path):
    rng = np.random.default_rng(3)
    p1 = _write(tmp_path, "a.fastq", _records(rng, 5))
    p2 = _write(tmp_path, "b.fastq", "")  # empty file
    p3 = _write(tmp_path, "c.fastq.gz", _records(rng, 9), gz=True)
    ref = read_fastqs_py([p1, p2, p3], quiet=True)
    got_names, got_seqs = read_fastqs([p1, p2, p3], quiet=True)
    assert got_names == ref[0]
    assert list(got_seqs) == ref[1]


def test_universal_newlines_and_no_trailing_newline(tmp_path):
    # \r\n endings and a final sequence line with no terminator
    text = "@x 1\r\nACGT\r\n+\r\nIIII\r\n@y\nTTAA"
    p = _write(tmp_path, "w.fastq", text)
    ref = read_fastqs_py([p], quiet=True)
    names, seqs = read_fastqs([p], quiet=True)
    assert names == ref[0] == ["x", "y"]
    assert list(seqs) == ref[1] == ["ACGT", "TTAA"]


def test_header_just_at_sign(tmp_path):
    p = _write(tmp_path, "h.fastq", "@\nACG\n+\nIII\n")
    names, seqs = read_fastqs([p], quiet=True)
    assert names == [""]
    assert list(seqs) == ["ACG"]


def test_seqbuffer_substr_and_lengths(tmp_path):
    rng = np.random.default_rng(11)
    p = _write(tmp_path, "s.fastq", _records(rng, 25))
    _, seqs = read_fastqs([p], quiet=True)
    py = list(seqs)
    assert np.array_equal(seq_lengths(seqs), [len(s) for s in py])
    # python slice semantics incl. negative indices and None
    cases = [(0, 5), (-10, None), (3, 0 or None), (-5, -2), (2, -1), (0, None)]
    for i in range(len(py)):
        for s, e in cases:
            assert seqs.substr(i, s, e) == py[i][s:e], (i, s, e)


def test_encode_rows_native_vs_python(tmp_path):
    rng = np.random.default_rng(13)
    p = _write(tmp_path, "e.fastq", _records(rng, 30, with_tricks=True))
    _, seqs = read_fastqs([p], quiet=True)
    py = list(seqs)
    idx = rng.permutation(len(py))[:17]
    for table in (STRICT_TABLE, LENIENT_TABLE):
        ref_codes, ref_lens = encode_seqs(
            [py[i] for i in idx], pad_to=96, table=table
        )
        codes, lens = encode_rows(seqs, idx, pad_to=96, table=table)
        assert np.array_equal(codes, ref_codes)
        assert np.array_equal(lens, ref_lens)
    # overflow guard mirrors encode_seqs
    long_i = int(np.argmax(seq_lengths(seqs)))
    if seq_lengths(seqs)[long_i] > 4:
        with pytest.raises(ValueError):
            encode_rows(seqs, [long_i], pad_to=4)


def test_seqbuffer_slice_view(tmp_path):
    rng = np.random.default_rng(17)
    p = _write(tmp_path, "v.fastq", _records(rng, 12))
    _, seqs = read_fastqs([p], quiet=True)
    py = list(seqs)
    view = seqs[3:9]
    assert list(view) == py[3:9]
    codes, lens = encode_rows(view, np.arange(len(view)), pad_to=96)
    ref_codes, ref_lens = encode_seqs(py[3:9], pad_to=96)
    assert np.array_equal(codes, ref_codes)
    assert np.array_equal(lens, ref_lens)
    # pad cells are CODE_PAD even with the lenient table
    assert (codes[0, lens[0]:] == CODE_PAD).all()
