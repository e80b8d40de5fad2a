import numpy as np

from sctagger.core import (
    CODE_PAD,
    LENIENT_TABLE,
    STRICT_TABLE,
    encode_seqs,
    encode_str,
    pack_kmers_from_codes,
    rev_compl,
    revcomp_codes,
)


def test_rev_compl_reference_semantics():
    # matches scTagger.py:148-156 — non-ACGT map to themselves, then reversed
    assert rev_compl("ACGT") == "ACGT"
    assert rev_compl("AACG") == "CGTT"
    assert rev_compl("ANGT") == "ACNT"
    assert rev_compl("acgt") == "tgca"  # lowercase untouched
    assert rev_compl("") == ""


def test_strict_vs_lenient_tables():
    s = "ACGTNacgtX"
    strict = encode_str(s, STRICT_TABLE)
    lenient = encode_str(s, LENIENT_TABLE)
    assert list(strict) == [0, 1, 2, 3, 4, 4, 4, 4, 4, 4]
    # reference map_char (scTagger.py:512-516): everything defaults to 0 ('A'),
    # only uppercase C/G/T are set — lowercase acgt all map to 0 as well
    assert list(lenient) == [0, 1, 2, 3, 0, 0, 0, 0, 0, 0]


def test_encode_seqs_padding():
    codes, lengths = encode_seqs(["ACG", "T", ""], pad_to=4)
    assert codes.shape == (3, 4)
    assert list(lengths) == [3, 1, 0]
    assert list(codes[0]) == [0, 1, 2, CODE_PAD]
    assert list(codes[1]) == [3, CODE_PAD, CODE_PAD, CODE_PAD]
    assert list(codes[2]) == [CODE_PAD] * 4


def test_revcomp_codes():
    codes, lengths = encode_seqs(["AACG", "T"], pad_to=5)
    rc = revcomp_codes(codes, lengths)
    exp0, _ = encode_seqs(["CGTT"], pad_to=5)
    assert list(rc[0]) == list(exp0[0])
    assert list(rc[1][:1]) == [0]  # revcomp of T = A
    assert all(c == CODE_PAD for c in rc[1][1:])


def test_pack_kmers():
    codes, lengths = encode_seqs(["ACGTA", "ACNTA"], pad_to=5)
    keys, valid = pack_kmers_from_codes(codes, lengths, k=3)
    # ACG = 0b000110 = 6 ; CGT = 0b011011 = 27 ; GTA = 0b101100 = 44
    assert list(keys[0]) == [0b000110, 0b011011, 0b101100]
    assert list(valid[0]) == [True, True, True]
    assert list(valid[1]) == [False, False, False]  # all windows contain N

    # windows beyond real length are invalid
    codes, lengths = encode_seqs(["ACG"], pad_to=6)
    keys, valid = pack_kmers_from_codes(codes, lengths, k=3)
    assert list(valid[0]) == [True, False, False, False]


def test_pack_kmers_16mer_full_word():
    rng = np.random.default_rng(0)
    s = "".join(rng.choice(list("ACGT"), size=16))
    codes, lengths = encode_seqs([s], pad_to=16)
    keys, valid = pack_kmers_from_codes(codes, lengths, k=16)
    expect = 0
    for ch in s:
        expect = (expect << 2) | "ACGT".index(ch)
    assert int(keys[0, 0]) == expect & 0xFFFFFFFF
    assert valid[0, 0]
