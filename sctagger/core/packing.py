"""Packed sequence arrays — the datatype every kernel consumes.

Device kernels operate on fixed-shape integer arrays, so all DNA sequence data is
encoded host-side into small-integer "code" arrays (one code per base) or
bit-packed k-mer words, via vectorized numpy lookups.

Two encoding tables exist because the reference's two native matchers have
different character semantics, and both must be reproduced exactly:

* STRICT (edlib semantics, stage 1): character equality is exact — ``A,C,G,T``
  map to 0..3, anything else (N, lowercase, ...) maps to CODE_PAD=4, which the
  kernels treat as matching nothing (edlib builds its alphabet from the inputs;
  since the adapter is uppercase ACGT, any other read character can never equal
  an adapter character — cf. reference scTagger.py:180-181).

* LENIENT (trie semantics, stage 3): the reference's ``map_char`` table
  (scTagger.py:512-516) maps every byte to 0 ('A') except C/G/T — so 'N' (and
  any other junk) silently matches 'A' during trie matching. Reproduced here.

Reverse complement uses the reference's 128-entry LUT semantics
(scTagger.py:148-156): non-ACGT characters map to THEMSELVES (N -> N).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3
CODE_PAD = 4  # matches nothing; also used to pad ragged batches

# --- encoding tables (byte value -> code) -----------------------------------
STRICT_TABLE = np.full(256, CODE_PAD, dtype=np.uint8)
for _b, _c in zip(b"ACGT", (CODE_A, CODE_C, CODE_G, CODE_T)):
    STRICT_TABLE[_b] = _c

LENIENT_TABLE = np.zeros(256, dtype=np.uint8)  # default 0 == 'A'
for _b, _c in zip(b"CGT", (CODE_C, CODE_G, CODE_T)):
    LENIENT_TABLE[_b] = _c

# --- reverse complement (string level, reference LUT semantics) -------------
_REV_COMPL_BYTES = np.arange(256, dtype=np.uint8)  # identity for non-ACGT
for _x, _y in zip(b"ACGT", b"TGCA"):
    _REV_COMPL_BYTES[_x] = _y


def rev_compl(s: str) -> str:
    """Reverse complement with identity for non-ACGT chars (scTagger.py:148-156)."""
    a = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
    return _REV_COMPL_BYTES[a][::-1].tobytes().decode("latin-1")


def encode_str(s: str, table: np.ndarray = STRICT_TABLE) -> np.ndarray:
    """Encode one sequence string into a (len,) uint8 code array."""
    a = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
    return table[a]


def encode_seqs(
    seqs: Sequence[str],
    pad_to: int,
    table: np.ndarray = STRICT_TABLE,
    dtype=np.uint8,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of sequences into a padded (N, pad_to) code array.

    Returns (codes, lengths). Sequences longer than ``pad_to`` are an error.
    Padding positions get CODE_PAD (even with the lenient table: padding must
    match nothing; the lenient 'junk matches A' rule applies only to real
    in-sequence characters).
    """
    n = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), count=n, dtype=np.int32)
    if n and int(lengths.max(initial=0)) > pad_to:
        raise ValueError(f"sequence length {int(lengths.max())} > pad_to={pad_to}")
    # Join into one byte buffer; single vectorized table lookup.
    joined = "".join(seqs).encode("latin-1")
    flat = table[np.frombuffer(joined, dtype=np.uint8)] if joined else np.empty(0, np.uint8)
    # zeros+fill, not np.full: malloc-backed first-touch pages are ~500us/
    # page on this host (CLAUDE.md page-fault cliff)
    out = np.zeros((n, pad_to), dtype=dtype)
    out.fill(CODE_PAD)
    if n:
        # Row-major boolean mask selects exactly len(seqs[i]) cells per row, in
        # the same order as the joined flat buffer — one vectorized scatter.
        mask = np.arange(pad_to)[None, :] < lengths[:, None]
        out[mask] = flat
    return out, lengths


def seq_lengths(seqs) -> np.ndarray:
    """Per-row lengths for either a list[str] or an io.fastq.SeqBuffer."""
    lens = getattr(seqs, "lengths", None)
    if lens is not None:
        return np.asarray(lens, dtype=np.int32)
    return np.fromiter((len(s) for s in seqs), count=len(seqs), dtype=np.int32)


def encode_rows(
    seqs, idx, pad_to: int, table: np.ndarray = STRICT_TABLE, dtype=np.uint8
) -> tuple[np.ndarray, np.ndarray]:
    """encode_seqs on the selected rows ``idx`` of ``seqs``.

    Dispatches to the native batch encoder when ``seqs`` is a SeqBuffer
    (no per-read string materialization), else to the Python path.
    """
    enc = getattr(seqs, "encode_batch", None)
    if enc is not None:
        return enc(idx, pad_to, table, CODE_PAD, dtype)
    return encode_seqs([seqs[i] for i in idx], pad_to, table, dtype)


def revcomp_codes(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse-complement padded code arrays row-wise (3-code for ACGT, pad kept)."""
    n, L = codes.shape
    comp = np.array([CODE_T, CODE_G, CODE_C, CODE_A, CODE_PAD], dtype=codes.dtype)
    # Gather column (length-1-j) of each row for output column j, vectorized:
    # out[i, j] = comp[codes[i, lengths[i]-1-j]] for j < lengths[i], else PAD.
    j = np.arange(L)[None, :]
    src = lengths[:, None] - 1 - j
    valid = src >= 0
    src_clamped = np.where(valid, src, 0)
    gathered = comp[np.take_along_axis(codes, src_clamped.astype(np.int64), axis=1)]
    return np.where(valid, gathered, CODE_PAD).astype(codes.dtype)


def pack_kmers_from_codes(
    codes: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pack every k-length window of each row into one uint32 (2 bits/base).

    ``codes`` is (N, L) with values 0..4 (4 = invalid/pad). Returns
    (keys (N, L-k+1) uint32, valid (N, L-k+1) bool): a window is valid iff it
    lies fully within the row's real length AND contains no invalid codes.
    Keys of invalid windows are arbitrary. Requires k <= 16.
    """
    if k > 16:
        raise ValueError("k must be <= 16 to fit one uint32")
    n, L = codes.shape
    W = L - k + 1
    if W <= 0:
        return np.zeros((n, 0), np.uint32), np.zeros((n, 0), bool)
    c = codes.astype(np.uint32)
    keys = np.zeros((n, W), dtype=np.uint32)
    bad = np.zeros((n, W), dtype=bool)
    for j in range(k):
        col = c[:, j : j + W]
        keys = (keys << np.uint32(2)) | (col & np.uint32(3))
        bad |= col > 3
    in_range = np.arange(W)[None, :] + k <= lengths[:, None]
    return keys, (~bad) & in_range
