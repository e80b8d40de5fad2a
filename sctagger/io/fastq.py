"""FASTQ ingestion with the reference's exact parsing semantics.

Reference (scTagger.py:159-173): per file, line index resets; line%4==0 gives
the name (first whitespace token, minus the leading '@'), line%4==1 gives the
sequence (rstripped). gzip is used when the flag is set OR the filename ends
with '.gz'.

Two readers share those semantics:

* the native C++ reader/packer (native/fastq_reader.cpp) — the default. It
  returns sequences as one flat byte buffer + offsets wrapped in
  :class:`SeqBuffer`, so the hot stage-1 path (length stats, batch encoding,
  segment slicing) never materializes per-read Python strings;
* the pure-Python reader (``read_fastqs_py``) — fallback when the native
  library is unavailable, and the oracle the native parser is tested against.
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np


class SeqBuffer:
    """Flat byte buffer + offsets view of a batch of sequences.

    Duck-compatible with ``list[str]`` where the stages need it (``len``,
    ``seqs[i] -> str``, iteration, slicing to a sub-batch, equality), plus
    fast vectorized paths: ``.lengths`` (no string walk) and
    ``.encode_batch`` (C++ table-encode straight into a padded code matrix).
    ``buf`` offsets are absolute, so slices share the buffer.
    """

    def __init__(self, buf: np.ndarray, offs: np.ndarray, owner=None):
        assert buf.dtype == np.uint8 and offs.dtype == np.int64
        self.buf = buf
        self.offs = offs  # (n+1,) absolute offsets into buf
        # keeps native memory alive when buf/offs are zero-copy views over
        # the C parser's calloc'd buffers (freed by the owner's finalizer)
        self._owner = owner

    def __len__(self) -> int:
        return len(self.offs) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise IndexError("SeqBuffer slices must be contiguous")
            return SeqBuffer(self.buf, self.offs[start : stop + 1], self._owner)
        o0, o1 = int(self.offs[i]), int(self.offs[i + 1])
        return self.buf[o0:o1].tobytes().decode("latin-1")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, SeqBuffer):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def take(self, idx) -> "SeqBuffer":
        """Gather an arbitrary row subset into a compact new SeqBuffer.

        Runs through the native row gather: the pure-numpy formulation built
        ~25 bytes of malloc-backed int64 index temporaries per copied byte
        and hit the host's page-fault cliff (~50 s for 1M short rows, see
        CLAUDE.md); one C++ memcpy pass with calloc-backed outputs is ~1000x
        faster. Falls back to a plain Python loop if the native lib is
        unavailable."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        lens = self.lengths[idx] if idx.size else np.empty(0, np.int64)
        total = int(lens.sum())
        new_offs = np.zeros(idx.size + 1, np.int64)
        new_buf = np.zeros(total, np.uint8)
        if total:
            try:
                from ..native import build as native_build

                lib = native_build.load()
                lib.sctag_gather_rows(
                    self.buf.ctypes.data, self.offs.ctypes.data,
                    idx.ctypes.data, idx.size,
                    new_buf.ctypes.data, new_offs.ctypes.data,
                )
            except Exception:
                np.cumsum(lens, out=new_offs[1:])
                buf, offs = self.buf, self.offs
                for i, r in enumerate(idx):
                    new_buf[new_offs[i] : new_offs[i + 1]] = buf[
                        offs[r] : offs[r + 1]
                    ]
        return SeqBuffer(new_buf, new_offs)

    def substr(self, i: int, s, e) -> str:
        """``seqs[i][s:e]`` with Python slice semantics, without building the
        full read string (s/e may be negative or None)."""
        o0, o1 = int(self.offs[i]), int(self.offs[i + 1])
        return self.buf[o0:o1][s:e].tobytes().decode("latin-1")

    def row_ptrs(self) -> tuple[np.ndarray, np.ndarray]:
        """(absolute memory address of each row's first byte, row lengths).

        Feeds the native TSV writer: it copies segment bytes straight out of
        this arena, so the addresses are only valid while the buffer (and its
        native owner) stay alive."""
        base = self.buf.ctypes.data
        return base + self.offs[:-1], np.diff(self.offs)

    def encode_batch(
        self, idx, pad_to: int, table: np.ndarray, pad_code: int, dtype=np.uint8
    ) -> tuple[np.ndarray, np.ndarray]:
        """Native equivalent of core.packing.encode_seqs on rows ``idx``."""
        from ..native import build as native_build

        idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
        lens = self.lengths[idx] if idx.size else np.empty(0, np.int64)
        if idx.size and int(lens.max(initial=0)) > pad_to:
            raise ValueError(
                f"sequence length {int(lens.max())} > pad_to={pad_to}"
            )
        # np.zeros, NOT np.empty: calloc-backed pages fault fast on this
        # host; malloc-backed (empty/full) fault at ~500us/page (CLAUDE.md)
        out = np.zeros((idx.size, pad_to), dtype=np.uint8)
        if idx.size:
            lib = native_build.load()
            table = np.ascontiguousarray(table, dtype=np.uint8)
            lib.sctag_encode_rows(
                self.buf.ctypes.data,
                self.offs.ctypes.data,
                idx.ctypes.data,
                idx.size,
                table.ctypes.data,
                pad_code,
                pad_to,
                out.ctypes.data,
            )
        if dtype != np.uint8:
            out = out.astype(dtype)
        return out, lens.astype(np.int32)

    def encode_packed(
        self, idx, pad_to: int, table: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode + 2-bit pack rows ``idx`` in one native pass.

        Returns (packed (n, pad_to//4) uint8 row-major, lengths int32,
        junk bool) — junk marks rows with in-sequence non-ACGT chars, which
        the packed adapter scan cannot represent (ops/adapter_scan.py).
        """
        from ..native import build as native_build

        assert pad_to % 4 == 0, pad_to
        idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
        lens = self.lengths[idx] if idx.size else np.empty(0, np.int64)
        if idx.size and int(lens.max(initial=0)) > pad_to:
            raise ValueError(
                f"sequence length {int(lens.max())} > pad_to={pad_to}"
            )
        out = np.zeros((idx.size, pad_to // 4), dtype=np.uint8)
        junk = np.zeros(idx.size, dtype=np.uint8)
        if idx.size:
            lib = native_build.load()
            table = np.ascontiguousarray(table, dtype=np.uint8)
            lib.sctag_encode_rows_packed(
                self.buf.ctypes.data,
                self.offs.ctypes.data,
                idx.ctypes.data,
                idx.size,
                table.ctypes.data,
                pad_to,
                out.ctypes.data,
                junk.ctypes.data,
            )
        return out, lens.astype(np.int32), junk.astype(bool)


class ChainSeqBuffer:
    """Concatenated zero-copy view over per-batch :class:`SeqBuffer` parts.

    The streaming stage-1 ingest (``read_fastqs_stream``) yields one
    SeqBuffer per batch; this chain presents them as one global-row-indexed
    sequence store with the surface the stage drivers and scanners use
    (``len``, ``lengths``, ``substr``, ``__getitem__``, ``encode_batch``,
    ``encode_packed``) — row lookups route to the owning part instead of
    copying the underlying byte buffers into one arena.
    """

    def __init__(self, parts: Sequence[SeqBuffer] = ()):
        self.parts: list[SeqBuffer] = []
        self._starts = np.zeros(1, np.int64)  # global row offset per part
        self._lengths: np.ndarray | None = None
        for p in parts:
            self.append(p)

    def append(self, part: SeqBuffer) -> None:
        self.parts.append(part)
        self._starts = np.append(self._starts, self._starts[-1] + len(part))
        self._lengths = None

    def __len__(self) -> int:
        return int(self._starts[-1])

    @property
    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            self._lengths = (
                np.concatenate([np.asarray(p.lengths) for p in self.parts])
                if self.parts
                else np.zeros(0, np.int64)
            )
        return self._lengths

    def _locate(self, i: int) -> tuple[SeqBuffer, int]:
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        p = int(np.searchsorted(self._starts, i, side="right")) - 1
        return self.parts[p], i - int(self._starts[p])

    def __getitem__(self, i) -> str:
        part, j = self._locate(int(i))
        return part[j]

    def __iter__(self):
        for p in self.parts:
            yield from p

    def substr(self, i: int, s, e) -> str:
        part, j = self._locate(int(i))
        return part.substr(j, s, e)

    def row_ptrs(self) -> tuple[np.ndarray, np.ndarray]:
        """Concatenated per-part row addresses + lengths (see SeqBuffer)."""
        if not self.parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ptrs, lens = zip(*(p.row_ptrs() for p in self.parts))
        return np.concatenate(ptrs), np.concatenate(lens)

    def _route(self, idx) -> tuple[np.ndarray, np.ndarray]:
        idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
        pid = np.searchsorted(self._starts, idx, side="right") - 1
        return idx, pid

    def encode_batch(
        self, idx, pad_to: int, table: np.ndarray, pad_code: int, dtype=np.uint8
    ) -> tuple[np.ndarray, np.ndarray]:
        idx, pid = self._route(idx)
        out = np.zeros((idx.size, pad_to), dtype=np.uint8)
        lens = np.zeros(idx.size, np.int32)
        for p in np.unique(pid):
            rows = np.flatnonzero(pid == p)
            o, l = self.parts[p].encode_batch(
                idx[rows] - int(self._starts[p]), pad_to, table, pad_code
            )
            out[rows] = o
            lens[rows] = l
        if dtype != np.uint8:
            out = out.astype(dtype)
        return out, lens

    def encode_packed(
        self, idx, pad_to: int, table: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx, pid = self._route(idx)
        out = np.zeros((idx.size, pad_to // 4), dtype=np.uint8)
        lens = np.zeros(idx.size, np.int32)
        junk = np.zeros(idx.size, bool)
        for p in np.unique(pid):
            rows = np.flatnonzero(pid == p)
            o, l, j = self.parts[p].encode_packed(
                idx[rows] - int(self._starts[p]), pad_to, table
            )
            out[rows] = o
            lens[rows] = l
            junk[rows] = j
        return out, lens, junk


def read_fastqs_py(
    fastqs: Sequence[str], gzipped: bool = False, quiet: bool = False
):
    """Pure-Python reader (reference-transliterated semantics)."""
    import gzip

    rnames: list[str] = []
    seqs: list[str] = []
    for fastq in fastqs:
        if not quiet:
            print(f"Reading {fastq}", file=sys.stderr)
        if gzipped or fastq.endswith(".gz"):
            f = gzip.open(fastq, "rt")
        else:
            f = open(fastq, "r")
        with f:
            for idx, line in enumerate(f):
                r = idx % 4
                if r == 0:
                    rnames.append(line.split()[0][1:])
                elif r == 1:
                    seqs.append(line.rstrip())
    return rnames, seqs


def _read_fastq_native(path: str):
    """One file via the C++ parser -> (names, seq bytes, offsets, n_lines)."""
    import ctypes

    from ..native import build as native_build

    lib = native_build.load()
    names_buf = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    n_names = ctypes.c_int64()
    seq_buf = ctypes.c_char_p()
    seq_offs = ctypes.POINTER(ctypes.c_int64)()
    n_seqs = ctypes.c_int64()
    n_lines = ctypes.c_int64()
    err = ctypes.c_char_p()
    rc = lib.sctag_read_fastq(
        path.encode(),
        ctypes.byref(names_buf),
        ctypes.byref(names_len),
        ctypes.byref(n_names),
        ctypes.byref(seq_buf),
        ctypes.byref(seq_offs),
        ctypes.byref(n_seqs),
        ctypes.byref(n_lines),
        ctypes.byref(err),
    )
    if rc != 0:
        msg = err.value.decode() if err.value else "unknown error"
        lib.sctag_free(err)
        raise OSError(f"{path}: {msg}")
    nb = ctypes.string_at(names_buf, names_len.value)
    lib.sctag_free(names_buf)
    # one C-level split: names were '\n'-terminated by the parser
    names = nb.decode("latin-1").split("\n")[:-1] if nb else []
    n = n_seqs.value
    # Zero-copy views over the parser's calloc'd buffers: a string_at copy of
    # a 100MB sequence buffer costs ~0.8s on this host (PyBytes alloc +
    # memcpy), which dominated the read. The owner's finalizer frees the C
    # memory once every consumer (SeqBuffer and its slices) is gone.
    owner = _NativeMem(lib, seq_buf, seq_offs)
    offs = np.frombuffer(
        (ctypes.c_int64 * (n + 1)).from_address(
            ctypes.cast(seq_offs, ctypes.c_void_p).value
        ),
        dtype=np.int64,
    )
    sz = int(offs[n])
    buf = np.frombuffer(
        (ctypes.c_ubyte * sz).from_address(
            ctypes.cast(seq_buf, ctypes.c_void_p).value
        ),
        dtype=np.uint8,
    ) if sz else np.empty(0, np.uint8)
    return names, buf, offs, n_lines.value, owner


class _NativeMem:
    """Finalizer handle for C-allocated buffers wrapped as numpy views."""

    def __init__(self, lib, *ptrs):
        import ctypes

        self._lib = lib
        self._addrs = [ctypes.cast(p, ctypes.c_void_p).value for p in ptrs]

    def __del__(self):
        try:
            for a in self._addrs:
                if a:
                    self._lib.sctag_free(a)
        except Exception:
            pass


def read_fastqs(fastqs: Sequence[str], gzipped: bool = False, quiet: bool = False):
    """Read FASTQ files -> (names: list[str], seqs: SeqBuffer | list[str]).

    Uses the native parser (gzip auto-detected by zlib, so the ``gzipped``
    flag and the ``.gz`` suffix rule are both subsumed); falls back to the
    Python reader if the native library cannot be built/loaded.
    """
    try:
        from ..native import build as native_build

        native_build.ensure_built()
    except Exception:
        return read_fastqs_py(fastqs, gzipped, quiet)

    rnames: list[str] = []
    bufs: list[np.ndarray] = []
    offs_parts: list[np.ndarray] = []
    owners: list = []  # keep native memory alive while views are in use
    for fastq in fastqs:
        if not quiet:
            print(f"Reading {fastq}", file=sys.stderr)
        names, buf, offs, _, owner = _read_fastq_native(fastq)
        rnames.extend(names)
        bufs.append(buf)
        offs_parts.append(offs)
        owners.append(owner)
    if len(bufs) == 1:
        return rnames, SeqBuffer(bufs[0], offs_parts[0], owners[0])
    # multi-file: assemble into calloc-backed arrays (np.zeros — see
    # CLAUDE.md page-fault note); offsets are rebased per file
    total_sz = sum(b.size for b in bufs)
    total_n = sum(len(o) - 1 for o in offs_parts)
    all_buf = np.zeros(total_sz, np.uint8)
    all_offs = np.zeros(total_n + 1, np.int64)
    bpos = 0
    npos = 0
    for buf, offs in zip(bufs, offs_parts):
        all_buf[bpos : bpos + buf.size] = buf
        cnt = len(offs) - 1
        np.add(offs[1:], bpos, out=all_offs[npos + 1 : npos + 1 + cnt])
        bpos += buf.size
        npos += cnt
    return rnames, SeqBuffer(all_buf, all_offs)


def read_fastqs_stream(
    fastqs: Sequence[str],
    gzipped: bool = False,
    batch_records: int = 250_000,
    quiet: bool = False,
):
    """Yield (names: list[str], seqs: SeqBuffer) batches in global read order.

    The native incremental parser emits complete (name, sequence) records per
    batch, so the caller can overlap ingest of batch i+1 with device work on
    batch i (stage-1 pipeline). Semantics match read_fastqs except that a
    trailing header line without its sequence line is dropped rather than
    returned as a dangling name — the stage drivers slice
    ``rnames[:len(seqs)]`` anyway (the reference's zip behavior).

    Raises OSError if the native library is unavailable (callers pick the
    non-streaming path then).
    """
    import ctypes

    from ..native import build as native_build

    lib = native_build.load()
    for fastq in fastqs:
        if not quiet:
            print(f"Reading {fastq}", file=sys.stderr)
        err = ctypes.c_char_p()
        h = lib.sctag_fastq_stream_open(fastq.encode(), ctypes.byref(err))
        if not h:
            msg = err.value.decode() if err.value else "unknown error"
            lib.sctag_free(err)
            raise OSError(f"{fastq}: {msg}")
        try:
            while True:
                names_buf = ctypes.c_char_p()
                names_len = ctypes.c_int64()
                n_recs = ctypes.c_int64()
                seq_buf = ctypes.c_char_p()
                seq_offs = ctypes.POINTER(ctypes.c_int64)()
                rc = lib.sctag_fastq_stream_next(
                    h, batch_records,
                    ctypes.byref(names_buf), ctypes.byref(names_len),
                    ctypes.byref(n_recs), ctypes.byref(seq_buf),
                    ctypes.byref(seq_offs), ctypes.byref(err),
                )
                if rc < 0:
                    msg = err.value.decode() if err.value else "unknown error"
                    lib.sctag_free(err)
                    raise OSError(f"{fastq}: {msg}")
                if rc == 0:
                    break
                nb = ctypes.string_at(names_buf, names_len.value)
                lib.sctag_free(names_buf)
                names = nb.decode("latin-1").split("\n")[:-1] if nb else []
                n = n_recs.value
                owner = _NativeMem(lib, seq_buf, seq_offs)
                offs = np.frombuffer(
                    (ctypes.c_int64 * (n + 1)).from_address(
                        ctypes.cast(seq_offs, ctypes.c_void_p).value
                    ),
                    dtype=np.int64,
                )
                sz = int(offs[n])
                buf = np.frombuffer(
                    (ctypes.c_ubyte * sz).from_address(
                        ctypes.cast(seq_buf, ctypes.c_void_p).value
                    ),
                    dtype=np.uint8,
                ) if sz else np.empty(0, np.uint8)
                yield names, SeqBuffer(buf, offs, owner)
        finally:
            lib.sctag_fastq_stream_close(h)
