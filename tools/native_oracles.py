"""Build/load the reference-class native oracles (tools/refbench.cpp) and
generate functional edlib/ahocorasick stub modules backed by them.

These give the reference script (/root/reference/scTagger.py) native-speed
dependencies for HONEST baseline measurement (its real deps, edlib and
pyahocorasick, are C/C++ and not installable here), and give the test suite
an independent C++ implementation to fuzz the kernels' edit-distance and
multi-pattern-match semantics against.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "refbench.cpp"
_LIB = _DIR / "librefbench.so"


def ensure_built() -> pathlib.Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread", str(_SRC), "-o", str(_LIB)],
        check=True, capture_output=True, text=True,
    )
    return _LIB


def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    lib.sctag_ref_hw_locations.restype = ctypes.c_int
    lib.sctag_ref_hw_locations.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sctag_ref_free.argtypes = [ctypes.c_void_p]
    lib.sctag_ref_match_full.restype = ctypes.c_int
    lib.sctag_ref_match_full.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.sctag_ac_create.restype = ctypes.c_void_p
    lib.sctag_ac_destroy.argtypes = [ctypes.c_void_p]
    lib.sctag_ac_add.restype = ctypes.c_int
    lib.sctag_ac_add.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
    ]
    lib.sctag_ac_build.argtypes = [ctypes.c_void_p]
    lib.sctag_ac_size.restype = ctypes.c_int64
    lib.sctag_ac_size.argtypes = [ctypes.c_void_p]
    lib.sctag_ac_iter.restype = ctypes.c_int64
    lib.sctag_ac_iter.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    return lib


def hw_locations(query: str, target: str, lib=None):
    """(distance, [(start, end), ...]) — edlib align(HW,'locations') surface."""
    lib = lib or load()
    dist = ctypes.c_int()
    locs = ctypes.POINTER(ctypes.c_int64)()
    nl = ctypes.c_int64()
    rc = lib.sctag_ref_hw_locations(
        query.encode(), len(query), target.encode(), len(target),
        ctypes.byref(dist), ctypes.byref(locs), ctypes.byref(nl),
    )
    assert rc == 0, rc
    out = [(int(locs[2 * i]), int(locs[2 * i + 1])) for i in range(nl.value)]
    if nl.value:
        lib.sctag_ref_free(locs)
    return dist.value, out


def match_full(seg_codes, lens, pat_codes, k: int, nthreads: int = 0,
               lib=None):
    """Stage-3 oracle: (k+2, R) int32 [min, count at min, first k pattern
    ids] for (R, ls) uint8 segment codes against (P, m) pattern codes."""
    import os

    import numpy as np

    lib = lib or load()
    segs = np.ascontiguousarray(seg_codes, np.uint8)
    pats = np.ascontiguousarray(pat_codes, np.uint8)
    ln = np.ascontiguousarray(lens, np.int32)
    R, ls = segs.shape
    P, m = pats.shape
    out = np.zeros((k + 2, R), np.int32)
    rc = lib.sctag_ref_match_full(
        segs.ctypes.data, ln.ctypes.data, R, ls, pats.ctypes.data, P, m, k,
        out.ctypes.data, nthreads or (os.cpu_count() or 1),
    )
    assert rc == 0, rc
    return out


class Automaton:
    """pyahocorasick-surface wrapper over the C++ automaton."""

    def __init__(self, lib=None):
        self._lib = lib or load()
        self._h = ctypes.c_void_p(self._lib.sctag_ac_create())

    def __del__(self):
        try:
            self._lib.sctag_ac_destroy(self._h)
        except Exception:
            pass

    def add_word(self, word: str, value: int) -> None:
        rc = self._lib.sctag_ac_add(self._h, word.encode(), len(word), value)
        assert rc == 0, (rc, word)

    def make_automaton(self) -> None:
        self._lib.sctag_ac_build(self._h)

    def __len__(self) -> int:
        return int(self._lib.sctag_ac_size(self._h))

    def iter(self, haystack: str):
        h = haystack.encode()
        cap = 64
        while True:
            ends = (ctypes.c_int64 * cap)()
            vals = (ctypes.c_int64 * cap)()
            total = int(
                self._lib.sctag_ac_iter(self._h, h, len(h), ends, vals, cap)
            )
            assert total >= 0, total
            if total <= cap:
                return [(int(ends[i]), int(vals[i])) for i in range(total)]
            cap = total


# ---------------------------------------------------------------------------
# Functional stub sources (written into the reference's PYTHONPATH dir)
# ---------------------------------------------------------------------------


def edlib_stub_source() -> str:
    lib = ensure_built()
    return f'''\
# Native-speed edlib substitute (Myers bit-vector, tools/refbench.cpp) for
# honest reference baselining — same C performance class as real edlib.
import ctypes

_lib = ctypes.CDLL({str(lib)!r})
_lib.sctag_ref_hw_locations.restype = ctypes.c_int
_lib.sctag_ref_hw_locations.argtypes = [
    ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ctypes.POINTER(ctypes.c_int64),
]
_lib.sctag_ref_free.argtypes = [ctypes.c_void_p]


def align(query, target, mode, task):
    assert mode == 'HW', mode
    dist = ctypes.c_int()
    locs = ctypes.POINTER(ctypes.c_int64)()
    nl = ctypes.c_int64()
    rc = _lib.sctag_ref_hw_locations(
        query.encode(), len(query), target.encode(), len(target),
        ctypes.byref(dist), ctypes.byref(locs), ctypes.byref(nl),
    )
    assert rc == 0, rc
    out = [(locs[2 * i], locs[2 * i + 1]) for i in range(nl.value)]
    if nl.value:
        _lib.sctag_ref_free(locs)
    return {{'editDistance': dist.value, 'locations': out}}
'''


def ahocorasick_stub_source() -> str:
    lib = ensure_built()
    return f'''\
# Native-speed pyahocorasick substitute (tools/refbench.cpp) for honest
# reference baselining — a real goto/fail-link automaton in C++.
import ctypes

_lib = ctypes.CDLL({str(lib)!r})
_lib.sctag_ac_create.restype = ctypes.c_void_p
_lib.sctag_ac_destroy.argtypes = [ctypes.c_void_p]
_lib.sctag_ac_add.restype = ctypes.c_int
_lib.sctag_ac_add.argtypes = [
    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
_lib.sctag_ac_build.argtypes = [ctypes.c_void_p]
_lib.sctag_ac_iter.restype = ctypes.c_int64
_lib.sctag_ac_iter.argtypes = [
    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64]


def match_full(seg_codes, lens, pat_codes, k: int, nthreads: int = 0,
               lib=None):
    """Stage-3 oracle: (k+2, R) int32 [min, count at min, first k pattern
    ids] for (R, ls) uint8 segment codes against (P, m) pattern codes."""
    import os

    import numpy as np

    lib = lib or load()
    segs = np.ascontiguousarray(seg_codes, np.uint8)
    pats = np.ascontiguousarray(pat_codes, np.uint8)
    ln = np.ascontiguousarray(lens, np.int32)
    R, ls = segs.shape
    P, m = pats.shape
    out = np.zeros((k + 2, R), np.int32)
    rc = lib.sctag_ref_match_full(
        segs.ctypes.data, ln.ctypes.data, R, ls, pats.ctypes.data, P, m, k,
        out.ctypes.data, nthreads or (os.cpu_count() or 1),
    )
    assert rc == 0, rc
    return out


class Automaton:
    def __init__(self):
        self._h = ctypes.c_void_p(_lib.sctag_ac_create())

    def __del__(self):
        try:
            _lib.sctag_ac_destroy(self._h)
        except Exception:
            pass

    def add_word(self, word, value):
        rc = _lib.sctag_ac_add(self._h, word.encode(), len(word), value)
        assert rc == 0, (rc, word)

    def make_automaton(self):
        _lib.sctag_ac_build(self._h)

    def iter(self, haystack):
        h = haystack.encode()
        cap = 64
        while True:
            ends = (ctypes.c_int64 * cap)()
            vals = (ctypes.c_int64 * cap)()
            total = int(_lib.sctag_ac_iter(self._h, h, len(h), ends, vals, cap))
            assert total >= 0, total
            if total <= cap:
                return [(int(ends[i]), int(vals[i])) for i in range(total)]
            cap = total
'''
