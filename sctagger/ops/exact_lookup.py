"""Exact multi-pattern k-mer lookup (replaces pyahocorasick, scTagger.py:801-826).

All reference patterns are fixed-length barcodes (16bp), so Aho-Corasick
degenerates to "is this window in the dictionary": every k-length window of a
segment packs into one uint32 (2 bits/base) and probes a sorted key array via
vectorized binary search — HBM-friendly, no automaton pointer chasing.

Dictionary semantics reproduced exactly:
  * values: forward barcode i -> i, revcomp -> -i, added in that order with
    later adds OVERWRITING (a word that is both some forward barcode and some
    revcomp keeps the revcomp value, scTagger.py:803-807);
  * a window containing any non-ACGT byte matches nothing (exact char match);
  * per segment, >1 window hit => ambiguous (handled by the caller).
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..core.packing import (
    CODE_PAD,
    STRICT_TABLE,
    encode_rows,
    encode_seqs,
    pack_kmers_from_codes,
    seq_lengths,
)
from ..utils import full_fast


def _revcomp_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Numeric reverse-complement of 2-bit-packed keys (A=0,C=1,G=2,T=3, so
    complement = 3 - code = code ^ 3): reverse the 2-bit groups with the
    O(log w) swap ladder, realign, and XOR the complement mask. Replaces
    building 3M rc *strings* + re-encoding them (~13 s at the 10x whitelist
    scale, the alt-stage prep wall)."""
    assert k <= 16, k
    y = keys.astype(np.uint32)
    m = np.uint32
    y = ((y & m(0x33333333)) << m(2)) | ((y >> m(2)) & m(0x33333333))
    y = ((y & m(0x0F0F0F0F)) << m(4)) | ((y >> m(4)) & m(0x0F0F0F0F))
    y = ((y & m(0x00FF00FF)) << m(8)) | ((y >> m(8)) & m(0x00FF00FF))
    y = (y << m(16)) | (y >> m(16))
    y >>= m(32 - 2 * k)
    return y ^ m((1 << (2 * k)) - 1)


def _encode_uniform(words: list[str], k: int) -> np.ndarray:
    """(n, k) STRICT codes via ONE join + LUT instead of a per-string Python
    loop; raises ValueError on ragged/non-1-byte input (callers fall back).

    Uniformity must be checked PER WORD: a ragged list whose lengths merely
    sum to n*k (e.g. 8+14+2 with k=8) would otherwise mis-split silently
    into wrong keys instead of reaching the host-dict fallback."""
    if any(len(w) != k for w in words):
        raise ValueError("ragged whitelist; use host fallback")
    blob = "".join(words).encode("latin-1", errors="strict")
    if len(blob) != len(words) * k:  # multi-byte chars slipped through
        raise ValueError("non-1-byte whitelist; use host fallback")
    return STRICT_TABLE[np.frombuffer(blob, np.uint8)].reshape(len(words), k)


def build_key_table(words_fwd: list[str], words_rc: list[str] | None = None):
    """Pack fwd (values +i) then rc (values -i) words; later entries win.

    Returns (sorted_keys uint32, values int64). Raises ValueError if any word
    is not pure uppercase ACGT of uniform length <= 16 (callers fall back to
    the host dict path). ``words_rc=None`` (the production stage) derives the
    rc keys numerically from the fwd keys — no rc strings are ever built.
    """
    n = len(words_fwd)
    k = len(words_fwd[0]) if n else 0
    if n == 0 or k == 0 or k > 16:
        raise ValueError("empty or overlong whitelist; use host fallback")
    if words_rc is None:
        try:
            codes = _encode_uniform(words_fwd, k)
        except UnicodeEncodeError:
            raise ValueError("non-latin-1 whitelist; use host fallback")
        if (codes > 3).any():
            raise ValueError("non-ACGT whitelist; use host fallback")
        lens = np.full(n, k, np.int64)
        fwd_keys, _ = pack_kmers_from_codes(codes, lens, k)
        keys = np.concatenate([fwd_keys[:, 0], _revcomp_keys(fwd_keys[:, 0], k)])
    else:
        all_words = words_fwd + words_rc
        codes, lens = encode_seqs(all_words, pad_to=k, table=STRICT_TABLE)
        if (lens != k).any() or (codes > 3).any():
            raise ValueError("non-ACGT or ragged whitelist; use host fallback")
        keys, _ = pack_kmers_from_codes(codes, lens, k)
        keys = keys[:, 0]
    values = np.concatenate(
        [np.arange(n, dtype=np.int64), -np.arange(n, dtype=np.int64)]
    )
    # keep-LAST duplicate semantics: reverse, then unique keeps first
    rev_keys = keys[::-1]
    rev_vals = values[::-1]
    uniq, first_idx = np.unique(rev_keys, return_index=True)
    return uniq.astype(np.uint32), rev_vals[first_idx]


@functools.partial(jax.jit)
def _probe(sorted_keys, values, qkeys, qvalid):
    pos = jnp.searchsorted(sorted_keys, qkeys)
    pos = jnp.minimum(pos, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == qkeys) & qvalid & (sorted_keys.shape[0] > 0)
    val = jnp.where(hit, values[pos], 0)
    return hit, val


BUCKET_BITS = 23  # 2^23 buckets: ~0.7 keys/bucket at the 6M-key whitelist


def build_bucket_offsets(sorted_keys: np.ndarray):
    """(off, shift, maxb) for the bucketed probe: off[b] = first table index
    whose key's top BUCKET_BITS equal b (off has 2^BITS+1 entries), maxb =
    the largest bucket's size rounded up to a multiple of 4 (the probe's
    static unroll — rounding keeps the compile-shape count small across
    whitelists). Built from one bincount pass with calloc-backed outputs —
    the searchsorted-over-8M-boundaries form cost ~11 s of malloc-backed
    first-touch on this host (page-fault cliff, CLAUDE.md; r5 review)."""
    shift = 32 - BUCKET_BITS
    nb = 1 << BUCKET_BITS
    cnt = np.bincount(
        (sorted_keys >> np.uint32(shift)).astype(np.int64), minlength=nb
    )
    off64 = np.zeros(nb + 1, np.int64)
    np.cumsum(cnt, out=off64[1:])
    off = np.zeros(nb + 1, np.int32)
    off[:] = off64  # write into calloc-backed pages (no astype malloc)
    maxb = int(cnt.max()) if sorted_keys.size else 0
    return off, shift, -(-max(maxb, 1) // 4) * 4


@functools.partial(jax.jit, static_argnames=("k", "L", "shift", "maxb"))
def _probe_rows_bucketed(sorted_keys, values, off, packed, lens, k: int,
                         L: int, shift: int, maxb: int):
    """Bucketed twin of _probe_rows_packed: ~(2 + maxb + 1) device-memory
    gathers per window instead of the 23 binary-search rounds of
    searchsorted over a 6M-key table."""
    n = packed.shape[0]
    shifts = (jnp.arange(4, dtype=jnp.uint32) * 2)[None, None, :]
    codes = (packed[:, :, None].astype(jnp.uint32) >> shifts) & 3
    codes = codes.reshape(n, -1)[:, :L]
    w = L - k + 1
    key = jnp.zeros((n, w), jnp.uint32)
    for i in range(k):
        key = (key << 2) | codes[:, i : w + i]
    valid = (jnp.arange(w, dtype=jnp.int32)[None, :] + k) <= lens[:, None]
    b = (key >> jnp.uint32(shift)).astype(jnp.int32)
    lo = off[b]
    hi = off[b + 1]
    nk = sorted_keys.shape[0]
    hit = jnp.zeros(key.shape, bool)
    hidx = jnp.zeros(key.shape, jnp.int32)
    for i in range(maxb):
        idx = jnp.minimum(lo + i, nk - 1)
        ok = (lo + i < hi) & (sorted_keys[idx] == key)
        hit = hit | ok
        hidx = jnp.where(ok, idx, hidx)
    hit = hit & valid
    val = jnp.where(hit, values[hidx], 0)
    c = hit.sum(axis=1).astype(jnp.int32)
    sv = jnp.where(c == 1, val.sum(axis=1), 0).astype(jnp.int32)
    return c, sv


@functools.partial(jax.jit, static_argnames=("k", "L"))
def _probe_rows_packed(sorted_keys, values, packed, lens, k: int, L: int):
    """Transfer-lean device probe: 2-bit-packed text up,
    per-ROW (count, single_val) down.

    An unpacked path would upload uint32 window keys and download
    per-WINDOW hit/value matrices (~6 MB per 64K-segment chunk). This
    kernel expands the windows and reduces the ambiguity rule on device
    instead: upload (rows, L/4) packed bytes + lengths, download two int32
    vectors. Rows containing non-ACGT bytes
    cannot ride the 2-bit pack (junk aliases into the alphabet) — the
    caller routes them through the exact host probe.
    """
    n = packed.shape[0]
    shifts = (jnp.arange(4, dtype=jnp.uint32) * 2)[None, None, :]
    codes = (packed[:, :, None].astype(jnp.uint32) >> shifts) & 3
    codes = codes.reshape(n, -1)[:, :L]  # (n, L)
    w = L - k + 1
    key = jnp.zeros((n, w), jnp.uint32)
    for i in range(k):  # rolling keys, char 0 in the top bits
        key = (key << 2) | codes[:, i : w + i]
    valid = (jnp.arange(w, dtype=jnp.int32)[None, :] + k) <= lens[:, None]
    pos = jnp.minimum(
        jnp.searchsorted(sorted_keys, key), sorted_keys.shape[0] - 1
    )
    hit = (sorted_keys[pos] == key) & valid
    val = jnp.where(hit, values[pos], 0)
    c = hit.sum(axis=1).astype(jnp.int32)
    sv = jnp.where(c == 1, val.sum(axis=1), 0).astype(jnp.int32)
    return c, sv


@functools.partial(jax.jit)
def _sortjoin_probe(sorted_keys, values, qkeys, qvalid):
    """Zero-random-access lookup: sort (table ‖ queries) together, sweep
    the 'last table entry' forward with an associative scan, sort back.

    Three sequential-memory passes (two multi-operand sorts + one scan)
    replace per-query gathers from a 24-64 MB device table. Opt-in
    (SCTAG_SORTJOIN=1) until a GPU A/B against binary search (ROADMAP.md).
    """
    nt = sorted_keys.shape[0]
    qshape = qkeys.shape
    q = qkeys.reshape(-1)
    nq = q.shape[0]
    k_all = jnp.concatenate([sorted_keys, q])
    # tag 0 = table, 1 = query: equal keys sort table-first (num_keys=2)
    tag = jnp.concatenate(
        [jnp.zeros(nt, jnp.int32), jnp.ones(nq, jnp.int32)]
    )
    val_all = jnp.concatenate([values, jnp.zeros(nq, jnp.int32)])
    idx = jnp.arange(nt + nq, dtype=jnp.int32)
    sk, st, sv, si = jax.lax.sort((k_all, tag, val_all, idx), num_keys=2)

    # forward-propagate the last table (key, value): f(a, b) = b if b is a
    # table entry else a — associative, so lax.associative_scan applies
    is_t = st == 0
    def _carry(a, b):
        ak, av, avalid = a
        bk, bv, bvalid = b
        pick_b = bvalid
        return (
            jnp.where(pick_b, bk, ak),
            jnp.where(pick_b, bv, av),
            avalid | bvalid,
        )

    lastk, lastv, seen_t = jax.lax.associative_scan(
        _carry, (sk, sv, is_t)
    )
    # seen_t gates queries that precede every table entry (their lastk is
    # their own key — a spurious self-match without the gate)
    hit_s = ~is_t & seen_t & (lastk == sk)
    val_s = jnp.where(hit_s, lastv, 0)

    # restore original order: one more sort by provenance index
    _, hit_o, val_o = jax.lax.sort(
        (si, hit_s.astype(jnp.int32), val_s), num_keys=1
    )
    hit = (hit_o[nt:].reshape(qshape) == 1) & qvalid
    return hit, jnp.where(hit, val_o[nt:].reshape(qshape), 0)


_DEV_TABLE_CACHE: dict = {}  # content digest -> (sk_dev, vv_dev)


def _device_table(sorted_keys: np.ndarray, values: np.ndarray):
    """Device-resident (keys, values) arrays, cached by CONTENT digest.

    A 3M-barcode whitelist is ~48 MB of table; the cache uploads it once
    per process instead of on every probe_segments call. The md5 over the
    raw bytes makes the cache safe under mutation/rebuild; one entry is
    kept (the production stages use a single whitelist per run)."""
    import hashlib

    h = hashlib.md5()
    h.update(np.ascontiguousarray(sorted_keys).view(np.uint8).tobytes())
    h.update(np.ascontiguousarray(values).view(np.uint8).tobytes())
    key = h.hexdigest()
    hit = _DEV_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    _DEV_TABLE_CACHE.clear()
    sk = jnp.asarray(sorted_keys.view(np.uint32))
    vv = jnp.asarray(values.astype(np.int32))
    if os.environ.get("SCTAG_BUCKET_PROBE") == "1":
        # opt-in only: a GPU A/B against the searchsorted probe is still
        # to be made (ROADMAP.md)
        off, shift, maxb = build_bucket_offsets(sorted_keys.view(np.uint32))
        entry = (sk, vv, jnp.asarray(off), shift, maxb)
    else:
        entry = (sk, vv, None, 0, 0)
    _DEV_TABLE_CACHE[key] = entry
    return entry


HASH_EMPTY = np.int32(np.iinfo(np.int32).min)


def build_hash_table(sorted_keys: np.ndarray, values: np.ndarray):
    """Open-addressing table (keys uint32, vals int32) at load <= 0.5.

    Built by the native C insert loop (collision chains are serial); slot
    emptiness lives in the value array (HASH_EMPTY) because every uint32 is
    a valid packed k-mer. Returns (tkeys, tvals); raises if the native
    library is unavailable (callers fall back to the sorted-array probe).
    """
    from ..native import build as native_build

    n = int(sorted_keys.size)
    size = 1
    while size < max(2 * n, 2):
        size *= 2
    tkeys = np.zeros(size, np.uint32)
    tvals = full_fast(size, HASH_EMPTY, np.int32)
    if n:
        keys = np.ascontiguousarray(sorted_keys, dtype=np.uint32)
        vals = np.ascontiguousarray(values, dtype=np.int32)
        lib = native_build.load()
        lib.sctag_hash_build(
            keys.ctypes.data, vals.ctypes.data, n, size,
            tkeys.ctypes.data, tvals.ctypes.data,
        )
    return tkeys, tvals


@functools.partial(jax.jit)
def _hash_probe(tkeys, tvals, qkeys, qvalid):
    """Linear-probing lookup: expected ~1-2 gathers/query at load <= 0.5
    (vs a 23-step binary search for a 6M-key whitelist). The while_loop trip
    count is data-dependent but the shape is fixed — no recompiles."""
    size = tkeys.shape[0]
    mask = jnp.uint32(size - 1)
    shift = 32 - int(size).bit_length() + 1  # size = 1 << (bit_length - 1)
    h0 = (qkeys * jnp.uint32(2654435761)) >> jnp.uint32(shift)

    def cond(state):
        _, done, _, _ = state
        return ~jnp.all(done)

    def body(state):
        h, done, hit, val = state
        k = tkeys[h & mask]
        v = tvals[h & mask]
        empty = v == HASH_EMPTY
        match = (k == qkeys) & ~empty
        hit = jnp.where(~done & match, True, hit)
        val = jnp.where(~done & match, v, val)
        done = done | empty | match
        return h + jnp.uint32(1), done, hit, val

    done0 = ~qvalid  # invalid windows never probe
    hit0 = jnp.zeros_like(qvalid)
    val0 = jnp.zeros(qkeys.shape, jnp.int32)
    _, _, hit, val = jax.lax.while_loop(cond, body, (h0, done0, hit0, val0))
    return hit, val


def probe_segments(
    segments: list[str],
    sorted_keys: np.ndarray,
    values: np.ndarray,
    k: int,
    chunk: int = 65536,
):
    """For each segment: (n_hits, value-of-single-hit-or-0, first window pos).

    Hits are counted over every k-window (end positions ascending, matching
    A.iter order). Returns (counts (N,), single_val (N,)) where single_val is
    meaningful only when counts == 1.

    Backend: HOST by default (native C++ hash probe, see exact_probe.cpp —
    exact lookup is a memory-latency workload). SCTAG_PROBE=device forces
    the device binary-search path; the host path also degrades to it if the
    native lib is unavailable. Which is faster on a GPU host is not
    measured yet (ROADMAP.md).
    """
    n = len(segments)
    if os.environ.get("SCTAG_PROBE", "host") == "host":
        try:
            return _probe_rows_host(segments, sorted_keys, values, k)
        except Exception as e:
            print(
                f"host probe unavailable ({type(e).__name__}: {e}); "
                "using the device probe",
                file=sys.stderr,
            )
    # <1 (incl. "0", the repo-wide 'off' convention) keeps the default
    # rather than becoming a zero range step
    env_chunk = int(os.environ.get("SCTAG_PROBE_CHUNK", "0") or 0)
    if env_chunk >= 1:
        chunk = env_chunk
    counts = np.zeros(n, dtype=np.int64)
    single_val = np.zeros(n, dtype=np.int64)
    sk, vv, off_d, shift, maxb = _device_table(sorted_keys, values)
    # binary search is the default probe; the sort-join variant (zero
    # random access) is opt-in with SCTAG_SORTJOIN=1 until a GPU A/B
    # decides between them (ROADMAP.md).
    state = {"use_sortjoin": os.environ.get("SCTAG_SORTJOIN") == "1"}
    # multi-device processes shard query rows over the local ('data',) mesh
    # (table replicated) — the alt-stage analog of the match/scan drivers'
    # production mesh path
    from ..parallel.mesh import local_mesh, shard_probe

    mesh = local_mesh(model_parallel=1)
    if mesh is None and not state["use_sortjoin"]:
        # single-device default: the transfer-lean packed probe (per-row
        # reduction on device). The bucketed variant is OPT-IN
        # (SCTAG_BUCKET_PROBE=1)
        bucket = off_d is not None and maxb <= 32
        return _probe_segments_packed(
            segments, sk, vv, sorted_keys, values, k, chunk,
            bucketed=(off_d, shift, maxb) if bucket else None,
        )

    def probe(qk, qv):
        if state["use_sortjoin"]:
            try:
                return _sortjoin_probe(sk, vv, qk, qv)
            except Exception as e:  # compiler OOM/unsupported: degrade
                print(
                    f"sort-join probe unavailable ({type(e).__name__}); "
                    "falling back to binary search",
                    file=sys.stderr,
                )
                state["use_sortjoin"] = False
        if mesh is not None:
            nd = mesh.shape["data"]
            rows = qk.shape[0]
            rp = -(-rows // nd) * nd
            if rp != rows:  # pad rows with invalid windows (hit=False)
                qk = jnp.pad(qk, ((0, rp - rows), (0, 0)))
                qv = jnp.pad(qv, ((0, rp - rows), (0, 0)))
            return shard_probe(mesh, sk, vv, qk, qv)
        return _probe(sk, vv, qk, qv)
    # one padded length for every chunk: a single compiled probe shape.
    # Dispatch is ASYNC: the host encodes/packs chunk i+1 while the device
    # probes chunk i (bounded in-flight queue, like the match/scan drivers).
    L = max(int(seq_lengths(segments).max(initial=0)) if n else k, k)
    MAX_INFLIGHT = 8
    pending: list[tuple[int, int, object, object]] = []  # (s, real, hit, val)

    def _drain(limit: int) -> None:
        while len(pending) > limit:
            s, real, hit_d, val_d = pending.pop(0)
            hit = np.asarray(hit_d)
            val = np.asarray(val_d, dtype=np.int64)
            c = hit.sum(axis=1)[:real]
            counts[s : s + real] = c
            # single-hit value: sum over the row works when exactly 1 hit
            single_val[s : s + real] = np.where(
                c == 1, (val * hit).sum(axis=1)[:real], 0
            )

    for s in range(0, n, chunk):
        idx = np.arange(s, min(s + chunk, n), dtype=np.int64)
        codes, lens = encode_rows(segments, idx, pad_to=L, table=STRICT_TABLE)
        pad = chunk - idx.size
        if pad and s > 0:  # pad final chunk to the single compiled shape
            codes = np.concatenate(
                [codes, full_fast((pad, L), CODE_PAD, codes.dtype)]
            )
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        qkeys, qvalid = pack_kmers_from_codes(codes, lens, k)
        if qkeys.size == 0:
            continue
        hit_d, val_d = probe(
            jnp.asarray(qkeys.view(np.uint32)), jnp.asarray(qvalid)
        )
        pending.append((s, min(chunk, n - s), hit_d, val_d))
        _drain(MAX_INFLIGHT)
    _drain(0)
    return counts, single_val


def _probe_segments_packed(segments, sk, vv, sorted_keys, values, k, chunk,
                           bucketed=None):
    """Packed-upload device probe driver (single-device path).

    Per chunk: one native encode+2-bit-pack pass, async dispatch of
    _probe_rows_packed (ONE compiled shape), per-row results drained into
    the output vectors. Rows with in-sequence non-ACGT bytes cannot ride
    the pack (junk aliases into the alphabet) — their device lengths zero
    out (no valid windows) and they re-probe through the exact host hash
    probe afterwards (or the unpacked device probe if the native lib is
    missing)."""
    n = len(segments)
    counts = np.zeros(n, dtype=np.int64)
    single_val = np.zeros(n, dtype=np.int64)
    lengths = seq_lengths(segments) if n else np.zeros(0, np.int64)
    L = int(max(int(lengths.max(initial=0)), k))
    L = -(-L // 4) * 4  # packed bytes need L % 4 == 0
    junk_rows: list[np.ndarray] = []
    MAX_INFLIGHT = 8
    pending: list[tuple[int, int, object, object]] = []

    def _drain(limit: int) -> None:
        while len(pending) > limit:
            s, real, c_d, v_d = pending.pop(0)
            counts[s : s + real] = np.asarray(c_d)[:real]
            single_val[s : s + real] = np.asarray(v_d)[:real]

    enc_packed = getattr(segments, "encode_packed", None)
    for s in range(0, n, chunk):
        idx = np.arange(s, min(s + chunk, n), dtype=np.int64)
        if enc_packed is not None:
            pk, lens, junk = enc_packed(idx, pad_to=L, table=STRICT_TABLE)
        else:
            codes, lens = encode_rows(
                segments, idx, pad_to=L, table=STRICT_TABLE
            )
            in_len = np.arange(L)[None, :] < lens[:, None]
            junk = ((codes > 3) & in_len).any(axis=1)
            c4 = (codes & 3).astype(np.uint8).reshape(idx.size, L // 4, 4)
            pk = (
                c4[:, :, 0]
                | (c4[:, :, 1] << 2)
                | (c4[:, :, 2] << 4)
                | (c4[:, :, 3] << 6)
            )
        lens = lens.astype(np.int32)
        if junk.any():
            junk_rows.append(idx[junk])
            lens = np.where(junk, 0, lens).astype(np.int32)
        pad = chunk - idx.size
        if pad and s > 0:  # pad final chunk to the single compiled shape
            pk = np.concatenate([pk, np.zeros((pad, L // 4), np.uint8)])
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        if bucketed is not None:
            off_d, shift, maxb = bucketed
            c_d, v_d = _probe_rows_bucketed(
                sk, vv, off_d, jnp.asarray(pk), jnp.asarray(lens), k, L,
                shift, maxb,
            )
        else:
            c_d, v_d = _probe_rows_packed(
                sk, vv, jnp.asarray(pk), jnp.asarray(lens), k, L
            )
        pending.append((s, idx.size, c_d, v_d))
        _drain(MAX_INFLIGHT)
    _drain(0)

    if junk_rows:
        jr = np.concatenate(junk_rows)
        sub = [segments[int(i)] for i in jr]
        try:
            jc, jv = _probe_rows_host(sub, sorted_keys, values, k)
        except Exception:
            # exact unpacked device probe for the rare junk rows (qvalid
            # from pack_kmers_from_codes masks junk-containing windows)
            Lj = int(max(max(len(x) for x in sub), k))
            codes, lens = encode_seqs(sub, pad_to=Lj, table=STRICT_TABLE)
            qkeys, qvalid = pack_kmers_from_codes(codes, lens, k)
            hit, val = _probe(
                sk, vv, jnp.asarray(qkeys.view(np.uint32)),
                jnp.asarray(qvalid),
            )
            hit = np.asarray(hit)
            val = np.asarray(val, dtype=np.int64)
            jc = hit.sum(axis=1)
            jv = np.where(jc == 1, (val * hit).sum(axis=1), 0)
        counts[jr] = jc
        single_val[jr] = jv
    return counts, single_val


def _probe_rows_host(segments, sorted_keys: np.ndarray, values: np.ndarray,
                     k: int):
    """Native threaded hash probe over raw segment bytes (exact_probe.cpp)."""
    from ..native import build as native_build

    lib = native_build.load()
    n = len(segments)
    if values.size and int(np.abs(values).max()) >= 2**31:
        raise ValueError("values exceed int32 (hash table layout)")
    # open-addressing table, load factor <= 0.5 (hash_table.cpp layout)
    size = 1
    while size < 2 * max(len(sorted_keys), 1):
        size *= 2
    tkeys = np.zeros(size, np.uint32)
    tvals = np.zeros(size, np.int32)
    tvals.fill(np.iinfo(np.int32).min)
    keys_c = np.ascontiguousarray(sorted_keys.view(np.uint32))
    vals_c = np.ascontiguousarray(values.astype(np.int32))
    lib.sctag_hash_build(
        keys_c.ctypes.data, vals_c.ctypes.data, len(sorted_keys), size,
        tkeys.ctypes.data, tvals.ctypes.data,
    )
    # raw bytes + offsets: zero-copy from a SeqBuffer, one join otherwise
    buf = getattr(segments, "buf", None)
    if buf is not None:
        offs = segments.offs
    else:
        lens = np.fromiter(
            (len(s) for s in segments), np.int64, count=n
        ) if n else np.zeros(0, np.int64)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        joined = "".join(segments).encode("latin-1")
        buf = np.frombuffer(joined, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    counts = np.zeros(n, np.int64)
    single = np.zeros(n, np.int64)
    nthreads = int(os.environ.get("SCTAG_PROBE_THREADS", "2") or 2)
    lib.sctag_probe_rows(
        buf.ctypes.data, offs.ctypes.data, n,
        tkeys.ctypes.data, tvals.ctypes.data, size, k, nthreads,
        counts.ctypes.data, single.ctypes.data,
    )
    return counts, single


def host_dict_fallback(segments, words_fwd, words_rc):
    """Generic Aho-Corasick-equivalent for non-uniform/non-ACGT whitelists.

    Same per-segment (count, single value) contract as probe_segments, but
    supports arbitrary equal-or-mixed-length patterns via per-length window
    dict probes. Slow host path; only exercised on exotic inputs.
    """
    table: dict[str, int] = {}
    for i, w in enumerate(words_fwd):
        table[w] = i
    for i, w in enumerate(words_rc):
        table[w] = -i
    lens = sorted({len(w) for w in table})
    n = len(segments)
    counts = np.zeros(n, dtype=np.int64)
    single_val = np.zeros(n, dtype=np.int64)
    for r, seg in enumerate(segments):
        hits = []
        for e in range(len(seg)):
            for k in lens:
                if e + 1 >= k:
                    w = seg[e - k + 1 : e + 1]
                    if w in table:
                        hits.append(table[w])
        counts[r] = len(hits)
        if len(hits) == 1:
            single_val[r] = hits[0]
    return counts, single_val
