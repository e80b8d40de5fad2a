"""Stage-1 adapter localization model (device compute + host assembly).

Replaces edlib's HW alignment of the SR adapter and its reverse complement
against every long read (reference get_alns, scTagger.py:176-196) with a
batched Myers bit-vector scan on the device. Per read it reproduces edlib's
observable surface exactly:

  forward strand : d1 and ALL optimal end positions (edlib `locations` x[1]);
  reverse strand : d2 and, per optimal end, the MINIMAL optimal start
                   (edlib computes starts by a reverse SHW pass and keeps its
                   furthest position — edlib.cpp obtainAlignmentTraceback;
                   reported as x[0]-len(seq)-1, scTagger.py:189);
  tie d1 == d2   : read invalid (strand 'NA', d=-1, scTagger.py:182-183).

Reads are bucketed by length to bound padding waste; the per-end start
recovery runs as a second batched SHW scan over fixed 2m-wide reversed
windows (k <= m+d-1 positions can be optimal, so the window is lossless).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.packing import (
    STRICT_TABLE,
    encode_rows,
    encode_seqs,
    encode_str,
    rev_compl,
    seq_lengths,
)
from ..ops.myers import (
    MAX_PATTERN_LEN,
    _scores_scan,
    _scores_scan_mw,
    build_peq_multi,
    build_peq_multi_mw,
    build_peq_single,
    build_peq_single_mw,
)
from ..utils import batch_iter, full_fast, pow2_rows, prof_timer, round_up

# Quantile-based read-length buckets: each distinct scan shape is one more
# compile, so we pick at most four data-fitted buckets instead of a fixed
# ladder. Chunk sizes follow a fixed character budget per device call (64M
# chars = 16 MB packed); several chunks stay in flight so upload, scan and
# fetch overlap. SCTAG_CHUNK_CHARS trades in-flight depth for fewer, larger
# transfers.
import os as _os

_CHARS_BUDGET = int(
    _os.environ.get("SCTAG_CHUNK_CHARS", 64 * 1024 * 1024)
)  # unpacked text chars per chunk


def _read_buckets(lengths: np.ndarray) -> list[int]:
    """Quantile-candidate buckets, greedily pruned by padded-volume savings.

    Padding is wasted upload and scan work, but each extra bucket costs a
    compiled shape: a candidate splits off only if keeping it shrinks the
    TOTAL padded volume by >= 8%. Candidates snap to the scan's padded
    lengths (pad_len) so equal-shape candidates collapse; result capped at 4
    shapes."""
    from ..ops.adapter_scan import pad_len

    nz = np.sort(lengths[lengths > 0])
    if nz.size == 0:
        return [64]
    cands = sorted(
        {pad_len(max(64, int(q))) for q in np.quantile(nz, [0.5, 0.75, 0.9, 1.0])}
    )

    def volume(bs: list[int]) -> int:
        v, lo = 0, 0
        for b in bs:
            hi = int(np.searchsorted(nz, b, side="right"))
            v += (hi - lo) * b
            lo = hi
        return v

    keep = list(cands)
    changed = True
    while changed and len(keep) > 1:
        changed = False
        for i in range(len(keep) - 1):  # the max bucket always stays
            trial = keep[:i] + keep[i + 1 :]
            if volume(trial) <= 1.08 * volume(keep):
                keep = trial
                changed = True
                break
    return keep[-4:] if len(keep) > 4 else keep


def _chunk_for(L: int) -> int:
    from ..ops.adapter_scan import READ_TILE

    return max(READ_TILE, (_CHARS_BUDGET // max(L, 1)) // READ_TILE * READ_TILE)


@dataclasses.dataclass
class AdapterScanResult:
    """Per-read alignment info in reference get_alns terms."""

    strands: np.ndarray  # (N,) int8: 0='+', 1='-', -1='NA' (tie)
    dists: np.ndarray  # (N,) int32: chosen-strand distance, -1 for NA
    flat_locs: np.ndarray  # (M,) int64 locs concatenated read-major
    loc_counts: np.ndarray  # (N,) int64


@functools.partial(jax.jit, static_argnames=("m",))
def _hw_block(text_T, peq2, lengths, m: int):
    """(L, B) codes + (5, 2) Peq -> per-read dists (B, 2) and argmin masks
    (L, B, 2) over valid positions only."""
    scan = _scores_scan if peq2.ndim == 2 else _scores_scan_mw
    scores = scan(text_T, peq2, m, shw=False)  # (L, B, 2)
    L = text_T.shape[0]
    pos_valid = (
        jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0) < lengths[None, :]
    )[:, :, None]
    big = jnp.int32(1 << 20)
    masked = jnp.where(pos_valid, scores, big)
    d = jnp.minimum(masked.min(axis=0), m)  # (B, 2); empty reads clamp to m
    mask = masked == d[None, :, :]
    return d, mask


@functools.partial(jax.jit, static_argnames=("m",))
def _shw_last_block(win_T, peq_rev, wlens, targets, m: int):
    """Reverse-SHW start recovery: win_T (W, T) reversed window codes.

    Returns k_last (T,): the furthest window position whose SHW score equals
    the task's target distance (edlib's positionsSHW[last])."""
    scan = _scores_scan if peq_rev.ndim == 1 else _scores_scan_mw
    scores = scan(win_T, peq_rev, m, shw=True)  # (W, T)
    W = win_T.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (W, 1), 0)
    hit = (scores == targets[None, :]) & (pos < wlens[None, :])
    return jnp.max(jnp.where(hit, pos, -1), axis=0)


def scan_adapters(
    seqs: Sequence[str],
    adapter: str,
    threads: int = 1,
    progress: bool = False,
) -> AdapterScanResult:
    """Full stage-1 device scan over all reads."""
    m = len(adapter)
    a2 = rev_compl(adapter)
    pat_stack = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(a2, STRICT_TABLE),
    ])
    mw = m > MAX_PATTERN_LEN  # multi-word scans for long adapters
    with prof_timer("scan.backend_init"):
        peq2 = jnp.asarray(
            build_peq_multi_mw(pat_stack) if mw else build_peq_multi(pat_stack)
        )
    n = len(seqs)
    lengths = seq_lengths(seqs)
    buckets = _read_buckets(lengths)

    strands = full_fast(n, -1, np.int8)
    dists = full_fast(n, -1, np.int32)
    # flat (rid, loc) accumulation: per-read numpy arrays cost ~0.45s of
    # np.split/view churn at 50K reads — one stable argsort at the end
    # recovers read-major order instead
    loc_rids: list[np.ndarray] = []
    loc_vals: list[np.ndarray] = []

    order = np.argsort(lengths, kind="stable")
    rev_tasks_rid: list[np.ndarray] = []  # read ids per pending rev task
    rev_tasks_end: list[np.ndarray] = []

    # the packed device scan (ops/adapter_scan.py) on every backend; the
    # mask path only for multi-word adapters (and the overflow/junk
    # fallback in _finalize_scan)
    device_scan = not mw
    with prof_timer("scan.peq_roundtrip"):
        peq2_np = np.asarray(peq2)
    overflow_rids: list[int] = []  # cnt > SLOTS_K: need the full mask path

    # In-process multi-device: lay chunks out over the local ('data',) mesh
    # (parallel/mesh.py) — N chips scan N-wide with zero code changes. The
    # chunk scales by the mesh width so each device keeps the tuned
    # per-device character budget.
    from ..parallel.mesh import local_mesh

    with prof_timer("scan.mesh_init"):
        mesh = local_mesh(model_parallel=1) if not mw else None
    n_mesh = int(mesh.shape["data"]) if mesh is not None else 1

    MAX_INFLIGHT = 64  # bound device memory held by queued chunks
    pending: list[tuple] = []  # (dev_out, sub, B)

    def _drain(limit: int) -> None:
        while len(pending) > limit:
            dev, psub, B, junk = pending.pop(0)
            with prof_timer("scan.sync"):
                out_np = np.asarray(dev)
            with prof_timer("scan.collect"):
                _scan_collect(
                    out_np, B, psub,
                    strands, dists, loc_rids, loc_vals,
                    rev_tasks_rid, rev_tasks_end, overflow_rids,
                    junk=junk,
                )

    lo = 0
    for L in buckets:
        hi = int(np.searchsorted(lengths[order], L, side="right"))
        idx = order[lo:hi]
        lo = hi
        if idx.size == 0:
            continue
        chunk = _chunk_for(L) if device_scan else max(256, _chunk_for(L) // 8)
        chunk *= n_mesh
        if progress:
            print(f"[scan] bucket<= {L}: {idx.size} reads", file=sys.stderr)
        enc_packed = getattr(seqs, "encode_packed", None) if device_scan else None
        for s, e in batch_iter(idx.size, chunk):
            sub = idx[s:e]
            if device_scan:
                # async dispatch: device crunches while the host encodes the
                # next chunk. ONE batch shape per bucket (sliver chunks pad
                # to the full chunk: a little wasted scan time beats a
                # compile per sliver). In-sequence junk chars (strict code
                # >= 4 before the read end) violate the 2-bit-packed
                # scan's contract — those reads route to the exact mask
                # fallback below.
                from ..ops.adapter_scan import (
                    adapter_scan_dispatch,
                    adapter_scan_dispatch_packed,
                    pad_len,
                )

                if enc_packed is not None:
                    # one native pass: encode + pack + junk flags (SeqBuffer)
                    with prof_timer("scan.encode"):
                        pk, sub_lens, junk = enc_packed(
                            sub, pad_to=pad_len(L), table=STRICT_TABLE
                        )
                    with prof_timer("scan.dispatch"):
                        dev = adapter_scan_dispatch_packed(
                            pk, sub_lens, peq2_np, m, pad_len(L),
                            b_pad=chunk, mesh=mesh,
                        )
                else:
                    with prof_timer("scan.encode"):
                        codes, _ = encode_rows(seqs, sub, pad_to=L)
                    with prof_timer("scan.junk_mask"):
                        junk = (
                            (codes == 4)
                            & (
                                np.arange(codes.shape[1])[None, :]
                                < lengths[sub][:, None]
                            )
                        ).any(axis=1)
                    with prof_timer("scan.dispatch"):
                        dev = adapter_scan_dispatch(
                            codes, lengths[sub], peq2_np, m,
                            b_pad=chunk, mesh=mesh,
                        )
                pending.append((dev, sub, sub.size, junk))
                _drain(MAX_INFLIGHT)
            else:
                with prof_timer("scan.encode"):
                    codes, _ = encode_rows(seqs, sub, pad_to=L)
                _mask_chunk(
                    codes, lengths[sub], peq2, m, sub,
                    strands, dists, loc_rids, loc_vals,
                    rev_tasks_rid, rev_tasks_end, mesh=mesh,
                )
    _drain(0)

    return _finalize_scan(
        seqs, lengths, peq2_np, m, a2, n,
        strands, dists, loc_rids, loc_vals,
        rev_tasks_rid, rev_tasks_end, overflow_rids, mesh, progress,
    )


def _finalize_scan(
    seqs, lengths, peq2_np, m, a2, n,
    strands, dists, loc_rids, loc_vals,
    rev_tasks_rid, rev_tasks_end, overflow_rids, mesh, progress,
) -> AdapterScanResult:
    """Shared scan tail (one-shot AND streaming paths): exact mask fallback
    for overflow/junk reads, reverse-SHW start recovery, and flat (rid, loc)
    assembly. This is the trickiest parity-bearing logic — keep it in ONE
    place."""
    if overflow_rids:
        # rare multi-site reads: recompute with full masks (jnp path)
        if progress:
            print(
                f"[scan] mask fallback for {len(overflow_rids)} reads",
                file=sys.stderr,
            )
        from ..ops.adapter_scan import pad_len

        ov = np.array(sorted(set(overflow_rids)), dtype=np.int64)
        for s, e in batch_iter(ov.size, 256):
            sub = ov[s:e]
            L = pad_len(max(int(lengths[sub].max()), 1))
            codes, _ = encode_rows(seqs, sub, pad_to=L)
            _mask_chunk(
                codes, lengths[sub], peq2_np, m, sub,
                strands, dists, loc_rids, loc_vals,
                rev_tasks_rid, rev_tasks_end, mesh=mesh,
            )

    with prof_timer("scan.rev_recovery"):
        _recover_rev_starts(
            seqs, lengths, a2, m, rev_tasks_rid, rev_tasks_end, dists,
            loc_rids, loc_vals,
        )

    if loc_rids:
        rid_all = np.concatenate(loc_rids)
        val_all = np.concatenate(loc_vals)
        # stable: preserves each path's ascending within-read loc order
        order = np.argsort(rid_all, kind="stable")
        flat = np.ascontiguousarray(val_all[order])
        loc_counts = np.bincount(rid_all, minlength=n).astype(np.int64)
    else:
        flat = np.empty(0, dtype=np.int64)
        loc_counts = np.zeros(n, dtype=np.int64)
    return AdapterScanResult(strands, dists, flat, loc_counts)


def scan_adapters_stream(
    batches,
    adapter: str,
    progress: bool = False,
):
    """Streaming stage-1 scan: overlap FASTQ ingest with device compute.

    ``batches`` yields ``(names, SeqBuffer)`` in global read order (normally
    ``io.fastq.read_fastqs_stream`` driven from a producer thread, so the
    C-level parse/inflate of batch i+1 runs while this consumer encodes and
    dispatches batch i). Returns ``(rnames, chain, AdapterScanResult)`` where
    ``chain`` is the ChainSeqBuffer holding every batch (the stage writer
    needs the read text for segments).

    Shape discipline: length buckets are fitted on the FIRST
    batch and only extended — up to 6 compiled shapes — when a later batch
    brings strictly longer reads; beyond that, over-long reads take the exact
    mask fallback. Partial bucket chunks carry over between batches so the
    per-bucket batch shape stays ONE compiled (b_pad) shape.

    Multi-word adapters (> 32 bp, mask path) accumulate the chain and
    delegate to :func:`scan_adapters` — identical results, no ingest
    overlap.
    """
    from ..io.fastq import ChainSeqBuffer

    m = len(adapter)
    mw = m > MAX_PATTERN_LEN

    rnames: list[str] = []
    chain = ChainSeqBuffer()
    if mw:
        for item in batches:
            names, sb = item[0], item[1]  # optional 3rd: producer d0 raw
            rnames.extend(names)
            chain.append(sb)
        return rnames, chain, scan_adapters(chain, adapter, progress=progress)

    from ..ops.adapter_scan import adapter_scan_dispatch_packed, pad_len
    from ..parallel.mesh import local_mesh

    a2 = rev_compl(adapter)
    pat_stack = np.stack(
        [encode_str(adapter, STRICT_TABLE), encode_str(a2, STRICT_TABLE)]
    )
    peq2_np = np.asarray(build_peq_multi(pat_stack))
    with prof_timer("scan.mesh_init"):
        mesh = local_mesh(model_parallel=1)
    n_mesh = int(mesh.shape["data"]) if mesh is not None else 1

    # host exact-adapter prefilter (native/adapter_d0.cpp):
    # a read with an exact adapter occurrence on exactly ONE strand is fully
    # decided host-side (d=0 beats the other strand's d>=1; locs = exact
    # ends fwd / starts-L-1 rev with start = end-m+1 at dist 0); exact hits
    # on BOTH strands are the d1==d2 tie => NA. Either way the read skips
    # the 2-bit pack, the upload and the device scan. On high-accuracy
    # reads that is the majority of reads (0.99^22 ~ 80% at Q20).
    # SCTAG_ADAPTER_D0=0 disables.
    d0_scan = None
    if m <= 32 and _os.environ.get("SCTAG_ADAPTER_D0", "1") == "1":
        d0_scan = _make_d0_scanner(pat_stack, m)

    MAX_BUCKETS = 6  # hard cap on compiled shapes
    buckets: list[int] = []
    pend_idx: dict[int, list[np.ndarray]] = {}  # bucket L -> carried row ids
    pend_n: dict[int, int] = {}

    strands = full_fast(1024, -1, np.int8)
    dists = full_fast(1024, -1, np.int32)
    loc_rids: list[np.ndarray] = []
    loc_vals: list[np.ndarray] = []
    rev_tasks_rid: list[np.ndarray] = []
    rev_tasks_end: list[np.ndarray] = []
    overflow_rids: list[int] = []
    pending: list[tuple] = []
    MAX_INFLIGHT = 64

    def _drain(limit: int) -> None:
        while len(pending) > limit:
            dev, psub, B, junk = pending.pop(0)
            with prof_timer("scan.sync"):
                out_np = np.asarray(dev)
            with prof_timer("scan.collect"):
                _scan_collect(
                    out_np, B, psub,
                    strands, dists, loc_rids, loc_vals,
                    rev_tasks_rid, rev_tasks_end, overflow_rids,
                    junk=junk,
                )

    # three-stage pipeline: parse (producer thread) | encode (this worker,
    # native table-encode releases the GIL) | dispatch+collect (consumer) —
    # the device upload no longer serializes the encode
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    enc_pool = ThreadPoolExecutor(1)
    enc_q: deque = deque()
    ENC_DEPTH = 4  # bounds packed chunks held (~16 MB each at 64M chars)

    def _encode_job(L: int, sub: np.ndarray):
        with prof_timer("scan.encode"):
            return chain.encode_packed(sub, pad_to=pad_len(L), table=STRICT_TABLE)

    def _pump(block: bool) -> None:
        while enc_q and (block or enc_q[0][0].done()
                         or len(enc_q) >= ENC_DEPTH):
            fut, L, sub = enc_q.popleft()
            pk, sub_lens, junk = fut.result()
            chunk = _chunk_for(L) * n_mesh
            with prof_timer("scan.dispatch"):
                dev = adapter_scan_dispatch_packed(
                    pk, sub_lens, peq2_np, m, pad_len(L),
                    b_pad=chunk, mesh=mesh,
                )
            pending.append((dev, sub, sub.size, junk))
            _drain(MAX_INFLIGHT)

    def _dispatch(L: int, sub: np.ndarray) -> None:
        enc_q.append((enc_pool.submit(_encode_job, L, sub), L, sub))
        _pump(block=False)

    try:
        for item in batches:
            # 3rd element (optional): d0 raw scan computed on the parse
            # producer thread (stage driver) — bytes were hot there and the
            # probe stops competing with encode/dispatch for the consumer
            names, sb = item[0], item[1]
            d0_raw = item[2] if len(item) > 2 else None
            if hasattr(d0_raw, "result"):
                d0_raw = d0_raw.result()  # probe future (producer pipeline)
            rnames.extend(names)
            off = len(chain)
            chain.append(sb)
            if len(sb) == 0:
                continue
            n = len(chain)
            if strands.size < n:  # grow accumulators; _drain sees the rebinding
                cap = max(n, 2 * strands.size)
                ns = full_fast(cap, -1, np.int8)
                ns[: strands.size] = strands
                strands = ns
                nd = full_fast(cap, -1, np.int32)
                nd[: dists.size] = dists
                dists = nd
            lens_b = np.asarray(sb.lengths)
            keep_b = None
            if d0_scan is not None:
                with prof_timer("scan.d0probe"):
                    keep_b = d0_scan.apply(
                        sb,
                        d0_raw if d0_raw is not None else d0_scan.raw(sb),
                        off, strands, dists, loc_rids, loc_vals,
                    )
                if keep_b is not None and progress:
                    nres = int(len(sb) - keep_b.sum())
                    if nres:
                        print(
                            f"[scan] host d0 prefilter: {nres}/{len(sb)} "
                            "reads resolved", file=sys.stderr,
                        )
            if not buckets:
                buckets = list(_read_buckets(lens_b))
            if int(lens_b.max()) > buckets[-1] and len(buckets) < MAX_BUCKETS:
                newL = pad_len(int(lens_b.max()))
                if newL > buckets[-1]:
                    buckets.append(newL)
                    if progress:
                        print(f"[scan] new length bucket {newL}", file=sys.stderr)
            barr = np.asarray(buckets, np.int64)
            bi_of = np.searchsorted(barr, lens_b, side="left")
            if keep_b is not None:
                bi_of = np.where(keep_b, bi_of, -1)  # resolved: no bucket
            too_long = np.flatnonzero(bi_of >= len(buckets))
            if too_long.size:  # beyond every bucket: exact mask fallback
                overflow_rids.extend((off + too_long).tolist())
            for k, L in enumerate(buckets):
                sel = np.flatnonzero(bi_of == k)
                if sel.size == 0:
                    continue
                if progress:
                    print(
                        f"[scan] bucket<= {L}: {sel.size} reads", file=sys.stderr
                    )
                pend_idx.setdefault(L, []).append(off + sel.astype(np.int64))
                pend_n[L] = pend_n.get(L, 0) + sel.size
                chunk = _chunk_for(L) * n_mesh
                while pend_n[L] >= chunk:
                    allidx = np.concatenate(pend_idx[L])
                    _dispatch(L, allidx[:chunk])
                    rest = allidx[chunk:]
                    pend_idx[L] = [rest] if rest.size else []
                    pend_n[L] = int(rest.size)

        for L in sorted(pend_idx):  # flush carried slivers (same b_pad shapes)
            if pend_n.get(L, 0):
                _dispatch(L, np.concatenate(pend_idx[L]))
        _pump(block=True)
    finally:
        # idempotent; on exceptions this also drops queued encode jobs
        enc_pool.shutdown(wait=False, cancel_futures=True)
    _drain(0)

    n = len(chain)
    strands = strands[:n]
    dists = dists[:n]
    lengths = np.asarray(chain.lengths, np.int64)

    result = _finalize_scan(
        chain, lengths, peq2_np, m, a2, n,
        strands, dists, loc_rids, loc_vals,
        rev_tasks_rid, rev_tasks_end, overflow_rids, mesh, progress,
    )
    return rnames, chain, result


def _mask_chunk(
    codes, sub_lens, peq2, m, sub,
    strands, dists, loc_rids, loc_vals, rev_tasks_rid, rev_tasks_end,
    mesh=None,
):
    """jnp mask path: exact full argmin-end sets via (L, B) masks.

    Without a mesh it runs on the default device, rows padded up a
    power-of-two ladder; with a mesh the reads axis shards over 'data'.
    Padded rows are zero-length reads: they come back as d1==d2==m ties and
    are sliced away."""
    B = codes.shape[0]
    if mesh is not None:
        from ..parallel.mesh import shard_hw_block

        dp = int(mesh.shape["data"])
        bp = round_up(max(B, 1), dp)
        codes_p = full_fast((bp, codes.shape[1]), 4, np.int32)
        codes_p[:B] = codes
        lens_p = np.zeros(bp, np.int32)
        lens_p[:B] = sub_lens
        d, mask = shard_hw_block(
            mesh,
            jnp.asarray(codes_p.T),
            jnp.asarray(np.asarray(peq2)),
            jnp.asarray(lens_p),
            m,
        )
        d = np.asarray(d)[:B]
        mask = np.asarray(mask)[:, :B]
    else:
        bp = pow2_rows(B, 64)
        codes_p = full_fast((bp, codes.shape[1]), 4, np.int32)
        codes_p[:B] = codes
        lens_p = np.zeros(bp, np.int32)
        lens_p[:B] = sub_lens
        d, mask = _hw_block(
            jnp.asarray(codes_p.T),
            jnp.asarray(np.asarray(peq2)),
            jnp.asarray(lens_p),
            m,
        )
        d = np.asarray(d)[:B]
        mask = np.asarray(mask)[:, :B]
    d1, d2 = d[:, 0], d[:, 1]
    fwd = d1 < d2
    rev = d2 < d1
    strands[sub[fwd]] = 0
    strands[sub[rev]] = 1
    dists[sub[fwd]] = d1[fwd]
    dists[sub[rev]] = d2[rev]
    for bi in np.flatnonzero(fwd):
        ends = np.flatnonzero(mask[:, bi, 0]).astype(np.int64)
        loc_rids.append(np.full(ends.size, sub[bi], dtype=np.int64))
        loc_vals.append(ends)
    for bi in np.flatnonzero(rev):
        ends = np.flatnonzero(mask[:, bi, 1]).astype(np.int64)
        rev_tasks_rid.append(np.full(ends.size, sub[bi], dtype=np.int64))
        rev_tasks_end.append(ends)


class _D0Scanner:
    """Host exact-adapter resolver, split so the RAW scan (the byte pass)
    can run on the FASTQ-parse producer thread while the bytes are hot —
    the apply half (tiny numpy on hit subsets) stays on the consumer.

    ``raw(sb)`` scans one SeqBuffer batch -> (fwd_cnt, rc_cnt, ends) or
    None (no flat-buffer view). ``apply(sb, raw, off, ...)`` resolves every
    read with an exact hit (writing strands/dists/locs exactly as the
    scan collect path would: fwd locs = exact ends ascending; rev locs =
    (end - m + 1) - len - 1, the dist-0 SHW start being exact; both-strand
    hits = the d1 == d2 tie => left NA) and returns the keep-mask of
    still-unresolved reads. Calling the scanner does both."""

    K = 8  # per-strand end slots; cnt > K defers to the device/mask path

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        from ..ops.exact_prefilter import _pattern_keys

        self.lib = lib
        keys = _pattern_keys(pat_stack)
        self.key_fwd, self.key_rc = int(keys[0]), int(keys[1])
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = _os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        fc = np.zeros(n, np.int32)
        rcnt = np.zeros(n, np.int32)
        ends = np.zeros((n, 2 * self.K), np.int64)
        self.lib.sctag_adapter_d0(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.key_fwd, self.key_rc, self.m, self.K, self.nthreads,
            fc.ctypes.data, rcnt.ctypes.data, ends.ctypes.data,
        )
        return fc, rcnt, ends, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        fc, rcnt, ends, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        both = (fc > 0) & (rcnt > 0)  # d1 == d2 == 0 tie: stays NA
        fwd_ok = (fc > 0) & (rcnt == 0) & (fc <= K)
        rev_ok = (rcnt > 0) & (fc == 0) & (rcnt <= K)
        fi = np.flatnonzero(fwd_ok)
        if fi.size:
            g = off + fi
            strands[g] = 0
            dists[g] = 0
            cnts = fc[fi]
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(ends[fi, :K][kar < cnts[:, None]])
        ri = np.flatnonzero(rev_ok)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 0
            cnts = rcnt[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            e = ends[ri, K:][kar < cnts[:, None]]
            starts = e - (m - 1)
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        resolved = both | fwd_ok | rev_ok
        from ..utils.misc import PROF, _PROF_LOCK

        with _PROF_LOCK:  # a COUNT, not seconds (bench decomposition aid)
            PROF["scan.d0_resolved_reads"] = (
                PROF.get("scan.d0_resolved_reads", 0.0) + float(resolved.sum())
            )
        return ~resolved

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


class _D1Scanner:
    """Host dist<=1 adapter resolver (native/adapter_d1.cpp).

    Same raw/apply split and accumulator contract as :class:`_D0Scanner`,
    with the extra tier: reads whose adapter min distance is 0 OR 1 on
    exactly one strand resolve host-side (d, strand, full edlib location
    set); 0/0, 1/1 cross-strand minima are the d1 == d2 tie => NA. The
    native scan emits EXACT per-strand end sets at distance 0 and 1
    (pigeonhole half-key screen + exact verify — see adapter_d1.cpp), so
    every decision below is certain:

      * f0>0 & r0>0            -> NA (0 == 0 tie)
      * f0>0 only              -> '+', d=0, locs = d0 ends
      * r0>0 only              -> '-', d=0, locs = (end-m+1) - len - 1
      * no d0; f1>0 & r1>0     -> NA (1 == 1 tie)
      * no d0; f1>0 only       -> '+', d=1, locs = d1 ends
      * no d0; r1>0 only       -> '-', d=1, locs = start - len - 1
        (starts come from the native scan: minimal optimal start per end)
      * otherwise (or slot/candidate overflow) -> undecided, device path
    """

    K = 8  # per-tier per-strand slots; cnt > K defers to the device path

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        self.lib = lib
        self.pat_fwd = np.ascontiguousarray(pat_stack[0], np.uint8)
        self.pat_rc = np.ascontiguousarray(pat_stack[1], np.uint8)
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = _os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        f0 = np.zeros(n, np.int32)
        r0 = np.zeros(n, np.int32)
        f1 = np.zeros(n, np.int32)
        r1 = np.zeros(n, np.int32)
        ends0 = np.zeros((n, 2 * self.K), np.int64)
        ends1 = np.zeros((n, 2 * self.K), np.int64)
        flags = np.zeros(n, np.uint8)
        self.lib.sctag_adapter_scan1(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.pat_fwd.ctypes.data, self.pat_rc.ctypes.data, self.m,
            self.K, self.nthreads, f0.ctypes.data, r0.ctypes.data,
            f1.ctypes.data, r1.ctypes.data, ends0.ctypes.data,
            ends1.ctypes.data, flags.ctypes.data,
        )
        return f0, r0, f1, r1, ends0, ends1, flags, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        f0, r0, f1, r1, ends0, ends1, flags, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        ok = flags == 0
        both0 = ok & (f0 > 0) & (r0 > 0)
        fwd0 = ok & (f0 > 0) & (r0 == 0) & (f0 <= K)
        rev0 = ok & (r0 > 0) & (f0 == 0) & (r0 <= K)
        no0 = ok & (f0 == 0) & (r0 == 0)
        both1 = no0 & (f1 > 0) & (r1 > 0)
        fwd1 = no0 & (f1 > 0) & (r1 == 0) & (f1 <= K)
        rev1 = no0 & (r1 > 0) & (f1 == 0) & (r1 <= K)

        def _emit_fwd(sel, ends, dvals, d):
            i = np.flatnonzero(sel)
            if not i.size:
                return
            g = off + i
            strands[g] = 0
            dists[g] = d
            cnts = dvals[i]
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(ends[i, :K][kar < cnts[:, None]])

        _emit_fwd(fwd0, ends0, f0, 0)
        _emit_fwd(fwd1, ends1, f1, 1)
        ri = np.flatnonzero(rev0)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 0
            cnts = r0[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            e = ends0[ri, K:][kar < cnts[:, None]]
            starts = e - (m - 1)
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        ri = np.flatnonzero(rev1)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 1
            cnts = r1[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            starts = ends1[ri, K:][kar < cnts[:, None]]  # starts directly
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        resolved = both0 | fwd0 | rev0 | both1 | fwd1 | rev1
        from ..utils.misc import PROF, _PROF_LOCK

        n1 = float((both1 | fwd1 | rev1).sum())
        with _PROF_LOCK:  # COUNTS, not seconds (bench decomposition aid)
            PROF["scan.d0_resolved_reads"] = (
                PROF.get("scan.d0_resolved_reads", 0.0) + float(resolved.sum())
            )
            PROF["scan.d1_resolved_reads"] = (
                PROF.get("scan.d1_resolved_reads", 0.0) + n1
            )
        return ~resolved

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


class _D2Scanner:
    """Host dist<=2 adapter resolver (native/adapter_d2.cpp, r5).

    Same raw/apply contract as :class:`_D1Scanner` with a third tier: the
    native scan emits EXACT per-strand end sets at distance 0, 1 AND 2
    (3-part pigeonhole screen + banded verify), so the cascade extends one
    level — equal cross-strand minima at any tier are the d1 == d2 tie =>
    NA, a strictly smaller minimum resolves that strand with its full
    edlib location set, and only reads whose minima are >= 3 on both
    strands (or that overflow the slot/candidate budget) ship to the
    device."""

    K = 8

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        self.lib = lib
        self.pat_fwd = np.ascontiguousarray(pat_stack[0], np.uint8)
        self.pat_rc = np.ascontiguousarray(pat_stack[1], np.uint8)
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = _os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        cnts = [np.zeros(n, np.int32) for _ in range(6)]
        ends = [np.zeros((n, 2 * self.K), np.int64) for _ in range(3)]
        flags = np.zeros(n, np.uint8)
        self.lib.sctag_adapter_scan2(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.pat_fwd.ctypes.data, self.pat_rc.ctypes.data, self.m,
            self.K, self.nthreads,
            *(c.ctypes.data for c in cnts),
            *(e.ctypes.data for e in ends),
            flags.ctypes.data,
        )
        return cnts, ends, flags, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        (f0, r0, f1, r1, f2, r2), ends, flags, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        fs = [f0, f1, f2]
        rs = [r0, r1, r2]
        # per-strand minimum over the resolved tiers (3 = "unknown, >= 3")
        fmin = np.select([f0 > 0, f1 > 0, f2 > 0], [0, 1, 2], 3)
        rmin = np.select([r0 > 0, r1 > 0, r2 > 0], [0, 1, 2], 3)
        ok = flags == 0
        resolved = np.zeros(len(f0), bool)
        tie = ok & (fmin == rmin) & (fmin < 3)
        resolved |= tie  # NA: strands/dists stay -1
        lens_all = (offs[1:] - offs[:-1]).astype(np.int64)
        for d in range(3):
            fwd_w = ok & (fmin == d) & (rmin > d) & (fs[d] <= K)
            fi = np.flatnonzero(fwd_w)
            if fi.size:
                g = off + fi
                strands[g] = 0
                dists[g] = d
                cnts = fs[d][fi]
                loc_rids.append(np.repeat(g, cnts))
                loc_vals.append(ends[d][fi, :K][kar < cnts[:, None]])
                resolved[fi] = True
            rev_w = ok & (rmin == d) & (fmin > d) & (rs[d] <= K)
            ri = np.flatnonzero(rev_w)
            if ri.size:
                g = off + ri
                strands[g] = 1
                dists[g] = d
                cnts = rs[d][ri]
                lens_r = lens_all[ri]
                v = ends[d][ri, K:][kar < cnts[:, None]]
                starts = v - (m - 1) if d == 0 else v  # d>0 slots = starts
                loc_rids.append(np.repeat(g, cnts))
                loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
                resolved[ri] = True
        from ..utils.misc import PROF, _PROF_LOCK

        dmin = np.minimum(fmin, rmin)
        with _PROF_LOCK:  # COUNTS, not seconds (bench decomposition aid)
            PROF["scan.d0_resolved_reads"] = (
                PROF.get("scan.d0_resolved_reads", 0.0)
                + float(resolved.sum())
            )
            PROF["scan.d1_resolved_reads"] = PROF.get(
                "scan.d1_resolved_reads", 0.0
            ) + float((resolved & (dmin == 1)).sum())
            PROF["scan.d2_resolved_reads"] = PROF.get(
                "scan.d2_resolved_reads", 0.0
            ) + float((resolved & (dmin == 2)).sum())
        return ~resolved

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


def _make_d0_scanner(pat_stack: np.ndarray, m: int):
    """Host prefilter scanner, or None if the native lib is unavailable or
    the adapter is not pure uppercase ACGT (a junk char can never match
    exactly under the STRICT alphabet, so the device scan must handle such
    adapters — the packed keys cannot represent them). Returns the d<=1
    scanner by default (SCTAG_ADAPTER_D1=0 drops back to the d0-only r4
    behavior; the d1 screen needs m >= 10 for a selective half-key)."""
    if (pat_stack > 3).any():
        return None
    try:
        from ..native.build import load

        lib = load()
    except Exception:  # pragma: no cover - toolchain missing
        return None
    if _os.environ.get("SCTAG_ADAPTER_D1", "1") != "1":
        return _D0Scanner(lib, pat_stack, m)
    if m >= 15 and _os.environ.get("SCTAG_ADAPTER_D2", "0") == "1":
        # dist<=2 tier (r5, OPT-IN): 3-part screen needs >= 5-char parts —
        # 4-char parts false-fire so often on ~2kbp reads that the
        # candidate cap trips and the prefilter disables itself (measured:
        # m=12 -> 258/400 reads overflowed vs 0/400 at m=15; r5 review).
        # Host-only A/B on the Q20 fixture, on a 2-core CPU host: d2 64.1K
        # vs d1 76.5K reads/s — the +30% scan cost
        # (5.2 vs 4.0 s/1M reads) makes the probe the producer-side
        # critical path for only +1.1% resolution (0.9882 -> 0.9994).
        # Enable on hosts with >= 3-4 cores (the scan threads scale) or on
        # high-error data, where d<=1 resolves far less (~61% at 5%
        # per-base error vs ~91% for d<=2) and the avoided upload wins.
        return _D2Scanner(lib, pat_stack, m)
    if m >= 10:
        return _D1Scanner(lib, pat_stack, m)
    return _D0Scanner(lib, pat_stack, m)


def make_d0_scanner(adapter: str):
    """Producer-side host-prefilter scanner for the stage driver (None when
    disabled by SCTAG_ADAPTER_D0=0, the adapter exceeds one packed word, or
    the native lib is missing) — the SAME gating scan_adapters_stream
    applies, so a producer-attached raw result is always consumed."""
    m = len(adapter)
    if m > 32 or _os.environ.get("SCTAG_ADAPTER_D0", "1") != "1":
        return None
    pat_stack = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(rev_compl(adapter), STRICT_TABLE),
    ])
    return _make_d0_scanner(pat_stack, m)


def _scan_collect(
    out_np, B, sub,
    strands, dists, loc_rids, loc_vals, rev_tasks_rid, rev_tasks_end,
    overflow_rids, junk=None,
):
    """Vectorized unpack of one chunk's (n_out, Bp) scan output.

    ``junk`` marks rows with in-sequence non-ACGT chars: the packed scan's
    output is unspecified for those, so they join the exact mask fallback."""
    from ..ops.adapter_scan import SLOTS_K, unpack_scan_out

    fwd_o, rc_o = unpack_scan_out(out_np, B)
    d1, d2 = fwd_o["d"], rc_o["d"]
    fwd = d1 < d2
    rev = d2 < d1
    if junk is not None and junk.any():
        fwd &= ~junk
        rev &= ~junk
        overflow_rids.extend(sub[junk].tolist())
    strands[sub[fwd]] = 0
    strands[sub[rev]] = 1
    dists[sub[fwd]] = d1[fwd]
    dists[sub[rev]] = d2[rev]

    karange = np.arange(SLOTS_K)[None, :]
    # forward: flat (rid, loc) arrays, read-major (slots ascend per read)
    ok = fwd & (fwd_o["cnt"] <= SLOTS_K)
    fi = np.flatnonzero(ok)
    if fi.size:
        cnts = fwd_o["cnt"][fi]
        flat = fwd_o["slots"][fi][karange < cnts[:, None]].astype(np.int64)
        loc_rids.append(np.repeat(sub[fi], cnts))
        loc_vals.append(flat)
    overflow_rids.extend(sub[fwd & (fwd_o["cnt"] > SLOTS_K)].tolist())

    # reverse: flat (rid, end) task arrays, read-major
    ok = rev & (rc_o["cnt"] <= SLOTS_K)
    ri = np.flatnonzero(ok)
    if ri.size:
        cnts = rc_o["cnt"][ri]
        flat = rc_o["slots"][ri][karange < cnts[:, None]].astype(np.int64)
        rev_tasks_rid.append(np.repeat(sub[ri], cnts))
        rev_tasks_end.append(flat)
    overflow_rids.extend(sub[rev & (rc_o["cnt"] > SLOTS_K)].tolist())


def _recover_rev_starts(
    seqs, lengths, a2, m, rev_tasks_rid, rev_tasks_end, dists,
    loc_rids, loc_vals,
):
    """Batch reverse-SHW over 2m-wide windows; fills locs for '-' reads."""
    if not rev_tasks_rid:
        return
    rids = np.concatenate(rev_tasks_rid)
    ends = np.concatenate(rev_tasks_end)
    W = 2 * m
    rev_codes = encode_str(a2, STRICT_TABLE)[::-1]
    peq_rev_np = (
        build_peq_single_mw(rev_codes)
        if m > MAX_PATTERN_LEN
        else build_peq_single(rev_codes)
    )

    starts = np.zeros(rids.size, dtype=np.int64)
    # small slices only: SeqBuffer.substr avoids building full read strings
    substr = getattr(seqs, "substr", None) or (lambda r, a, b: seqs[r][a:b])
    for s, e in batch_iter(rids.size, 8192):
        rr, ee = rids[s:e], ends[s:e]
        wins = []
        for r, en in zip(rr, ee):
            w0 = max(0, int(en) - W + 1)
            wins.append(substr(int(r), w0, int(en) + 1)[::-1])
        codes, wl = encode_seqs(wins, pad_to=W)
        n = rr.size
        rp = pow2_rows(n, 256)
        codes_p = full_fast((rp, W), 4, np.int32)
        codes_p[:n] = codes
        wl_p = np.zeros(rp, np.int32)
        wl_p[:n] = wl
        tg = np.zeros(rp, np.int32)
        tg[:n] = dists[rr]
        k_last = np.asarray(
            _shw_last_block(
                jnp.asarray(codes_p.T),
                jnp.asarray(peq_rev_np),
                jnp.asarray(wl_p),
                jnp.asarray(tg),
                m,
            )
        )[:n]
        starts[s:e] = ee - k_last
    # tasks are read-major with ends ascending per read: append flat
    loc_rids.append(rids)
    loc_vals.append(starts - lengths[rids].astype(np.int64) - 1)
