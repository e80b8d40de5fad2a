"""Stage-3 matcher model: dense LR-segment x whitelist infix matching.

Replaces the reference's per-worker trie build + error-tolerant DFS + shard
merge (scTagger.py:643-716) with ONE dense device sweep per chunk: the fused
kernel (ops/match_pallas._match_kernel) returns, per segment, the min
infix edit distance over all 2xN patterns (fwd + revcomp barcodes) plus the
first-K argmin tie pattern ids collected against the running min. Reads
whose tie set exceeds K escalate to a best-matrix + top_k pass.

Semantic equivalence to the trie (SURVEY.md §3.4): the trie records read ids
at every window-path depth in [bl-mr, bl+mr] over windows starting at every
segment offset, and the DFS consumes the barcode with <= mr errors — so the
reported quantity per (read, barcode, strand) is exactly the infix ("HW")
edit distance of the barcode vs the segment, clipped at mr. Pattern index
p = 2*bid + (1 if forward else 0), so ascending p equals the reference's
tie-set sort order `sorted(bids)` with strand False < True (scTagger.py:789).

Character semantics: the reference's map_char sends every byte except
uppercase C/G/T to 0 == 'A' (scTagger.py:512-516) — reproduced via the
LENIENT encoding table for both barcodes and segments.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.packing import (
    CODE_PAD,
    LENIENT_TABLE,
    encode_rows,
    encode_seqs,
    rev_compl,
    seq_lengths,
)
from ..ops.myers import (
    MAX_PATTERN_LEN,
    build_peq_multi,
    match_block_best,
    match_block_min,
)
from ..ops.match_pallas import (
    DEF_BP,
    DEF_BR,
    prep_peq_rows,
    prep_segs_T,
    tile_maxlens,
)
from ..runtime import use_kernels
from ..utils import batch_iter, full_fast, pow2_rows, round_up

PASS1_CHUNK = 131072  # segments per device call (large shape)

PASS2_CHUNK = 2048
TOPK_INIT = 16


@dataclasses.dataclass
class MatchResult:
    """Per-read match output for matched reads only (reference omits the rest).

    Tie sets are stored as fixed-width arrays (no per-read Python objects):
    row i of ``tie_slots`` holds the first min(tie_counts[i], K) tie pattern
    ids ascending; reads with more ties than K have their full sorted id list
    in ``overflow`` keyed by rid. Pattern id p = 2*bid + (1 if forward).
    Slot values past tie_counts[i] are unspecified (the kernel and prefilter
    paths write BIG; the jnp fallback leaves top_k residue) — consume via
    ``ties_of``/``tie_counts``, never raw slot comparisons.
    """

    rids: np.ndarray  # (M,) int64 read ids, ascending
    dists: np.ndarray  # (M,) int32 min edit distance (<= max_error)
    tie_counts: np.ndarray  # (M,) int64
    tie_slots: np.ndarray  # (M, K) int64
    overflow: dict[int, np.ndarray]

    def ties_of(self, i: int) -> np.ndarray:
        c = int(self.tie_counts[i])
        if c <= self.tie_slots.shape[1]:
            return self.tie_slots[i, :c]
        return self.overflow[int(self.rids[i])]


class MatchContext:
    """Reusable cross-call state for batched matching (the checkpointed
    flagship path, stages/match_trie.py): pattern encodings, the Peq table,
    the d1 neighborhood index (built ONCE on a worker thread instead of per
    batch), and optionally pinned globally-fitted length buckets so every
    batch reuses the same compiled kernel shapes even when a batch's length
    distribution shifts (Snakefile:121-134 resume contract without extra
    compiles)."""

    def __init__(self, barcodes: Sequence[str], buckets=None,
                 pipelined: bool = False):
        self.barcodes = list(barcodes)
        # True when the caller overlaps two match_segments calls on this ctx
        # (match_trie's two-deep batch pipeline): each call then halves its
        # in-flight device-chunk budget so total pending chunks match the
        # tuned single-call pipeline instead of doubling HBM/host pressure
        self.pipelined = bool(pipelined)
        self.bl = len(self.barcodes[0])
        self.pat_codes = _build_patterns(self.barcodes, self.bl)
        self.buckets = list(buckets) if buckets is not None else None
        # eager: shared by concurrently pipelined batch calls (match_trie
        # overlaps batch i's device tail with batch i+1's host work)
        if self.bl > MAX_PATTERN_LEN:
            from ..ops.myers import build_peq_multi_mw

            self._peq = build_peq_multi_mw(self.pat_codes)  # (W, 5, 2N)
        else:
            self._peq = build_peq_multi(self.pat_codes)  # (5, 2N)
        import threading

        self._nb_lock = threading.Lock()
        self._nb_thread = None
        self._nb_box: dict = {}

    def peq(self):
        return self._peq

    def start_nb_build(self) -> None:
        """Kick off the neighborhood-table build on a worker thread
        (idempotent, safe under concurrent batch calls)."""
        with self._nb_lock:
            if self._nb_thread is not None:
                return
            import threading

            from ..ops.exact_prefilter import NeighborhoodIndex

            def _build() -> None:
                try:
                    self._nb_box["idx"] = NeighborhoodIndex(self.pat_codes)
                except BaseException as e:  # propagate into nb_index()
                    self._nb_box["err"] = e

            self._nb_thread = threading.Thread(target=_build, daemon=True)
            self._nb_thread.start()

    def nb_index(self):
        self.start_nb_build()
        self._nb_thread.join()
        if "err" in self._nb_box:
            raise self._nb_box["err"]
        return self._nb_box["idx"]

    def nb_ready(self) -> bool:
        """Non-blocking: True iff the neighborhood index finished building
        (used to opportunistically re-probe carried survivors without ever
        stalling the dispatch pipeline on the build)."""
        t = self._nb_thread
        return t is not None and not t.is_alive() and "idx" in self._nb_box


def fit_buckets(lengths: np.ndarray) -> list[int]:
    """Public bucket fit for callers pinning buckets across batches
    (MatchContext); same quantile rule the single-shot path uses."""
    return _seg_buckets(np.asarray(lengths))


def _build_patterns(barcodes: Sequence[str], bl: int) -> np.ndarray:
    """Interleaved (2N, bl) lenient code array: p=2*bid rc, p=2*bid+1 fwd."""
    pats: list[str] = []
    for b in barcodes:
        pats.append(rev_compl(b))  # strand False first (sort order)
        pats.append(b)
    codes, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    return codes


def _seg_buckets(lengths: np.ndarray) -> list[int]:
    """Quantile-based buckets: AT MOST two compiled kernel shapes.

    Every distinct (Ls, R) shape is one more compile, so fewer, data-fitted
    buckets beat a fixed fine ladder: one bucket at the 90th length
    percentile (tight padding for the bulk) and one at the max. Within a
    bucket the kernel's per-tile length bound skips the padded rows."""
    if lengths.size == 0:
        return [32]
    q90 = int(np.quantile(lengths, 0.90))
    mx = int(lengths.max())
    b1 = max(16, round_up(q90, 8))
    b2 = max(b1, round_up(mx, 8))
    return [b1] if b2 == b1 else [b1, b2]


def _min_dist_jnp_chunked(seg_T: np.ndarray, peq: np.ndarray, m: int) -> np.ndarray:
    """Plain pass 1 over one chunk: (R,) min distance over all patterns.

    ``peq`` is (5, P) single-word (one tiled dispatch, ops/myers.py
    match_min_tiled; R must be a power of two >= 256) or (W, 5, P)
    multi-word (m > 32, pattern-chunked)."""
    from ..ops.myers import match_block_min_mw, match_min_tiled

    R = seg_T.shape[1]
    if peq.ndim == 2:
        P = peq.shape[1]
        p_tile = min(4096, round_up(P, 128))
        peq_p = np.zeros((5, round_up(P, p_tile)), np.int32)
        peq_p[:, :P] = peq
        return np.asarray(match_min_tiled(
            jnp.asarray(seg_T), jnp.asarray(peq_p), m,
            r_tile=min(R, 16384), p_tile=p_tile,
        ))
    out = full_fast(R, m, np.int32)
    seg_j = jnp.asarray(seg_T)  # upload once, reuse across pattern blocks
    for s, e in batch_iter(peq.shape[-1], 4096):
        block = np.asarray(
            match_block_min_mw(seg_j, jnp.asarray(peq[:, :, s:e]), m)
        )
        np.minimum(out, block, out=out)
    return out


def match_segments(
    segments: Sequence[str],
    barcodes: Sequence[str],
    max_error: int,
    progress: bool = False,
    force_kernel: bool = False,
    ctx: MatchContext | None = None,
    probe_first: bool = False,
) -> MatchResult:
    """Match every segment against fwd+rc of every barcode within max_error.

    ``force_kernel`` drives the Pallas kernel path in interpret mode on the
    CPU (tests of the streaming dispatch/prefilter logic); on a GPU the
    compiled kernel always runs (runtime.use_kernels).
    ``ctx`` reuses pattern/neighborhood state across batched calls and pins
    bucket shapes; ``probe_first`` gives the FIRST slice the full prefilter
    probe too (batches after the global first in the checkpointed stage —
    their pipeline is already warm, so the cold-start concession would only
    leak device work)."""
    if ctx is None:
        ctx = MatchContext(barcodes)
    bl = ctx.bl
    pat_codes = ctx.pat_codes
    mw = bl > MAX_PATTERN_LEN  # multi-word jnp path for long barcodes
    peq = ctx.peq()  # (5, 2N) single-word or (W, 5, 2N) multi-word
    n_pat = pat_codes.shape[0]
    use_kernel, interp = use_kernels(force_kernel)
    use_kernel = use_kernel and not mw  # the kernel is single-word

    n = len(segments)
    lengths = seq_lengths(segments)

    min_dist = full_fast(n, bl, np.int32)
    order = np.argsort(lengths, kind="stable")

    # ---- host dist<=1 prefilter (ops/exact_prefilter.py) ------------------
    # Reads whose min distance is 0 (exact window hit) or 1 (single-edit
    # neighborhood hit) have their complete tie set determined host-side —
    # resolved at >10x the device match rate via the native bucketed range
    # search, so only the min>1 remainder occupies device chunks.
    # Output-identical by construction (module docstring);
    # SCTAG_EXACT_PREFILTER=0 disables everything, SCTAG_PREFILTER_D1=0
    # drops back to the dist-0-only probe (the r3 behavior, A/B control).
    # On the kernel path the probe runs per-slice INSIDE the async dispatch
    # loop (overlapped with device compute, survivors repacked into full
    # chunks); elsewhere it runs slice-wise up front and shrinks `order`.
    prefilter = (
        os.environ.get("SCTAG_EXACT_PREFILTER", "1") == "1"
        and not mw
        and n > 0
        and int(lengths.max(initial=0)) <= max(4 * bl, 256)
    )
    exact_pairs: list[tuple[np.ndarray, np.ndarray]] = []  # (rids, pids)

    def _take_exact(sub: np.ndarray, ex) -> np.ndarray | None:
        """Record a probe result (rids local to ``sub``); returns the local
        keep-mask, or None when nothing hit. ``ex`` is ExactHits (all dist 0)
        or D1Hits (per-read dist 0/1); resolved reads leave the device path
        entirely, and tie sets are recorded for those within max_error."""
        if ex.rids.size == 0:
            return None
        g = sub[ex.rids]
        counts = np.diff(ex.offsets)
        dists = getattr(ex, "dists", None)
        if dists is None:
            min_dist[g] = 0
            gm, cm, pids = g, counts, ex.pids
        else:
            min_dist[g] = dists
            ok = dists <= max_error  # mr=0: dist-1 reads resolve unmatched
            gm = g[ok]
            cm = counts[ok]
            pids = ex.pids[np.repeat(ok, counts)]
        if gm.size:
            exact_pairs.append((np.repeat(gm, cm), pids))
        keep = np.ones(sub.size, bool)
        keep[ex.rids] = False
        return keep

    if prefilter:
        from ..ops.exact_prefilter import exact_tie_probe

        d1 = os.environ.get("SCTAG_PREFILTER_D1", "1") == "1" and bl <= 31
        if d1:
            # the ~2s neighborhood build runs on a worker thread behind the
            # first device chunk; _probe joins it on first use (a ctx reuses
            # the built index across batched calls)
            ctx.start_nb_build()

        def _probe(codes_s: np.ndarray, lens_s: np.ndarray):
            if d1:
                return ctx.nb_index().probe(codes_s, lens_s)
            return exact_tie_probe(codes_s, lens_s, pat_codes)

    if prefilter and not use_kernel:
        # slice-wise probe (bounded encode footprint: order is length-sorted,
        # so each slice pads only to its own max length)
        parts: list[np.ndarray] = []
        for s, e in batch_iter(order.size, PASS1_CHUNK):
            sub = order[s:e]
            ls_s = int(lengths[sub].max(initial=0)) or 1
            codes_s, _ = encode_rows(
                segments, sub, pad_to=ls_s, table=LENIENT_TABLE
            )
            keep = _take_exact(sub, _probe(codes_s, lengths[sub]))
            parts.append(sub if keep is None else sub[keep])
        if parts:
            order = np.concatenate(parts)
        if progress:
            print(
                f"[match] host prefilter: {n - order.size}/{n} reads "
                f"resolved at distance <= {1 if d1 else 0}",
                file=sys.stderr,
            )

    buckets = (
        ctx.buckets if ctx.buckets is not None else _seg_buckets(lengths[order])
    )
    if order.size and int(lengths[order[-1]]) > buckets[-1]:
        # pinned buckets narrower than this batch (foreign ctx): extend
        # rather than silently dropping the tail
        buckets = buckets + [round_up(int(lengths[order[-1]]), 8)]

    # ---- chunk layout (index ranges only; encoding happens in the dispatch
    # loop so the host encodes chunk i+1 while the device crunches chunk i) --
    bucket_idx: list[tuple[np.ndarray, int]] = []  # (idx, ls) per bucket
    lo = 0
    for ls in buckets:
        hi = int(np.searchsorted(lengths[order], ls, side="right"))
        idx = order[lo:hi]
        lo = hi
        if idx.size == 0:
            continue
        bucket_idx.append((idx, ls))
        if progress:
            print(
                f"[match] bucket<= {ls}: {idx.size} segments", file=sys.stderr
            )

    def _encode(sub, ls) -> np.ndarray:
        codes, _ = encode_rows(segments, sub, pad_to=ls, table=LENIENT_TABLE)
        return codes

    from ..ops.match_pallas import BIG, TIES_K, match_full
    from ..parallel.mesh import (
        local_mesh,
        shard_match_full,
        shard_match_full_mp,
        shard_match_min,
    )

    chunks: list[tuple[np.ndarray, np.ndarray, int]] = []  # (sub, codes, ls)
    tie_by_chunk: list[np.ndarray | None] = []

    # ---- device sweep: min dist + running-min tie collection --------------
    # A process with N usable local devices lays every chunk out over an
    # N-wide ('data',) mesh (parallel/mesh.py) — the in-node scaling analog
    # of the reference's prefix-shard Pool (scTagger.py:688-716). One device
    # => the tuned single-device dispatch, bit-identical output either way.
    if use_kernel:
        # model axis > 1 (SCTAG_MODEL_PARALLEL) routes through the exact
        # cross-shard tie merge (parallel/mesh.shard_match_full_mp)
        mesh = local_mesh(divisor=PASS1_CHUNK // DEF_BR)
        mp = mesh.shape["model"] if mesh is not None else 1
        # pattern columns must split evenly over the model axis in whole
        # kernel tiles: pad P to an mp*bp multiple
        peq_j = jnp.asarray(prep_peq_rows(peq, bp=mp * DEF_BP))
        # bound device memory held by queued chunk inputs/outputs; halved
        # when two calls overlap on a pipelined ctx so the TOTAL in-flight
        # budget stays at the single-call level
        MAX_INFLIGHT = 16 if ctx.pipelined else 32
        pending: list[tuple[int, object]] = []

        def _drain(limit: int) -> None:
            while len(pending) > limit:
                ci, dev = pending.pop(0)
                sub = chunks[ci][0]
                out = np.asarray(dev)[:, : sub.size]
                min_dist[sub] = out[0]
                tie_by_chunk[ci] = out[1:]

        # small "tail" shapes besides the full chunk: a bucket's final
        # partial flush (or a tiny whole input) pads to the smallest tail
        # that fits instead of the full chunk, for the cost of at most TWO
        # extra compiled shapes per bucket. Each tail must be a whole number
        # of read tiles divisible over the data mesh axis.
        dp = mesh.shape["data"] if mesh is not None else 1
        tail_chunks = [
            c
            for c in (PASS1_CHUNK // 8, PASS1_CHUNK // 2)
            if c >= DEF_BR and (c // DEF_BR) % max(dp, 1) == 0
        ]

        def _r_pad(n: int) -> int:
            for c in tail_chunks:
                if n <= c:
                    return c
            return PASS1_CHUNK

        def _dispatch(sub: np.ndarray, seg_codes: np.ndarray, ls: int) -> None:
            # async dispatch overlaps host work (encode/probe of the next
            # slice) with in-flight device chunks; one compiled shape per
            # bucket (+ the tail shapes)
            chunks.append((sub, seg_codes, ls))
            tie_by_chunk.append(None)
            r_pad = _r_pad(sub.size)
            seg_T = jnp.asarray(prep_segs_T(seg_codes, ls=ls, br=DEF_BR,
                                            r_pad=r_pad))
            maxlens = jnp.asarray(tile_maxlens(lengths[sub], r_pad, DEF_BR))
            if mesh is not None and mp > 1:
                dev = shard_match_full_mp(
                    mesh, seg_T, peq_j, maxlens, bl, interpret=interp
                )
            elif mesh is not None:
                dev = shard_match_full(
                    mesh, seg_T, peq_j, maxlens, bl, interpret=interp
                )
            else:
                dev = match_full(seg_T, peq_j, maxlens, bl, interpret=interp)
            pending.append((len(chunks) - 1, dev))
            _drain(MAX_INFLIGHT)

        # Streaming layout: encode + (optionally) prefilter-probe each input
        # slice, repack the min>0 survivors into FULL chunks, flush partials
        # only at bucket boundaries — so the dist<=1 fraction translates into
        # fewer device chunks, and the probe cost hides behind the async
        # device pipeline. The VERY FIRST slice is special-cased: with the
        # d1 tier on it gets the cheap EXACT probe (~0.2s, no neighborhood
        # build wait) — at an ~83%-resolved workload shipping it whole would
        # waste a full device chunk; with d1 off it ships whole unprobed
        # (the dist-0-only probe would not pay for its cost on that slice).
        #
        # Host pipeline: encode+probe of slice i+1 runs on a WORKER thread
        # (native encode and the bucketed range search both release the
        # GIL) while the main thread applies slice i's probe result,
        # repacks, and dispatches — the two host phases and the device all
        # overlap instead of serializing on the main thread. Probe results
        # are APPLIED strictly in slice order on the main thread, so
        # min_dist/exact_pairs mutation order (and thus output) is
        # identical to the serial form.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        slices: list[tuple[np.ndarray, int, str]] = []
        first_slice = True
        for idx, ls in bucket_idx:
            for s, e in batch_iter(idx.size, PASS1_CHUNK):
                if prefilter and (d1 or probe_first or not first_slice):
                    mode = (
                        "exact"
                        if (first_slice and d1 and not probe_first)
                        else "full"
                    )
                else:
                    mode = "none"
                slices.append((idx[s:e], ls, mode))
                first_slice = False

        def _prep(sub: np.ndarray, ls: int, mode: str):
            seg_codes = _encode(sub, ls)
            if mode == "exact":
                return seg_codes, exact_tie_probe(
                    seg_codes, lengths[sub], pat_codes
                )
            if mode == "full":
                return seg_codes, _probe(seg_codes, lengths[sub])
            return seg_codes, None

        prep_pool = ThreadPoolExecutor(1)
        prep_q: deque = deque()
        PREP_DEPTH = 2
        try:
            nxt = 0
            while nxt < min(PREP_DEPTH, len(slices)):
                prep_q.append(prep_pool.submit(_prep, *slices[nxt]))
                nxt += 1
            cur_ls = None
            carry_sub: list[np.ndarray] = []
            carry_codes: list[np.ndarray] = []
            carry_pend: list[bool] = []  # exact-only entries awaiting d1
            carry_n = 0

            def _reprobe_carry() -> None:
                # opportunistic d1 upgrade of carried exact-only survivors
                # slice 0 ships with only the cheap exact
                # probe (no neighborhood-build wait); by the time its
                # survivors actually DISPATCH the index is usually ready,
                # so re-probing prunes the ~40% of them that resolve at
                # distance 1 before they occupy padded device rows.
                # Output-identical: probe tiers are output-invisible by
                # construction, and when the index is not ready yet the
                # rows simply ship to the device as before.
                nonlocal carry_n
                if not any(carry_pend) or not ctx.nb_ready():
                    return
                for i, pend in enumerate(carry_pend):
                    if not pend:
                        continue
                    carry_pend[i] = False
                    sub_i = carry_sub[i]
                    if sub_i.size == 0:
                        continue
                    keep = _take_exact(
                        sub_i,
                        ctx.nb_index().probe(carry_codes[i], lengths[sub_i]),
                    )
                    if keep is not None:
                        carry_sub[i] = sub_i[keep]
                        carry_codes[i] = carry_codes[i][keep]
                        carry_n -= int(sub_i.size - carry_sub[i].size)

            def _flush() -> None:
                nonlocal carry_sub, carry_codes, carry_pend, carry_n
                _reprobe_carry()
                if carry_n:
                    _dispatch(np.concatenate(carry_sub),
                              np.concatenate(carry_codes), cur_ls)
                carry_sub, carry_codes, carry_pend, carry_n = [], [], [], 0

            for j, (sub, ls, mode) in enumerate(slices):
                seg_codes, ex = prep_q.popleft().result()
                if nxt < len(slices):
                    prep_q.append(prep_pool.submit(_prep, *slices[nxt]))
                    nxt += 1
                if ex is not None:
                    keep = _take_exact(sub, ex)
                    if keep is not None:
                        sub = sub[keep]
                        seg_codes = seg_codes[keep]
                if ls != cur_ls:
                    _flush()  # bucket boundary: same per-bucket semantics
                    cur_ls = ls
                carry_sub.append(sub)
                carry_codes.append(seg_codes)
                carry_pend.append(mode == "exact")
                carry_n += sub.size
                if carry_n >= PASS1_CHUNK:
                    _reprobe_carry()
                if carry_n >= PASS1_CHUNK:
                    sub_all = np.concatenate(carry_sub)
                    codes_all = np.concatenate(carry_codes)
                    while sub_all.size >= PASS1_CHUNK:
                        _dispatch(sub_all[:PASS1_CHUNK],
                                  codes_all[:PASS1_CHUNK], ls)
                        sub_all = sub_all[PASS1_CHUNK:]
                        codes_all = codes_all[PASS1_CHUNK:]
                    # pending granularity is lost in the repack; if the
                    # index was not ready the remainder just ships unprobed
                    # (pre-r5 behavior)
                    carry_sub, carry_codes = [sub_all], [codes_all]
                    carry_pend = [False]
                    carry_n = sub_all.size
            _flush()
        finally:
            prep_pool.shutdown(wait=False, cancel_futures=True)
        _drain(0)
    else:
        # plain jnp path (CPU backends, or multi-word barcodes on any
        # backend). With several local devices it runs data+model sharded
        # over the mesh; otherwise on the default device, chunk rows padded
        # up a power-of-two ladder so compiles stay few.
        chunk_specs = [
            (idx[s:e], ls)
            for idx, ls in bucket_idx
            for s, e in batch_iter(idx.size, PASS1_CHUNK)
        ]
        mesh = local_mesh() if not mw else None
        if mesh is not None:
            dp, mp = mesh.shape["data"], mesh.shape["model"]
            P = peq.shape[1]
            peq_pad = np.zeros((5, round_up(P, mp)), peq.dtype)
            peq_pad[:, :P] = peq
            peq_j = jnp.asarray(peq_pad)
            for sub, ls in chunk_specs:
                seg_codes = _encode(sub, ls)
                chunks.append((sub, seg_codes, ls))
                rp = round_up(sub.size, dp)
                seg_T = full_fast((ls, rp), CODE_PAD, np.int32)
                seg_T[:, : sub.size] = seg_codes.T
                out = np.asarray(
                    shard_match_min(mesh, jnp.asarray(seg_T), peq_j, bl)
                )
                min_dist[sub] = out[: sub.size]
        else:
            for sub, ls in chunk_specs:
                seg_codes = _encode(sub, ls)
                chunks.append((sub, seg_codes, ls))
                seg_T = full_fast((ls, pow2_rows(sub.size, 256)), CODE_PAD,
                                  np.int32)
                seg_T[:, : sub.size] = seg_codes.T
                min_dist[sub] = _min_dist_jnp_chunked(seg_T, peq, bl)[
                    : sub.size
                ]

    matched = np.flatnonzero(min_dist <= max_error)
    matched_set_dists = min_dist[matched]

    # ---- tie sets for matched reads (fixed-width arrays) ------------------
    M = matched.size
    tie_counts = np.zeros(M, dtype=np.int64)
    tie_slots = np.zeros((M, TIES_K), dtype=np.int64)
    overflow: dict[int, np.ndarray] = {}
    overflow_meta: list[tuple[int, np.ndarray, int]] = []

    if exact_pairs:
        # prefilter-resolved reads: CSR tie sets, same layout as the kernel's
        # (first TIES_K ascending; full set via overflow when larger). Slices
        # arrive in bucket/dispatch order with disjoint read sets and pids
        # ascending within each read, so a stable sort by read restores the
        # global CSR.
        er = np.concatenate([p[0] for p in exact_pairs])
        ep = np.concatenate([p[1] for p in exact_pairs])
        srt = np.argsort(er, kind="stable")
        er, ep = er[srt], ep[srt]
        erids, cnts = np.unique(er, return_counts=True)
        offsets = np.zeros(erids.size + 1, np.int64)
        np.cumsum(cnts, out=offsets[1:])
        rows = np.searchsorted(matched, erids)
        tie_counts[rows] = cnts
        pos = offsets[:-1, None] + np.arange(TIES_K)[None, :]
        msk = np.arange(TIES_K)[None, :] < cnts[:, None]
        vals = ep[np.minimum(pos, ep.size - 1)]
        # BIG filler past tie_counts, matching the kernel rows' empty slots
        tie_slots[rows] = np.where(msk, vals, BIG)
        for i in np.flatnonzero(cnts > TIES_K):
            overflow[int(erids[i])] = ep[offsets[i] : offsets[i + 1]]

    if use_kernel:
        for ci, (sub, seg_codes, ls) in enumerate(chunks):
            out = tie_by_chunk[ci]
            mrows = np.flatnonzero(min_dist[sub] <= max_error)
            if mrows.size == 0:
                continue
            msub = sub[mrows]
            rows = np.searchsorted(matched, msub)
            tie_counts[rows] = out[0][mrows]
            tie_slots[rows] = out[1:].T[mrows]
            for r in np.flatnonzero(out[0][mrows] > TIES_K):
                overflow_meta.append((int(msub[r]), seg_codes[mrows[r]], ls))
    else:
        for sub, seg_codes, ls in chunks:
            mrows = np.flatnonzero(min_dist[sub] <= max_error)
            for s, e in batch_iter(mrows.size, PASS2_CHUNK):
                rr = mrows[s:e]
                msub = sub[rr]
                nr = rr.size
                rp = pow2_rows(nr, 64)
                codes_p = full_fast((rp, seg_codes.shape[1]), CODE_PAD,
                                    np.uint8)
                codes_p[:nr] = seg_codes[rr]
                target = np.zeros(rp, np.int32)
                target[:nr] = min_dist[msub]
                best_t = _best_matrix_jnp_t(codes_p, peq, bl)
                rows = np.searchsorted(matched, msub)
                kk = min(TIES_K, n_pat)  # top_k k can't exceed n_pat
                cnt, idx = jax.tree.map(
                    np.asarray,
                    _topk_hits(best_t, jnp.asarray(target), n_pat, kk),
                )
                cnt, idx = cnt[:nr], idx[:nr]
                tie_counts[rows] = cnt
                tie_slots[rows, :kk] = idx
                for r in np.flatnonzero(cnt > TIES_K):
                    overflow_meta.append((int(msub[r]), seg_codes[rr][r], ls))

    if overflow_meta:
        _escalate_ties(overflow_meta, peq, min_dist, bl, n_pat, overflow)

    return MatchResult(
        rids=matched.astype(np.int64),
        dists=matched_set_dists,
        tie_counts=tie_counts,
        tie_slots=tie_slots,
        overflow=overflow,
    )


def _escalate_ties(overflow_meta, peq, min_dist, bl, n_pat, overflow) -> None:
    """Reads whose tie set exceeds TIES_K: full best-matrix + big top_k.

    Runs on the default device; overflow reads are rare and their count is
    data-dependent, so rows pad up a power-of-two ladder."""
    ls = max(o[2] for o in overflow_meta)
    n = len(overflow_meta)
    codes = full_fast((pow2_rows(n, 64), ls), CODE_PAD, np.uint8)
    for i, (_rid, c, _lsi) in enumerate(overflow_meta):
        codes[i, : c.shape[0]] = c
    rids = np.array([o[0] for o in overflow_meta], dtype=np.int64)
    peq_np = np.asarray(peq)
    for s, e in batch_iter(n, PASS2_CHUNK):
        best_t = _best_matrix_jnp_t(
            codes[s : s + pow2_rows(e - s, 64)], peq_np, bl
        )
        _collect_ties(best_t, min_dist[rids[s:e]], rids[s:e], n_pat, overflow)


@functools.partial(jax.jit, static_argnames=("n_pat", "k"))
def _topk_hits(best_t, target, n_pat: int, k: int):
    """best_t: (P_pad, Rc) int8; target: (Rc,) int32.

    Returns (cnt (Rc,), idx (Rc, k)): hit count per read and the first k hit
    pattern ids in ascending order (lax.top_k is index-stable for ties).
    """
    hits = (best_t[:n_pat, :].astype(jnp.int32).T == target[:, None]).astype(
        jnp.int32
    )
    cnt = hits.sum(axis=1)
    _, idx = jax.lax.top_k(hits, k)
    return cnt, idx


def _collect_ties(best_t, target_np, sub, n_pat: int, ties: dict) -> None:
    """Extract per-read argmin tie sets from a device best matrix via top_k,
    escalating k for the rare reads whose tie set overflows."""
    rc = sub.size
    target = jnp.asarray(np.pad(target_np, (0, best_t.shape[1] - rc)))
    k = min(TOPK_INIT, n_pat)
    cnt, idx = _topk_hits(best_t, target, n_pat, k)
    cnt = np.asarray(cnt)[:rc]
    idx = np.asarray(idx)[:rc]
    for r in range(rc):
        c = int(cnt[r])
        if c <= k:
            ties[int(sub[r])] = idx[r, :c].astype(np.int64)
    overflow = np.flatnonzero(cnt > k)
    if overflow.size:
        # one escalation suffices: cnt is exact, so k = max(cnt) covers
        # every overflowing read (cnt <= n_pat by construction)
        k = int(cnt[overflow].max())
        _, idx2 = _topk_hits(best_t, target, n_pat, k)
        idx2 = np.asarray(idx2)
        for r in overflow:
            ties[int(sub[r])] = idx2[r, : int(cnt[r])].astype(np.int64)


def _best_matrix_jnp_t(seg_codes: np.ndarray, peq: np.ndarray, m: int):
    """Plain path: (P, Rc) int8 best-distance matrix, pattern-chunked.

    ``peq`` is (5, P) single-word or (W, 5, P) multi-word."""
    from ..ops.myers import match_best_mw_t

    seg_T = jnp.asarray(seg_codes.astype(np.int32).T)
    mw = peq.ndim == 3
    P = peq.shape[-1]
    cols = []
    for s, e in batch_iter(P, 4096):
        if mw:
            cols.append(
                match_best_mw_t(seg_T, jnp.asarray(peq[:, :, s:e]), m).T
            )
        else:
            cols.append(_best_block_jnp(seg_T, jnp.asarray(peq[:, s:e]), m))
    # clamp before the int8 cast (distances can reach m; mr < 127 always in
    # practice, so the clamp can't collide with a real target)
    return jnp.minimum(jnp.concatenate(cols, axis=1), 127).astype(jnp.int8).T


_best_block_jnp = jax.jit(match_block_best, static_argnames="m")
