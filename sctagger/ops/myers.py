"""Bit-parallel Myers edit-distance primitives (plain JAX).

The reference offloads all edit-distance work to the edlib C++ library
(scTagger.py:180-181) and to a Python 4-ary trie DFS (scTagger.py:526-599).
Here both are replaced by ONE primitive: Hyyrö/Myers bit-vector dynamic
programming, where each int32 element carries the DP column state of one
(text, pattern) pair and the text scan is a `lax.scan` over character
positions. These functions are the plain path (CPU) and the reference the
stage-3 Pallas kernel (ops/match_pallas.py) is tested
against; ``myers_step`` is the one column update all of them share.

Distance semantics ("HW" / infix, matching edlib's mode used by the
reference): score_j = min over s <= j of edit_distance(pattern, text[s..j]),
i.e. the pattern may match any infix of the text. The "SHW" variant (prefix
mode, leading target gap penalized) is used for alignment-start recovery,
mirroring how edlib computes start locations (reverse SHW pass).

Character codes: 0..3 = A,C,G,T; 4 = "matches nothing" (strict-mode junk and
batch padding). Peq tables always have a zero row for code 4.

Pattern length m <= 32 fits one int32 word (the SR adapter is 22 bp and
barcodes 16 bp); longer patterns use the multi-word functions below
(edlib-style carry chain between 32-bit blocks), which the models select
automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.packing import CODE_PAD

MAX_PATTERN_LEN = 32


def high_bit(m: int) -> int:
    """Bit-(m-1) mask as a PYTHON int valid for jnp.int32 (m=32 would
    overflow a naive `1 << 31`; two's-complement wrap keeps the bit pattern)."""
    return int(np.int32(np.uint32(1 << (m - 1))))


# ---------------------------------------------------------------------------
# Peq construction (host-side, numpy)
# ---------------------------------------------------------------------------

def build_peq_single(pattern_codes: np.ndarray) -> np.ndarray:
    """Peq table for one pattern: (5,) int32; bit i of Peq[c] = (pattern[i]==c)."""
    m = len(pattern_codes)
    assert 0 < m <= MAX_PATTERN_LEN, m
    peq = np.zeros(CODE_PAD + 1, dtype=np.int64)
    for i, c in enumerate(pattern_codes):
        if c < CODE_PAD:  # junk pattern chars match nothing
            peq[int(c)] |= 1 << i
    return peq.astype(np.int32)  # two's complement bit pattern preserved


def build_peq_multi(pattern_codes: np.ndarray) -> np.ndarray:
    """Peq table for P patterns: (5, P) int32 from (P, m) code array."""
    P, m = pattern_codes.shape
    assert 0 < m <= MAX_PATTERN_LEN, m
    peq = np.zeros((CODE_PAD + 1, P), dtype=np.int64)
    weights = (1 << np.arange(m, dtype=np.int64))[None, :]  # (1, m)
    for c in range(CODE_PAD):
        peq[c] = ((pattern_codes == c) * weights).sum(axis=1)
    return peq.astype(np.int32)


# ---------------------------------------------------------------------------
# Core recurrence (traced; shapes are whatever broadcasting yields)
# ---------------------------------------------------------------------------

def myers_step(pv, mv, score, eq, m: int, shw: bool = False):
    """One Myers column update. All int32. Returns (pv, mv, score).

    ``shw=False``: HW/infix mode (first DP row all zeros — free leading text
    gap). ``shw=True``: SHW/prefix mode (first row = column index — leading
    text gap penalized), realized by the carry-in bit on Ph's shift.
    """
    high = jnp.int32(high_bit(m))
    one = jnp.int32(1)
    xv = eq | mv
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    score = score + ((ph & high) != 0).astype(jnp.int32)
    score = score - ((mh & high) != 0).astype(jnp.int32)
    ph = ph << 1
    if shw:
        ph = ph | one
    mh = mh << 1
    pv = mh | ~(xv | ph)
    mv = ph & xv
    return pv, mv, score


def _eq_lookup(peq: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Eq = Peq[c] without gather: 4-way select chain.

    peq: (5,) or (5, P); c: (...) int32 codes. Result broadcasts c against
    peq[b] rows: for peq (5,P) and c (B,), returns (B, P) via c[:, None].
    """
    if peq.ndim == 1:
        sel = c
    else:
        sel = c[..., None]
    eq = jnp.zeros(jnp.broadcast_shapes(sel.shape, peq[0].shape), jnp.int32)
    for b in range(4):
        eq = jnp.where(sel == b, peq[b], eq)
    return eq


def _scores_scan(text_T: jnp.ndarray, peq: jnp.ndarray, m: int, shw: bool):
    """Scan over text positions; returns per-position last-row scores.

    text_T: (L, B) int32 codes (position-major so each scan step reads one
    contiguous row). peq: (5,) shared pattern or (5, P).
    Returns scores of shape (L, B) [peq (5,)] or (L, B, P) [peq (5, P)]:
    scores[j] = D[m][j+1], the best edit distance of the pattern vs text
    spans ending at position j (inclusive).
    """
    lane_shape = (
        text_T.shape[1:] if peq.ndim == 1 else (*text_T.shape[1:], peq.shape[1])
    )
    pv0 = jnp.full(lane_shape, -1, jnp.int32)  # all ones
    mv0 = jnp.zeros(lane_shape, jnp.int32)
    s0 = jnp.full(lane_shape, m, jnp.int32)

    def step(carry, c):
        pv, mv, score = carry
        eq = _eq_lookup(peq, c)
        pv, mv, score = myers_step(pv, mv, score, eq, m, shw)
        return (pv, mv, score), score

    _, scores = jax.lax.scan(step, (pv0, mv0, s0), text_T)
    return scores


def hw_scores_scan(text_T, peq, m: int):
    """Infix-mode per-position scores (see _scores_scan)."""
    return _scores_scan(text_T, jnp.asarray(peq), m, shw=False)


def shw_scores_scan(text_T, peq, m: int):
    """Prefix-mode per-position scores (see _scores_scan)."""
    return _scores_scan(text_T, jnp.asarray(peq), m, shw=True)


# ---------------------------------------------------------------------------
# Stage-3 match blocks (plain path; the kernel is ops/match_pallas.py)
# ---------------------------------------------------------------------------
# The character loop is unrolled (Ls is static and small), so XLA emits the
# whole sweep plus the min over patterns as one loop fusion with the state
# in registers, instead of one loop iteration per character that reads and
# writes the (R, P) state in device memory. Long buckets unroll by 8 only:
# a fully unrolled chain of 64+ steps takes XLA minutes to compile.


def match_block_best(seg_T: jnp.ndarray, peq: jnp.ndarray, m: int):
    """(R, P) int32 best infix distance of every pattern vs every segment.

    seg_T: (Ls, R) int codes; peq: (5, P)."""
    lane_shape = (seg_T.shape[1], peq.shape[1])
    pv0 = jnp.full(lane_shape, -1, jnp.int32)
    mv0 = jnp.zeros(lane_shape, jnp.int32)
    s0 = jnp.full(lane_shape, m, jnp.int32)

    def step(carry, c):
        pv, mv, score, best = carry
        eq = _eq_lookup(peq, c.astype(jnp.int32))
        pv, mv, score = myers_step(pv, mv, score, eq, m)
        return (pv, mv, score, jnp.minimum(best, score)), None

    ls = seg_T.shape[0]
    (_, _, _, best), _ = jax.lax.scan(
        step, (pv0, mv0, s0, s0), seg_T, unroll=max(1, ls if ls <= 32 else 8)
    )
    return best


def match_block_min(seg_T: jnp.ndarray, peq: jnp.ndarray, m: int) -> jnp.ndarray:
    """Min infix edit distance of every pattern vs every segment.

    seg_T: (Ls, R) int codes; peq: (5, P). Returns (R,) int32: per segment,
    min over patterns AND positions. Equivalent to the reference trie query's
    best-match distance (scTagger.py:643-716) by the window/prefix argument in
    SURVEY.md §3.4 — but computed densely. Padding (code 4) cannot lower the
    min (a never-matching appended char can't decrease infix distance).
    """
    return jnp.min(match_block_best(seg_T, peq, m), axis=1)


@functools.partial(jax.jit, static_argnames=("m", "r_tile", "p_tile"))
def match_min_tiled(seg_T, peq, m: int, r_tile: int, p_tile: int):
    """match_block_min over a whole chunk in one dispatch: (R,) min over all
    patterns, swept in (r_tile, p_tile) blocks so the unrolled sweep's
    working set stays bounded. R % r_tile == 0 and P % p_tile == 0 (pad
    patterns with all-zero Peq columns: an empty pattern's distance is m,
    never below a real pattern's)."""
    ls, r = seg_T.shape
    p = peq.shape[1]
    segs = seg_T.reshape(ls, r // r_tile, r_tile).transpose(1, 0, 2)
    peqs = peq.reshape(5, p // p_tile, p_tile).transpose(1, 0, 2)

    def per_rtile(seg):
        def body(d, pq):
            return jnp.minimum(d, match_block_min(seg, pq, m)), None

        return jax.lax.scan(body, jnp.full((r_tile,), m, jnp.int32), peqs)[0]

    return jax.lax.map(per_rtile, segs).reshape(r)


@functools.partial(jax.jit, static_argnames=("m", "k", "r_tile", "p_tile"))
def match_full_ref(seg_T, peq, m: int, k: int, r_tile: int = 4096,
                   p_tile: int = 4096):
    """Plain-jnp twin of the stage-3 kernel's output contract.

    seg_T: (Ls, R) codes with R % r_tile == 0; peq: (5, P) with
    P % p_tile == 0. Returns (k+2, R) int32: [0] min distance over all
    patterns, [1] number of patterns at that min, [2..] the first k of them
    ascending (1 << 28 where empty). A min sweep over pattern tiles, then a
    second sweep that counts the hits at the min and takes the first k ids
    with an index-stable top_k."""
    ls, r = seg_T.shape
    p = peq.shape[1]
    segs = seg_T.reshape(ls, r // r_tile, r_tile).transpose(1, 0, 2)
    peqs = peq.reshape(5, p // p_tile, p_tile).transpose(1, 0, 2)
    big = jnp.int32(1 << 28)

    mins = match_min_tiled(seg_T, peq, m, r_tile, p_tile).reshape(-1, r_tile)

    def per_rtile(args):
        seg, d = args

        def tie_body(carry, xs):
            cnt, slots = carry
            t, pq = xs
            hits = match_block_best(seg, pq, m) == d[:, None]
            # first k hit ids of this tile (top_k is index-stable for ties)
            val, idx = jax.lax.top_k(hits.astype(jnp.int32), k)
            ids = jnp.where(val > 0, idx + t * p_tile, big)
            merged = jnp.sort(jnp.concatenate([slots, ids], axis=1), axis=1)
            return (cnt + hits.sum(axis=1, dtype=jnp.int32), merged[:, :k]), None

        init = (jnp.zeros((r_tile,), jnp.int32),
                jnp.full((r_tile, k), big, jnp.int32))
        (cnt, slots), _ = jax.lax.scan(
            tie_body, init, (jnp.arange(p // p_tile), peqs)
        )
        return jnp.concatenate([d[None], cnt[None], slots.T], axis=0)

    out = jax.lax.map(per_rtile, (segs, mins))  # (R / r_tile, k+2, r_tile)
    return out.transpose(1, 0, 2).reshape(k + 2, r)


# ---------------------------------------------------------------------------
# Multi-word Myers (patterns longer than 32 bp; any m)
# ---------------------------------------------------------------------------
# Carry chain between 32-bit blocks follows edlib's calculateBlock: the
# horizontal delta hIn in {-1,0,+1} enters the next word as the OR-ed bit of
# Eq (for -1) and the shifted-in bits of Ph/Mh. The last-row score is read at
# bit (m-1) % 32 of the top word BEFORE the shift, so no pattern padding
# tricks are needed. Used by the jnp fallback paths; the Pallas kernels keep
# the single-word fast path (every real chemistry fits 32 bp).


def n_words(m: int) -> int:
    return (m + 31) // 32


def build_peq_single_mw(pattern_codes: np.ndarray) -> np.ndarray:
    """(W, 5) int32 Peq for one pattern of any length."""
    m = len(pattern_codes)
    W = n_words(m)
    peq = np.zeros((W, CODE_PAD + 1), dtype=np.int64)
    for i, c in enumerate(pattern_codes):
        if c < CODE_PAD:
            peq[i // 32, int(c)] |= 1 << (i % 32)
    return peq.astype(np.int32)


def build_peq_multi_mw(pattern_codes: np.ndarray) -> np.ndarray:
    """(W, 5, P) int32 Peq for P patterns of uniform length m."""
    P, m = pattern_codes.shape
    W = n_words(m)
    peq = np.zeros((W, CODE_PAD + 1, P), dtype=np.int64)
    for w in range(W):
        bits = min(32, m - 32 * w)
        weights = (1 << np.arange(bits, dtype=np.int64))[None, :]
        chunk = pattern_codes[:, 32 * w : 32 * w + bits]
        for c in range(CODE_PAD):
            peq[w, c] = ((chunk == c) * weights).sum(axis=1)
    return peq.astype(np.int32)


def _step_mw(pvs, mvs, score, eqs, m: int, shw: bool):
    """One multi-word column update. pvs/mvs/eqs: lists of W arrays."""
    W = len(pvs)
    r = (m - 1) % 32
    one = jnp.int32(1)
    zero = jnp.zeros_like(score)
    hp = jnp.ones_like(score) if shw else zero  # carry in: D[0][j] delta
    hm = zero
    for w in range(W):
        pv, mv, eq = pvs[w], mvs[w], eqs[w]
        xv = eq | mv
        eq2 = eq | hm
        xh = (((eq2 & pv) + pv) ^ pv) | eq2
        ph = mv | ~(xh | pv)
        mh = pv & xh
        if w == W - 1:
            score = score + ((ph >> r) & one) - ((mh >> r) & one)
        hp_out = (ph >> 31) & one
        hm_out = (mh >> 31) & one
        ph = (ph << 1) | hp
        mh = (mh << 1) | hm
        pvs[w] = mh | ~(xv | ph)
        mvs[w] = ph & xv
        hp, hm = hp_out, hm_out
    return pvs, mvs, score


def _scores_scan_mw(text_T, peq_w, m: int, shw: bool):
    """Multi-word variant of _scores_scan. peq_w: (W, 5) or (W, 5, P)."""
    peq_w = jnp.asarray(peq_w)
    W = peq_w.shape[0]
    lane_shape = (
        text_T.shape[1:] if peq_w.ndim == 2 else (*text_T.shape[1:], peq_w.shape[2])
    )
    pv0 = [jnp.full(lane_shape, -1, jnp.int32) for _ in range(W)]
    mv0 = [jnp.zeros(lane_shape, jnp.int32) for _ in range(W)]
    s0 = jnp.full(lane_shape, m, jnp.int32)

    def step(carry, c):
        pvs, mvs, score = carry
        eqs = [_eq_lookup(peq_w[w], c) for w in range(W)]
        pvs, mvs, score = _step_mw(list(pvs), list(mvs), score, eqs, m, shw)
        return (tuple(pvs), tuple(mvs), score), score

    _, scores = jax.lax.scan(step, (tuple(pv0), tuple(mv0), s0), text_T)
    return scores


def hw_scores_scan_mw(text_T, peq_w, m: int):
    return _scores_scan_mw(text_T, peq_w, m, shw=False)


def shw_scores_scan_mw(text_T, peq_w, m: int):
    return _scores_scan_mw(text_T, peq_w, m, shw=True)


def _match_best_mw(seg_T, peq_w, m: int):
    """Multi-word (R, P) best-distance matrix with streaming min (no (L,R,P)
    intermediate)."""
    peq_w = jnp.asarray(peq_w)
    W = peq_w.shape[0]
    lane_shape = (seg_T.shape[1], peq_w.shape[2])
    pv0 = tuple(jnp.full(lane_shape, -1, jnp.int32) for _ in range(W))
    mv0 = tuple(jnp.zeros(lane_shape, jnp.int32) for _ in range(W))
    s0 = jnp.full(lane_shape, m, jnp.int32)

    def step(carry, c):
        pvs, mvs, score, best = carry
        eqs = [_eq_lookup(peq_w[w], c) for w in range(W)]
        pvs, mvs, score = _step_mw(list(pvs), list(mvs), score, eqs, m, False)
        return (tuple(pvs), tuple(mvs), score, jnp.minimum(best, score)), None

    (_, _, _, best), _ = jax.lax.scan(step, (pv0, mv0, s0, s0), seg_T)
    return best


def match_block_min_mw(seg_T, peq_w, m: int):
    """Multi-word match pass 1: (R,) min over patterns and positions."""
    return jnp.min(_match_best_mw(seg_T, peq_w, m), axis=1)


def match_best_mw_t(seg_T, peq_w, m: int):
    """Multi-word best-distance matrix, transposed (P, R) int32."""
    return _match_best_mw(seg_T, peq_w, m).T


def match_block_mask(
    seg_T: jnp.ndarray, peq: jnp.ndarray, m: int, target: jnp.ndarray
) -> jnp.ndarray:
    """Per-pattern hit mask: dist(seg, pattern) == target[segment].

    seg_T: (Ls, R); peq: (5, P); target: (R,) int32 (the segment's global min
    distance). Returns (R, P) bool. Used by the tie-set extraction pass.
    """
    lane_shape = (seg_T.shape[1], peq.shape[1])
    pv0 = jnp.full(lane_shape, -1, jnp.int32)
    mv0 = jnp.zeros(lane_shape, jnp.int32)
    s0 = jnp.full(lane_shape, m, jnp.int32)

    def step(carry, c):
        pv, mv, score, best = carry
        eq = _eq_lookup(peq, c)
        pv, mv, score = myers_step(pv, mv, score, eq, m, shw=False)
        return (pv, mv, score, jnp.minimum(best, score)), None

    (_, _, _, best), _ = jax.lax.scan(step, (pv0, mv0, s0, s0), seg_T)
    return best == target[:, None]
