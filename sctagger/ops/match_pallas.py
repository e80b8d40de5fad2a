"""Stage-3 matcher kernel: dense segment x whitelist infix edit distance.

The flagship compute path: it replaces the reference's Python trie DFS
(scTagger.py:526-716) with a dense all-pairs Myers bit-vector DP, written as
a Pallas kernel on the Triton route for NVIDIA GPUs.

One program owns a tile of ``br`` segments. It loops over the pattern axis
in tiles of ``bp`` patterns INSIDE the program, and for each pattern tile
runs the character loop over the segments' text with the four (br, bp)
state tiles (pv, mv, score, best) held in registers. Across pattern tiles it
carries, per segment, the running min distance, the tie count at that min
and the first TIES_K tie pattern ids (reset-on-improve), so one sweep yields
the min and the tie set. The character loop stops at the tile's real max
segment length (``maxlens``, loaded by the program itself): rows past every
segment's end are pad code 4, which can never lower an infix distance.

Padding: segment padding uses code 4 (matches nothing), so no validity
masking is needed. Pattern-axis padding uses all-zero Peq (an empty pattern:
distance stays m), likewise harmless for every row the driver consumes
(min <= max_error < m). Read-axis padding rows produce garbage that callers
slice away.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..runtime import count_kernel_call
from ..utils import full_fast, round_up
from .myers import myers_step

DEF_BR = 16  # segments per program
DEF_BP = 128  # patterns per inner tile
NUM_WARPS = 4

TIES_K = 8  # in-kernel tie slots; overflow reads escalate host-side
BIG = 1 << 28


def _match_kernel(seg_ref, peq_ref, mlen_ref, out_ref, *, m: int, ls: int,
                  br: int, bp: int, n_ptiles: int):
    """seg_ref (ls, R) int8 position-major codes; peq_ref (8, P) int32
    base-major Peq (rows 0..3 = A, C, G, T); mlen_ref (R // br,) int32;
    out_ref (TIES_K + 2, R) int32: [0] min, [1] tie count, [2..] slots."""
    i = pl.program_id(0)
    r0 = pl.multiple_of(i * br, br)
    n_chars = jnp.minimum(mlen_ref[i], ls)
    shp = (br, bp)

    def pattern_tile(t, carry):
        dmin, cnt, *slots = carry
        p0 = pl.multiple_of(t * bp, bp)
        pc = [peq_ref[b, pl.ds(p0, bp)][None, :] for b in range(4)]

        def char(j, st):
            pv, mv, score, best = st
            c = seg_ref[j, pl.ds(r0, br)].astype(jnp.int32)[:, None]
            eq = jnp.where(
                c == 0, pc[0],
                jnp.where(c == 1, pc[1],
                          jnp.where(c == 2, pc[2],
                                    jnp.where(c == 3, pc[3], 0))),
            )
            pv, mv, score = myers_step(pv, mv, score, eq, m)
            return pv, mv, score, jnp.minimum(best, score)

        s0 = jnp.full(shp, m, jnp.int32)
        init = (jnp.full(shp, -1, jnp.int32), jnp.zeros(shp, jnp.int32), s0, s0)
        best = jax.lax.fori_loop(0, n_chars, char, init)[3]

        tile_min = jnp.min(best, axis=1)
        d_new = jnp.minimum(dmin, tile_min)
        improved = tile_min < dmin
        hits = best == d_new[:, None]
        cnt = jnp.where(improved, 0, cnt)
        slots = [jnp.where(improved, BIG, s) for s in slots]
        filled = jnp.minimum(cnt, TIES_K)

        def collect(args):
            # first free slots take this tile's hit ids in ascending order
            filled, *slots = args
            pid = jax.lax.broadcasted_iota(jnp.int32, shp, 1) + p0
            local = jnp.where(hits, pid, BIG)
            for _ in range(TIES_K):
                idx = jnp.min(local, axis=1)
                can = (idx < BIG) & (filled < TIES_K)
                slots = [
                    jnp.where(can & (filled == k), idx, slots[k])
                    for k in range(TIES_K)
                ]
                filled = filled + can.astype(jnp.int32)
                local = jnp.where(local == idx[:, None], BIG, local)
            return (filled, *slots)

        # most segments fill their slots in the first tiles that reach their
        # min; after that only the count moves (no reduce_or on this route)
        need = ((tile_min == d_new) & (filled < TIES_K)).astype(jnp.int32)
        res = jax.lax.cond(
            jnp.max(need) > 0, collect, lambda a: a, (filled, *slots)
        )
        cnt = cnt + jnp.sum(hits.astype(jnp.int32), axis=1)
        return (d_new, cnt, *res[1:])

    init = (
        jnp.full((br,), m, jnp.int32),
        jnp.zeros((br,), jnp.int32),
        *(jnp.full((br,), BIG, jnp.int32) for _ in range(TIES_K)),
    )
    fin = jax.lax.fori_loop(0, n_ptiles, pattern_tile, init)
    for k in range(TIES_K + 2):
        out_ref[k, pl.ds(r0, br)] = fin[k]


@functools.partial(
    jax.jit, static_argnames=("m", "br", "bp", "interpret", "num_warps")
)
def _match_full(seg_T, peq_rows, maxlens, m: int, br: int, bp: int,
                interpret: bool, num_warps: int = NUM_WARPS):
    ls, r = seg_T.shape
    p = peq_rows.shape[1]
    assert r % br == 0 and p % bp == 0, (seg_T.shape, peq_rows.shape, br, bp)
    return pl.pallas_call(
        functools.partial(
            _match_kernel, m=m, ls=ls, br=br, bp=bp, n_ptiles=p // bp
        ),
        grid=(r // br,),
        out_shape=jax.ShapeDtypeStruct((TIES_K + 2, r), jnp.int32),
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="match_full",
    )(seg_T, peq_rows, maxlens)


def match_full(seg_T, peq_rows, maxlens, m: int, br: int = DEF_BR,
               bp: int = DEF_BP, interpret: bool = False):
    """Single-sweep min + ties. seg_T: (Ls, R_pad) int8 (R_pad % br == 0);
    peq_rows: (8, P_pad) int32 (P_pad % bp == 0); maxlens: (R_pad // br,)
    int32 max real segment length per read tile (see tile_maxlens).

    Returns the (TIES_K+2, R_pad) int32 device array without syncing:
    [0] min dist, [1] tie count at the min, [2..] the first TIES_K tie
    pattern ids ascending (BIG where empty)."""
    count_kernel_call("match_full")
    return _match_full(seg_T, peq_rows, maxlens, m, br, bp, interpret)


def prep_peq_rows(peq_5p: np.ndarray, bp: int = DEF_BP) -> np.ndarray:
    """(5, P) Peq -> base-major (8, P_pad) int32 for the kernel (rows 0..3
    per base code, row 4 the all-zero pad code, P padded with empty
    patterns to a bp multiple)."""
    P = peq_5p.shape[1]
    out = np.zeros((8, round_up(max(P, 1), bp)), dtype=np.int32)
    out[:5, :P] = peq_5p
    return out


def prep_segs_T(
    seg_codes: np.ndarray, ls: int, br: int = DEF_BR, r_pad: int | None = None
) -> np.ndarray:
    """(R, L) uint8 codes -> position-major (ls, R_pad) int8, pad code 4.

    ``r_pad`` fixes the padded read count (e.g. the stage chunk size) so every
    chunk reuses one compiled kernel shape; defaults to rounding up to br.
    """
    R = seg_codes.shape[0]
    rp = round_up(max(R, 1), br) if r_pad is None else r_pad
    assert rp % br == 0 and rp >= R, (rp, br, R)
    out = full_fast((ls, rp), 4, np.int8)
    # assignment casts uint8->int8 during the copy (values are 0..4)
    out[: min(ls, seg_codes.shape[1]), :R] = seg_codes.T[:ls]
    return out


def tile_maxlens(lengths: np.ndarray, r_pad: int, br: int = DEF_BR) -> np.ndarray:
    """(R,) real segment lengths -> (r_pad // br,) int32 per-tile max (the
    kernel's character-loop bound; segments are length-sorted upstream, so
    the bound is tight)."""
    ll = np.zeros(r_pad, np.int32)
    ll[: lengths.size] = lengths
    return ll.reshape(r_pad // br, br).max(axis=1)
