"""Stage-1 adapter scan on the device (replaces edlib HW), plain JAX.

One pass over each read computes, for BOTH the adapter and its reverse
complement (the reference runs two edlib calls per read,
scTagger.py:180-181):

  d        min infix edit distance over valid positions,
  cnt      number of optimal end positions,
  s0..s3   the first SLOTS_K optimal end positions (ascending; the largest
           optimal end for a non-overflowing read is slots[cnt-1]).

The first-K collection uses running registers against the current min, so no
(L x B) score or mask arrays ever exist: per-read output is a few ints.
Reads with cnt > SLOTS_K (multi-site adapter hits, rare) are re-processed by
the jnp mask fallback in models/adapter.py.

The 2-bit text is uploaded packed (4 chars per byte, read-major rows) and
relaid on the device into position-major int32 words (16 chars per word).
The scan is a ``lax.scan`` over words whose body advances both patterns over
the word's 16 chars for every read at once (two independent carry chains);
validity (j < read length) gates every hit so batch padding cannot fabricate
tie positions. A hand-written Pallas kernel of the same loop was 5x faster
per chunk on an H100 but no faster end to end (the stage is host-bound), so
the plain scan is the device path (PERF.md).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime import count_kernel_call
from ..utils import round_up
from .myers import myers_step

SLOTS_K = 4
WORD_CHARS = 16  # 2-bit chars per int32 word
READ_TILE = 64  # batch granularity (padded batch sizes are multiples)
LONG_PAD = 512  # long reads pad to multiples of this (few compiled shapes)


def n_out_for(l_total: int) -> int:
    """Output rows per read. Positions < 65536 pack two 16-bit fields per
    int32 row ([d|cnt<<16, s0|s1<<16, s2|s3<<16] x 2 patterns = 6, padded to
    8), halving the device->host result fetch. Ultra-long buckets (> 64K
    chars) keep the wide 16-row layout; unpack_scan_out dispatches on the
    row count. SCTAG_PACK_LIMIT lowers the threshold so tests can exercise
    the wide layout on short reads."""
    limit = min(int(os.environ.get("SCTAG_PACK_LIMIT", 0xFFFF)), 0xFFFF)
    return 8 if l_total <= limit else 16


def _init_state(shape, m: int):
    """Per pattern: pv, mv, score, d, cnt, SLOTS_K slots."""
    st = []
    for _ in range(2):
        st += [
            jnp.full(shape, -1, jnp.int32),
            jnp.zeros(shape, jnp.int32),
            jnp.full(shape, m, jnp.int32),
            jnp.full(shape, m, jnp.int32),
            jnp.zeros(shape, jnp.int32),
        ]
        st += [jnp.zeros(shape, jnp.int32) for _ in range(SLOTS_K)]
    return st


_NST = 5 + SLOTS_K


def _scan_word(st, word, j0, lens, peq, m: int):
    """Advance both patterns over the 16 chars of one packed word.

    st: flat state list (_init_state); word: int32 words of this position;
    j0: position of the word's first char; peq: [[A, C, G, T] per pattern]
    scalars."""
    st = list(st)
    for k in range(WORD_CHARS):
        c = (word >> (2 * k)) & 3
        b0 = (c & 1) != 0
        b1 = (c & 2) != 0
        j = j0 + k
        valid = j < lens
        for p in range(2):
            o = p * _NST
            pv, mv, score, d, cnt = st[o : o + 5]
            slots = st[o + 5 : o + _NST]
            pa, pc, pg, pt = peq[p]
            eq = jnp.where(b1, jnp.where(b0, pt, pg), jnp.where(b0, pc, pa))
            pv, mv, score = myers_step(pv, mv, score, eq, m)
            improve = valid & (score < d)
            tie = valid & (score == d)
            d = jnp.where(improve, score, d)
            # slots >= the final cnt are never read (the host unpack masks
            # karange < cnt), so improve need not clear old slots: slot 0
            # takes j on improve OR first tie, slot k on the k-th tie
            new_slots = [jnp.where(improve | (tie & (cnt == 0)), j, slots[0])]
            for kk in range(1, SLOTS_K):
                new_slots.append(jnp.where(tie & (cnt == kk), j, slots[kk]))
            cnt = jnp.where(improve, 1, jnp.where(tie, cnt + 1, cnt))
            st[o : o + _NST] = [pv, mv, score, d, cnt, *new_slots]
    return st


def _output_rows(st, packed: bool):
    """Final state -> output rows (see n_out_for)."""
    rows = []
    for p in range(2):
        o = p * _NST
        d, cnt, slots = st[o + 3], st[o + 4], st[o + 5 : o + _NST]
        if packed:
            # d <= m < 2^15 exact; cnt clipped at 255 (the host only tells
            # <= SLOTS_K from overflow); slots < 2^16 exact (s1/s3 << 16 may
            # set the sign bit: the host unpack shifts and masks)
            rows += [
                d | (jnp.minimum(cnt, 255) << 16),
                slots[0] | (slots[1] << 16),
                slots[2] | (slots[3] << 16),
            ]
        else:
            rows += [d, cnt, *slots]
    n_out = 8 if packed else 16
    zero = jnp.zeros_like(rows[0])
    return rows + [zero] * (n_out - len(rows))


def _words_T(pk):
    """(B, L/4) uint8 packed rows -> (L/16, B) int32 position-major words
    (char j of a read at word j >> 4, bits 2 * (j & 15))."""
    b, nbytes = pk.shape
    q = pk.reshape(b, nbytes // 4, 4).astype(jnp.int32)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    return words.T


def _peq_vec(peq2):
    """(5, 2) base-major Peq -> (8,) [fwd A, C, G, T, rc A, C, G, T]."""
    return jnp.concatenate([peq2[:4, 0], peq2[:4, 1]]).astype(jnp.int32)


def adapter_scan_local(pk, lens, peq2, m: int, n_out: int):
    """One device call (also the per-shard body under shard_map): pk
    (B, L/4) uint8 packed rows, lens (B,) int32, peq2 (5, 2) int32 ->
    (n_out, B) int32 rows (see n_out_for)."""
    text = _words_T(pk)
    pv = _peq_vec(peq2)
    peq = [[pv[p * 4 + b] for b in range(4)] for p in range(2)]

    def body(st, xs):
        w, word = xs
        return tuple(_scan_word(st, word, w * WORD_CHARS, lens, peq, m)), None

    st, _ = jax.lax.scan(
        body, tuple(_init_state(lens.shape, m)),
        (jnp.arange(text.shape[0]), text),
    )
    return jnp.stack(_output_rows(st, n_out == 8))


_adapter_scan = jax.jit(adapter_scan_local, static_argnames=("m", "n_out"))


def pad_len(L: int) -> int:
    """Kernel text length for reads up to L chars (one compiled shape per
    bucket: small lengths round to 32, long ones to whole LONG_PAD
    blocks)."""
    return round_up(L, 32) if L <= LONG_PAD else round_up(L, LONG_PAD)


def pack_codes(codes: np.ndarray, l_total: int) -> np.ndarray:
    """(B, L) strict codes -> (B, l_total/4) uint8 2-bit packed rows.

    Code 4 (pad/junk) maps to 'A' under the &3 — harmless for SUFFIX padding
    (the j < len gate blocks recording, and polluted DP state after a read's
    end never reaches a valid position), but WRONG for in-sequence junk
    chars: callers route reads containing junk to the exact mask fallback
    (models/adapter.py does). SeqBuffer inputs pack natively instead
    (io/fastq.py encode_packed)."""
    B, L = codes.shape
    cp = np.zeros((B, l_total), np.uint8)
    cp[:, :L] = codes
    cp &= 3
    return (
        cp[:, 0::4] | (cp[:, 1::4] << 2) | (cp[:, 2::4] << 4) | (cp[:, 3::4] << 6)
    )


def adapter_scan_dispatch_packed(
    pk: np.ndarray,
    lengths: np.ndarray,
    peq2: np.ndarray,
    m: int,
    l_total: int,
    b_pad: int | None = None,
    mesh=None,
):
    """Dispatch one chunk from packed rows: pk (B, l_total/4) uint8
    row-major (char j of row i at byte j >> 2, bits 2 * (j & 3)). Returns
    the (n_out, B_pad) device output WITHOUT syncing (feed np.asarray of it
    to unpack_scan_out). ``b_pad`` fixes the padded batch so boundary
    chunks reuse compiled shapes; with ``mesh`` (parallel/mesh.py) the reads
    are sharded over the mesh's data axis (b_pad must then be a multiple of
    n_data * READ_TILE)."""
    B, W = pk.shape
    assert W * 4 == l_total, (pk.shape, l_total)
    Bp = round_up(max(B, 1), READ_TILE) if b_pad is None else b_pad
    assert Bp % READ_TILE == 0 and Bp >= B, (Bp, B)
    if B < Bp:
        pkp = np.zeros((Bp, W), np.uint8)
        pkp[:B] = pk
        pk = pkp
    lens = np.zeros(Bp, np.int32)
    lens[:B] = lengths
    n_out = n_out_for(l_total)
    peq = jnp.asarray(np.asarray(peq2, np.int32))
    count_kernel_call("adapter_scan")
    if mesh is not None:
        from ..parallel.mesh import shard_adapter_scan

        return shard_adapter_scan(
            mesh, jnp.asarray(pk), jnp.asarray(lens), peq, m, n_out
        )
    return _adapter_scan(jnp.asarray(pk), jnp.asarray(lens), peq, m, n_out)


def adapter_scan_dispatch(codes, lengths, peq2, m: int, b_pad=None,
                          mesh=None):
    """adapter_scan_dispatch_packed from (B, L) strict codes."""
    l_total = pad_len(codes.shape[1])
    return adapter_scan_dispatch_packed(
        pack_codes(codes, l_total), lengths, peq2, m, l_total,
        b_pad=b_pad, mesh=mesh,
    )


def adapter_scan(codes, lengths, peq2, m: int, b_pad=None):
    """Synchronous host wrapper: (fwd, rc) dicts of (B,) d/cnt and
    (B, SLOTS_K) slots. When cnt > SLOTS_K the slots cover only the first
    SLOTS_K optimal ends (caller falls back for those reads)."""
    out = np.asarray(adapter_scan_dispatch(codes, lengths, peq2, m,
                                           b_pad=b_pad))
    return unpack_scan_out(out, codes.shape[0])


def unpack_scan_out(out: np.ndarray, B: int):
    """(n_out, B_pad) scan output -> (fwd, rc) dicts in read order;
    dispatches on the row count between the wide (16-row) and
    16-bit-packed (8-row, see n_out_for) layouts."""
    out = out[:, :B]
    if out.shape[0] == 8:  # packed: [d|cnt<<16, s0|s1<<16, s2|s3<<16] x 2
        def unpack(base):
            lo = out[base : base + 3] & 0xFFFF
            hi = (out[base : base + 3] >> 16) & 0xFFFF
            return {
                "d": lo[0],
                "cnt": hi[0],
                "slots": np.stack([lo[1], hi[1], lo[2], hi[2]], axis=1),
            }

        return unpack(0), unpack(3)

    def unpack(base):
        return {
            "d": out[base],
            "cnt": out[base + 1],
            "slots": out[base + 2 : base + 2 + SLOTS_K].T.copy(),
        }

    return unpack(0), unpack(6)
