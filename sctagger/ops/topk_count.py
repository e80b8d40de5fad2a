"""Key counting + frequency ordering (SURVEY.md §7 kernel d).

Replaces the reference's Counter + sorted() (scTagger.py:473-476, 828) with
an XLA sort/segment-reduce: one multi-operand sort groups the keys, scatter
adds produce per-unique counts and first-occurrence positions, and a second
two-key sort orders by (count desc, first_pos asc) — exactly Python's stable
`sorted(..., key=count, reverse=True)` over insertion-ordered Counter items.

Pure jnp, left to XLA's sorts: there is nothing for a custom kernel to
beat here.

PRODUCTION NOTE: the stage drivers call ``count_and_rank_host`` instead —
the input (a few million uint32 ids) never justifies a device round trip,
and its DATA-DEPENDENT shape would compile once per run. The device
version stays for on-device pipelines whose ids never leave device memory;
both orders are identical and cross-tested (tests/test_topk_count.py).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _jitted():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _count_and_rank(keys, valid):
        return _count_and_rank_impl(keys, valid, jax, jnp)

    return _count_and_rank


def _count_and_rank_impl(keys, valid, jax, jnp):
    """keys: (N,) int32-bitcast uint32; valid: (N,) bool.

    Returns (unique_padded, counts_padded, first_padded, rank_order, n_unique)
    where the first three are (N,) arrays whose first n_unique entries are the
    unique keys with counts/first positions, and rank_order is the permutation
    of [0, N) ordering unique slots by (count desc, first asc).
    """
    n = keys.shape[0]
    # validity is a leading SORT KEY (not an in-band sentinel value), so every
    # uint32 key — including 0xFFFFFFFF, a real all-T 16-mer — counts correctly
    inv = (~valid).astype(jnp.int32)
    k = keys.astype(jnp.uint32)
    idx = jnp.arange(n, dtype=jnp.int32)
    s_inv, sk, si = jax.lax.sort((inv, k, idx), num_keys=2)
    ok = s_inv == 0  # valid entries sort first
    is_start = ok & jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    seg = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    seg = jnp.where(ok, seg, n - 1)  # dump invalids on a dead slot
    ones = ok.astype(jnp.int32)
    counts = jnp.zeros((n,), jnp.int32).at[seg].add(ones, mode="drop")
    first = jnp.full((n,), n, jnp.int32).at[seg].min(
        jnp.where(ok, si, n), mode="drop"
    )
    uniq = jnp.zeros((n,), jnp.uint32).at[seg].max(
        jnp.where(ok, sk, 0), mode="drop"
    )
    n_unique = is_start.sum()
    # rank by (count desc, first asc); empty slots (count 0) sink to the end
    neg_counts = -counts
    _, _, order = jax.lax.sort(
        (neg_counts, first, jnp.arange(n, dtype=jnp.int32)), num_keys=2
    )
    return uniq, counts, first, order, n_unique


def count_and_rank(keys: np.ndarray, valid: np.ndarray | None = None):
    """Device wrapper: returns (keys_ranked, counts_ranked) numpy arrays,
    ordered by count desc with ties by first occurrence."""
    n = keys.shape[0]
    if n == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    if valid is None:
        valid = np.ones(n, bool)
    import jax
    import jax.numpy as jnp

    uniq, counts, first, order, n_unique = jax.tree.map(
        np.asarray,
        _jitted()(jnp.asarray(keys.view(np.int32)), jnp.asarray(valid)),
    )
    u = int(n_unique)
    ranked = order[:u]
    return uniq[ranked].astype(np.uint32), counts[ranked].astype(np.int64)


def count_and_rank_host(keys: np.ndarray, valid: np.ndarray | None = None):
    """Host numpy twin of count_and_rank (identical order) — the production
    path (see module note). keys: (N,) uint32 ids."""
    if valid is not None:
        keys = keys[valid]
    n = keys.shape[0]
    if n == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    k64 = keys.astype(np.int64)
    cnt = np.bincount(k64)
    uniq, fidx = np.unique(k64, return_index=True)
    nz = uniq
    order = np.lexsort((fidx, -cnt[nz]))
    ranked = nz[order]
    return ranked.astype(np.uint32), cnt[ranked].astype(np.int64)
