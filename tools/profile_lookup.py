#!/usr/bin/env python3
"""Probe-path shootout at 10x-whitelist scale: hash vs sorted binary search.

Usage: python tools/profile_lookup.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sctagger.runtime import configure_jax

configure_jax()
import jax
import jax.numpy as jnp

from sctagger.ops.exact_lookup import _hash_probe, _probe, build_hash_table

rng = np.random.default_rng(0)
N_KEYS = 6_000_000  # 3M whitelist fwd+rc
N_Q = 1 << 22       # ~4M windows per probe call

keys = np.unique(rng.integers(0, 2**32, size=int(N_KEYS * 1.05), dtype=np.uint32))
keys = keys[:N_KEYS].astype(np.uint32)
vals = rng.integers(-3_000_000, 3_000_000, size=keys.size).astype(np.int64)
queries = np.concatenate([
    keys[rng.integers(0, keys.size, size=N_Q // 4)],
    rng.integers(0, 2**32, size=N_Q - N_Q // 4, dtype=np.uint32),
]).astype(np.uint32)
rng.shuffle(queries)
qvalid = np.ones(queries.size, bool)

tk, tv = build_hash_table(keys, vals)
print(f"table size {tk.size} load {keys.size / tk.size:.2f}", file=sys.stderr)

tk_j, tv_j = jnp.asarray(tk), jnp.asarray(tv)
sk_j, vv_j = jnp.asarray(keys), jnp.asarray(vals.astype(np.int32))
q_j, qv_j = jnp.asarray(queries), jnp.asarray(qvalid)

def timeit(label, fn, reps=5):
    h, v = fn()  # compile + warm
    h0, v0 = np.asarray(h), np.asarray(v)
    t0 = time.perf_counter()
    for _ in range(reps):
        h, v = fn()
        np.asarray(v)  # sync
    dt = (time.perf_counter() - t0) / reps
    print(f"{label}: {dt*1e3:.1f} ms = {N_Q/dt/1e6:.1f} Mqueries/s")
    return h0, v0

from sctagger.ops.exact_lookup import _sortjoin_probe

h3, v3 = timeit("sortjoin", lambda: _sortjoin_probe(sk_j, vv_j, q_j, qv_j))
h1, v1 = timeit("hash    ", lambda: _hash_probe(tk_j, tv_j, q_j, qv_j))
h2, v2 = timeit("sorted  ", lambda: _probe(sk_j, vv_j, q_j, qv_j))
assert np.array_equal(h1, h2) and np.array_equal(v1, v2)
assert np.array_equal(h3, h2) and np.array_equal(v3, v2)
print("parity OK")
