#!/usr/bin/env python3
"""Decompose the packed device exact-lookup:
kernel-only (tiny fetch) vs +download vs +upload vs full driver, at the
alt_device_3m bench shape (6M-key table, 64K x 28-char rows per chunk).

Usage: python tools/profile_packed_probe.py   (on the live backend)
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

from sctagger.ops.exact_lookup import _probe_rows_packed

rng = np.random.default_rng(0)
N_KEYS = 6_000_000
CHUNK = int(os.environ.get("SCTAG_PROBE_CHUNK", "65536"))
L = 28
K = 16

keys = np.unique(
    rng.integers(0, 2**32, size=int(N_KEYS * 1.05), dtype=np.uint32)
)[:N_KEYS]
vals = rng.integers(-(2**20), 2**20, size=keys.size).astype(np.int32)
pk = rng.integers(0, 256, size=(CHUNK, L // 4)).astype(np.uint8)
lens = np.full(CHUNK, L, np.int32)

sk = jnp.asarray(keys)
vv = jnp.asarray(vals)
pk_j = jnp.asarray(pk)
lens_j = jnp.asarray(lens)

print("backend", jax.default_backend(), "chunk", CHUNK, file=sys.stderr)
t0 = time.perf_counter()
c, v = _probe_rows_packed(sk, vv, pk_j, lens_j, K, L)
np.asarray(c)
print(f"warm (compile+run): {time.perf_counter() - t0:.1f}s")

REPS = 8
# kernel-only: dispatch REPS back to back, force with a 32-byte fetch
t0 = time.perf_counter()
outs = [_probe_rows_packed(sk, vv, pk_j, lens_j, K, L) for _ in range(REPS)]
np.asarray(outs[-1][0][:8])
dt = (time.perf_counter() - t0) / REPS
print(f"kernel-only: {dt*1e3:.1f} ms/chunk -> {CHUNK/dt/1e3:.0f} Krows/s")

# + full result download
t0 = time.perf_counter()
for _ in range(REPS):
    c, v = _probe_rows_packed(sk, vv, pk_j, lens_j, K, L)
    np.asarray(c), np.asarray(v)
dt = (time.perf_counter() - t0) / REPS
print(f"kernel+download: {dt*1e3:.1f} ms/chunk -> {CHUNK/dt/1e3:.0f} Krows/s")

# + upload each rep (the driver's steady state)
t0 = time.perf_counter()
for _ in range(REPS):
    c, v = _probe_rows_packed(
        sk, vv, jnp.asarray(pk), jnp.asarray(lens), K, L
    )
    np.asarray(c), np.asarray(v)
dt = (time.perf_counter() - t0) / REPS
print(f"upload+kernel+download: {dt*1e3:.1f} ms/chunk -> "
      f"{CHUNK/dt/1e3:.0f} Krows/s")
