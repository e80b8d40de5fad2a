"""Device meshes, in-process sharding, and collectives (production path).

The reference's only parallel backend is single-node fork multiprocessing
(SURVEY.md §2.3); its flagship parallelizes INSIDE one node via prefix-shard
workers (scTagger.py:688-716). The equivalent here is SPMD over a
jax.sharding.Mesh of the process's local devices (every card reaches every
other at the same rate, so the mesh follows the algorithm alone):

  data  axis : long reads / segments (DP — the reference's read-chunk imap)
  model axis : whitelist patterns   (TP analog of its prefix-keyspace shards)

Used by the PRODUCTION stage drivers (models/matcher.py, models/adapter.py):
every device chunk is laid out over the local mesh with shard_map, so a
process with N chips runs every kernel N-wide with zero code changes. The
per-device body is the single-device device code (the stage-3 Pallas
kernel on a GPU, the jnp path on the CPU); reductions over the model axis
are XLA collectives (NCCL between cards). Cross-HOST reductions
(multihost.HostGroup's jax transport) go through `allreduce_processes`
below, so this module is the single home for all mesh/collective code.

Env knobs:
  SCTAG_MAX_DEVICES=N      cap the local mesh (0/unset = all local devices)
  SCTAG_MODEL_PARALLEL=M   shard the pattern axis M-way in the jnp match
                           pass (pmin merge; byte-identical output)
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.myers import match_block_min
from ..runtime import count_kernel_call

# Observability: how many sharded dispatches ran and over how many devices
# (the multi-chip dryrun asserts the production path actually engaged).
STATS = {"sharded_calls": 0, "devices": 0}


def init_distributed(**kwargs) -> None:
    """Multi-host bootstrap (no-op if single-process)."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def compute_devices(backend: str | None = None) -> list:
    """Local devices of ``backend`` (default backend when None), capped by
    SCTAG_MAX_DEVICES."""
    devs = jax.local_devices(backend=backend)
    cap = int(os.environ.get("SCTAG_MAX_DEVICES", "0") or 0)
    if cap > 0:
        devs = devs[:cap]
    return devs


def local_mesh(
    divisor: int = 0,
    model_parallel: int | None = None,
    backend: str | None = None,
) -> Mesh | None:
    """('data', 'model') mesh over this process's local devices.

    Returns None when only one device is usable (callers then take their
    tuned single-device path, bit-identical by construction). ``divisor``
    constrains the data-axis size to divide it (kernel block granularity);
    the largest usable device count wins. ``model_parallel`` defaults to
    SCTAG_MODEL_PARALLEL (1).
    """
    devs = compute_devices(backend)
    mp = (
        int(os.environ.get("SCTAG_MODEL_PARALLEL", "1") or 1)
        if model_parallel is None
        else model_parallel
    )
    n = len(devs)
    n -= n % mp
    while n >= mp and divisor > 0 and divisor % (n // mp):
        n -= mp
    if n // max(mp, 1) < 1 or n < 2:
        return None
    return Mesh(np.array(devs[:n]).reshape(n // mp, mp), ("data", "model"))


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """Explicit-size mesh (tests / tools); asserts enough devices exist."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    assert n <= len(devs), (n, len(devs))
    assert n % model_parallel == 0, (n, model_parallel)
    grid = np.array(devs[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, ("data", "model"))


def _count(mesh: Mesh) -> None:
    STATS["sharded_calls"] += 1
    STATS["devices"] = int(mesh.devices.size)


# ---------------------------------------------------------------------------
# Stage 3: dense segment x whitelist matching over the mesh
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("mesh", "m", "interpret"))
def _match_full_sharded(seg_T, peq_rows, maxlens, mesh, m, interpret):
    from ..ops.match_pallas import _match_full, DEF_BP, DEF_BR

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, None), P("data")),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    def step(seg_local, peq_full, ml_local):
        return _match_full(seg_local, peq_full, ml_local, m, DEF_BR, DEF_BP,
                           interpret)

    return step(seg_T, peq_rows, maxlens)


def _check_match_shapes(mesh, seg_T, peq_rows, maxlens) -> None:
    from ..ops.match_pallas import DEF_BP, DEF_BR

    assert seg_T.shape[1] % (mesh.shape["data"] * DEF_BR) == 0, (
        seg_T.shape, mesh.shape
    )
    assert maxlens.shape[0] * DEF_BR == seg_T.shape[1], maxlens.shape
    assert peq_rows.shape[1] % (mesh.shape["model"] * DEF_BP) == 0, (
        peq_rows.shape, mesh.shape
    )


def shard_match_full(mesh, seg_T, peq_rows, maxlens, m: int,
                     interpret: bool = False):
    """Production fused min+ties kernel (ops/match_pallas.match_full), reads
    sharded over 'data' with the patterns replicated (the mp=1 fast path —
    no collectives beyond the implicit data split). seg_T: (Ls, R) with
    R % (n_data * DEF_BR) == 0; maxlens: (R // DEF_BR,) per-tile bounds.
    Returns the (TIES_K+2, R) device array WITHOUT syncing.
    For pattern-axis sharding use shard_match_full_mp."""
    assert mesh.shape["model"] == 1, mesh.shape
    _check_match_shapes(mesh, seg_T, peq_rows, maxlens)
    _count(mesh)
    count_kernel_call("match_full")
    return _match_full_sharded(seg_T, peq_rows, maxlens, mesh, m, interpret)


@functools.partial(jax.jit, static_argnames=("mesh", "m", "interpret"))
def _match_full_sharded_mp(seg_T, peq_rows, maxlens, mesh, m, interpret):
    from ..ops.match_pallas import BIG, DEF_BP, DEF_BR, TIES_K, _match_full

    mp = mesh.shape["model"]
    p_local = peq_rows.shape[1] // mp

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, "model"), P("data")),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    def step(seg_local, peq_local, ml_local):
        local = _match_full(seg_local, peq_local, ml_local, m, DEF_BR,
                            DEF_BP, interpret)
        # Rebase this shard's tie slots to GLOBAL pattern ids, then merge
        # exactly across the model axis (see shard_match_full_mp docstring
        # for the first-K containment argument).
        off = jax.lax.axis_index("model") * p_local
        gmin = jax.lax.pmin(local[0:1], "model")
        valid = local[0:1] == gmin  # this shard's min IS the global min
        gcnt = jax.lax.psum(jnp.where(valid, local[1:2], 0), "model")
        slots = jnp.where(valid & (local[2:] < BIG), local[2:] + off, BIG)
        cand = jax.lax.all_gather(slots, "model").reshape(
            mp * TIES_K, slots.shape[1]
        )
        merged = []
        for _t in range(TIES_K):
            mn = jnp.min(cand, axis=0, keepdims=True)  # (1, R_local)
            merged.append(mn)
            cand = jnp.where(cand == mn, BIG, cand)
        return jnp.concatenate([gmin, gcnt, *merged], axis=0)

    return step(seg_T, peq_rows, maxlens)


def shard_match_full_mp(mesh, seg_T, peq_rows, maxlens, m: int,
                        interpret: bool = False):
    """Fused min+ties kernel over a 2-D ('data','model') mesh: reads sharded
    over 'data' AND patterns sharded over 'model' (the TP analog of the
    reference's prefix-keyspace shards, scTagger.py:688-716, for the fused
    kernel).

    The per-shard kernel output does not commute naively (tie slots are
    collected against each shard's RUNNING min), but an exact merge exists:
      * global min = pmin of shard mins;
      * a shard's count/slots are valid iff its min equals the global min
        (its hits are then exactly its at-global-min patterns);
      * global count = psum of valid counts (pattern id ranges are disjoint);
      * global first-K slots = the K smallest of the union of valid shards'
        first-K lists, because any id x in the global first-K that lives in
        shard s has fewer than K at-min ids below it globally — hence fewer
        than K below it within s — so x is contained in s's first-K.
    Output is therefore bit-identical to the single-shard kernel for every
    row the driver consumes (pattern-axis PADDING hits at min == m can differ
    in count across pad widths, but min == m > max_error rows are discarded).

    seg_T: (Ls, R) with R % (n_data * DEF_BR) == 0; peq_rows: (8, P_pad)
    with P_pad % (n_model * DEF_BP) == 0. Returns (TIES_K+2, R) WITHOUT
    syncing."""
    _check_match_shapes(mesh, seg_T, peq_rows, maxlens)
    _count(mesh)
    count_kernel_call("match_full")
    return _match_full_sharded_mp(seg_T, peq_rows, maxlens, mesh, m,
                                  interpret)


@functools.partial(jax.jit, static_argnames=("mesh", "m"))
def _match_min_sharded(seg_T, peq, mesh, m):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, "model")),
        out_specs=P("data"),
        check_vma=False,
    )
    def step(seg_local, peq_local):
        pl_ = peq_local.shape[1]
        blk = min(pl_, 4096)  # bound the (R_local x blk) lane footprint
        best = jnp.full((seg_local.shape[1],), m, jnp.int32)
        nfull = pl_ // blk
        if nfull:
            blocks = (
                peq_local[:, : nfull * blk]
                .reshape(5, nfull, blk)
                .transpose(1, 0, 2)
            )

            def sbody(b, pq):
                return jnp.minimum(b, match_block_min(seg_local, pq, m)), None

            best, _ = jax.lax.scan(sbody, best, blocks)
        if pl_ % blk:
            best = jnp.minimum(
                best, match_block_min(seg_local, peq_local[:, nfull * blk :], m)
            )
        return jax.lax.pmin(best, "model")

    return step(seg_T, peq)


def shard_match_min(mesh, seg_T, peq, m: int):
    """jnp pass-1 over the mesh: reads over 'data', patterns over 'model'
    with a pmin merge (the TP analog of the reference's prefix-keyspace
    shards, scTagger.py:688-716 — min is exact, so output is byte-identical
    at any mesh shape). Caller pads: R % n_data == 0, P % n_model == 0,
    pattern padding all-zero Peq columns (distance pins at m, never below
    a real pattern). Returns the (R,) device array."""
    assert seg_T.shape[1] % mesh.shape["data"] == 0, (seg_T.shape, mesh.shape)
    assert peq.shape[1] % mesh.shape["model"] == 0, (peq.shape, mesh.shape)
    _count(mesh)
    return _match_min_sharded(seg_T, peq, mesh, m)


# ---------------------------------------------------------------------------
# Stage 1: adapter scan over the mesh
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("mesh", "m", "n_out"))
def _adapter_scan_sharded(pk, lens, peq2, mesh, m, n_out):
    from ..ops.adapter_scan import adapter_scan_local

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None, None)),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    def step(pk_local, lens_local, peq_full):
        return adapter_scan_local(pk_local, lens_local, peq_full, m, n_out)

    return step(pk, lens, peq2)


def shard_adapter_scan(mesh, pk, lens, peq2, m: int, n_out: int):
    """Production adapter scan (ops/adapter_scan.py), reads sharded over
    'data'. pk: (B, L/4) uint8 packed rows, lens: (B,) int32, peq2: (5, 2)
    int32, with B % (n_data * READ_TILE) == 0. Returns the (n_out, B)
    device array WITHOUT syncing."""
    from ..ops.adapter_scan import READ_TILE

    assert mesh.shape["model"] == 1, mesh.shape
    assert pk.shape[0] % (mesh.shape["data"] * READ_TILE) == 0, (
        pk.shape, mesh.shape
    )
    _count(mesh)
    return _adapter_scan_sharded(pk, lens, peq2, mesh, m, n_out)


@functools.partial(jax.jit, static_argnames=("mesh", "m"))
def _hw_block_sharded(text_T, peq2, lengths, mesh, m):
    from ..models.adapter import _hw_block

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, None), P("data")),
        out_specs=(P("data", None), P(None, "data", None)),
        check_vma=False,
    )
    def step(text_local, peq_full, len_local):
        return _hw_block(text_local, peq_full, len_local, m)

    return step(text_T, peq2, lengths)


def shard_hw_block(mesh, text_T, peq2, lengths, m: int):
    """jnp stage-1 fallback over the mesh: (L, B) codes -> per-read dists
    (B, 2) and argmin masks (L, B, 2), B sharded over 'data' (caller pads B
    to a mesh multiple with zero-length reads, which come back as d1==d2==m
    ties and are discarded)."""
    assert text_T.shape[1] % mesh.shape["data"] == 0, (
        text_T.shape, mesh.shape
    )
    _count(mesh)
    return _hw_block_sharded(text_T, peq2, lengths, mesh, m)


# ---------------------------------------------------------------------------
# Alt stage 2: exact whitelist probe over the mesh
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("mesh",))
def _probe_sharded(sorted_keys, values, qkeys, qvalid, mesh):
    from ..ops.exact_lookup import _probe

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None), P(None), P("data", None), P("data", None)),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    def step(sk, vv, qk, qv):
        return _probe(sk, vv, qk, qv)

    return step(sorted_keys, values, qkeys, qvalid)


def shard_probe(mesh, sorted_keys, values, qkeys, qvalid):
    """Device binary-search probe (ops/exact_lookup._probe) with query rows
    sharded over 'data' and the whitelist table replicated (it is small:
    ~24 MB packed for the 3M 10x list, broadcast once per jit). Caller pads
    rows to a data-axis multiple; padded rows must be qvalid=False."""
    assert mesh.shape["model"] == 1, mesh.shape  # table replicated
    assert qkeys.shape[0] % mesh.shape["data"] == 0, (qkeys.shape, mesh.shape)
    _count(mesh)
    return _probe_sharded(sorted_keys, values, qkeys, qvalid, mesh)


# ---------------------------------------------------------------------------
# Cross-process collectives (multihost.HostGroup's jax transport)
# ---------------------------------------------------------------------------


def allreduce_processes(arr: np.ndarray, op: str, identity) -> np.ndarray:
    """All-reduce one host ndarray across jax.distributed processes.

    Builds a 1-D mesh over ALL global devices, places this process's value on
    its first local device (identity elsewhere), and psum/pmin/pmax-merges.
    ``identity`` is the op's neutral element for arr.dtype."""
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("data",))
    ld = jax.local_device_count()
    local = np.broadcast_to(identity, (ld, *arr.shape)).copy()
    local[0] = arr
    from jax.sharding import NamedSharding

    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local, (len(devs), *arr.shape)
    )
    red = {"sum": jax.lax.psum, "min": jax.lax.pmin, "max": jax.lax.pmax}[op]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"),),
        out_specs=P(None),
        check_vma=False,
    )
    def step(x):
        return red(x, "data")

    return np.asarray(jax.device_get(step(garr)))[0]
