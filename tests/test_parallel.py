"""Multi-device (8 virtual CPU devices) sharding tests for parallel/mesh.py.

These exercise the PRODUCTION mesh helpers the stage drivers dispatch through
(models/matcher.py, models/adapter.py): the jnp data+model-sharded min pass,
the Pallas fused kernel under shard_map (interpret mode), the sharded
adapter scan, and the jnp hw-block — each against its single-device twin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sctagger.core import LENIENT_TABLE, encode_seqs
from sctagger.ops import build_peq_multi, match_block_min
from sctagger.parallel import (
    local_mesh,
    make_mesh,
    shard_match_full,
    shard_match_full_mp,
    shard_match_min,
)

from oracle import random_dna


def _problem(n_segs=64, n_pats=32, ls=48):
    rng = np.random.default_rng(2)
    barcodes = [random_dna(rng, 16) for _ in range(n_pats)]
    segs = [random_dna(rng, 24) for _ in range(n_segs)]
    for r in range(0, n_segs, 3):  # plant some matches
        segs[r] = segs[r][:4] + barcodes[r % n_pats] + segs[r][4:]
    seg_codes, _ = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    peq = build_peq_multi(
        encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)[0]
    )
    return seg_codes, peq


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    mesh = make_mesh(8, model_parallel=2)
    assert mesh.devices.shape == (4, 2)


def test_local_mesh_divisor_and_cap(monkeypatch):
    mesh = local_mesh()
    assert mesh is not None and mesh.devices.size == 8
    # largest device count dividing the block count wins
    assert local_mesh(divisor=12).shape["data"] == 6
    assert local_mesh(divisor=7).shape["data"] == 7
    assert local_mesh(divisor=1) is None  # single shard -> single device
    monkeypatch.setenv("SCTAG_MAX_DEVICES", "1")
    assert local_mesh() is None
    monkeypatch.setenv("SCTAG_MAX_DEVICES", "4")
    assert local_mesh().devices.size == 4
    monkeypatch.setenv("SCTAG_MODEL_PARALLEL", "2")
    assert local_mesh().shape == {"data": 2, "model": 2}


def test_shard_match_min_matches_single_device():
    seg_codes, peq = _problem()
    seg_T = jnp.asarray(seg_codes.astype(np.int32).T)
    peq_j = jnp.asarray(peq)
    ref = np.asarray(match_block_min(seg_T, peq_j, 16))
    for mp in (1, 2, 4):
        mesh = make_mesh(8, model_parallel=mp)
        got = np.asarray(shard_match_min(mesh, seg_T, peq_j, 16))
        np.testing.assert_array_equal(got, ref)


def test_shard_match_full_matches_single_device():
    """Pallas fused kernel under shard_map (interpret mode on the CPU mesh)
    == the single-device call: the production multi-GPU path."""
    from sctagger.ops.match_pallas import (
        DEF_BR,
        match_full,
        prep_peq_rows,
        prep_segs_T,
        tile_maxlens,
    )

    rp = 8 * DEF_BR
    seg_codes, peq = _problem(n_segs=rp - 7)
    seg_T = jnp.asarray(prep_segs_T(seg_codes, ls=48, r_pad=rp))
    peq_pm = jnp.asarray(prep_peq_rows(peq))
    ml = jnp.asarray(tile_maxlens(np.full(rp - 7, 48), rp))
    single = np.asarray(match_full(seg_T, peq_pm, ml, 16, interpret=True))
    for n in (2, 4):
        mesh = make_mesh(n, model_parallel=1)
        got = np.asarray(
            shard_match_full(mesh, seg_T, peq_pm, ml, 16, interpret=True)
        )
        np.testing.assert_array_equal(got, single)


def test_shard_match_full_mp_matches_single_device():
    """Pattern-axis-sharded fused kernel (exact cross-shard tie merge) ==
    the single-device call, bit-for-bit, at every mesh shape.

    Patterns contain duplicates spread across shards so tie sets span shard
    boundaries and overflow TIES_K — the cases the merge proof covers."""
    from sctagger.ops.match_pallas import (
        DEF_BP,
        DEF_BR,
        TIES_K,
        match_full,
        prep_peq_rows,
        prep_segs_T,
        tile_maxlens,
    )

    rp = 8 * DEF_BR
    rng = np.random.default_rng(7)
    base = [random_dna(rng, 16) for _ in range(12)]
    # 64 patterns = 12 uniques cycled: every barcode recurs in >= 5 shard
    # positions, so at-min tie sets cross every model-axis split
    barcodes = [base[i % len(base)] for i in range(64)]
    n_segs = rp - 7
    segs = [random_dna(rng, 24) for _ in range(n_segs)]
    for r in range(0, n_segs, 2):  # plant exact hits -> ties > TIES_K
        segs[r] = segs[r][:4] + barcodes[r % len(barcodes)] + segs[r][4:]
    seg_codes, _ = encode_seqs(segs, pad_to=48, table=LENIENT_TABLE)
    peq = build_peq_multi(
        encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)[0]
    )
    seg_T = jnp.asarray(prep_segs_T(seg_codes, ls=48, r_pad=rp))
    # 8 pattern tiles (64 real + empty padding) divide every model axis
    peq_pm = jnp.asarray(prep_peq_rows(peq, bp=8 * DEF_BP))
    ml = jnp.asarray(tile_maxlens(np.full(n_segs, 48), rp))

    single = np.asarray(match_full(seg_T, peq_pm, ml, 16, interpret=True))
    assert (single[1] > TIES_K).any()  # overflow rows are exercised
    for mp in (2, 4, 8):
        mesh = make_mesh(8, model_parallel=mp)
        got = np.asarray(
            shard_match_full_mp(mesh, seg_T, peq_pm, ml, 16, interpret=True)
        )
        np.testing.assert_array_equal(got, single)


def test_shard_adapter_scan_matches_single_device():
    from sctagger.core import STRICT_TABLE, encode_str, rev_compl
    from sctagger.ops.adapter_scan import (
        READ_TILE,
        adapter_scan_dispatch,
        unpack_scan_out,
    )

    adapter = "CTACACGACGCTCTTCCGATCT"
    rng = np.random.default_rng(5)
    n = 2 * READ_TILE - 13
    reads, lens = [], []
    for _ in range(n):
        body = random_dna(rng, int(rng.integers(30, 90)))
        if rng.random() < 0.5:
            p = int(rng.integers(0, len(body)))
            body = body[:p] + adapter + body[p:]
        reads.append(body)
        lens.append(len(body))
    L = max(lens)
    codes = np.full((n, L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode_str(r, STRICT_TABLE)
    pat = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(rev_compl(adapter), STRICT_TABLE),
    ])
    peq2 = build_peq_multi(pat)
    lens = np.array(lens, np.int32)
    m = len(adapter)
    b_pad = 2 * READ_TILE
    single = np.asarray(adapter_scan_dispatch(codes, lens, peq2, m,
                                              b_pad=b_pad))
    mesh = make_mesh(2, model_parallel=1)
    got = np.asarray(
        adapter_scan_dispatch(codes, lens, peq2, m, b_pad=b_pad, mesh=mesh)
    )
    f1, r1 = unpack_scan_out(single, n)
    f2, r2 = unpack_scan_out(got, n)
    for a, b in ((f1, f2), (r1, r2)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_allreduce_processes_single_process():
    from sctagger.parallel import allreduce_processes

    a = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(allreduce_processes(a, "sum", 0), a)
    np.testing.assert_array_equal(
        allreduce_processes(a, "min", np.iinfo(np.int32).max), a
    )
