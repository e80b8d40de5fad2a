#!/usr/bin/env python3
"""Two-process jax.distributed smoke test (CPU backend, localhost).

Validates the multi-host plumbing end to end on one machine: each process
contributes a shard of reads, runs the sharded match step over the GLOBAL
mesh, and checks the psum count merge. Run:

    python tools/multiprocess_smoke.py            # spawns both processes
    python tools/multiprocess_smoke.py --worker I # internal
"""

from __future__ import annotations

import os
import subprocess
import sys

import random

PORT = int(os.environ.get("SCTAG_SMOKE_PORT", 0)) or random.randint(20000, 40000)


def worker(pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{PORT}", num_processes=2, process_id=pid)
    import numpy as np
    import jax.numpy as jnp

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    import functools

    from sctagger.parallel import make_mesh

    mesh = make_mesh(8, model_parallel=1)
    # each process owns 4 of the 8 data shards; build the global array from
    # per-process shards
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data", None))
    local = np.full((4, 16), pid + 1, dtype=np.int32)
    garr = jax.make_array_from_process_local_data(sharding, local, (8, 16))
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data", None),), out_specs=P(None, None),
        check_vma=False,
    )
    def psum_counts(c):
        return jax.lax.psum(c, "data")

    merged = psum_counts(garr)
    got = np.asarray(jax.device_get(merged))[0]
    # 4 shards of 1s + 4 shards of 2s -> column sums 12
    assert (got == 12).all(), got
    print(f"[proc {pid}] multiprocess psum OK: {got[0]}", flush=True)

    # HostGroup jax transport (the stage drivers' cross-host reductions)
    from sctagger.parallel.multihost import HostGroup

    g = HostGroup(pid, 2, sync_dir="/nonexistent-unused")
    assert g.transport == "jax", g.transport
    a = np.arange(6, dtype=np.int64) + pid * 100
    s = g.allreduce(a, "sum")
    mn = g.allreduce(a, "min")
    mx = g.allreduce(a, "max")
    base = np.arange(6, dtype=np.int64)
    assert np.array_equal(s, base * 2 + 100), s
    assert np.array_equal(mn, base), mn
    assert np.array_equal(mx, base + 100), mx
    gat = g.allgather_scalar(pid + 5)
    assert np.array_equal(gat, [5, 6]), gat
    g.barrier()
    print(f"[proc {pid}] HostGroup jax transport OK", flush=True)


def main() -> None:
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["SCTAG_SMOKE_PORT"] = str(PORT)  # same port in both workers
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
            env=env,
        )
        for i in range(2)
    ]
    codes = [p.wait(timeout=300) for p in procs]
    assert codes == [0, 0], codes
    print("multiprocess smoke: OK")


if __name__ == "__main__":
    main()
