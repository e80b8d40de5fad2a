"""Multi-process jax.distributed execution of the multi-host stages
: N REAL processes bootstrap through a local TCP
coordinator (CPU backend), HostGroup auto-selects the ``jax`` transport,
and the final stage outputs are byte-identical to the single-host run.

This is the jax-collective twin of test_multihost_stages.py (fs transport):
the reductions here ride allreduce_processes (psum/pmin/pmax over a global
device mesh, parallel/mesh.py:390) instead of .npy drops — asserted by the
sync dir containing NO fs-reduction artifacts after the run.
"""

import gzip
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from oracle import mutate, random_dna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("SCTAG_CHECKPOINT_DIR", None)
    # one CPU device per process: the conftest's 8-virtual-device XLA flag
    # would put 16 ranks in every Gloo rendezvous — slow and deadline-prone
    # on a 2-core host
    env.pop("XLA_FLAGS", None)
    return env


def _run_hosts_jax(argv_base, n_hosts, sync_dir, timeout=300):
    """One CLI process per host, bootstrapped via a local TCP coordinator."""
    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "sctagger", *argv_base,
                "--n-hosts", str(n_hosts), "--host-id", str(h),
                "--coordinator", f"127.0.0.1:{port}",
                "--sync-dir", str(sync_dir),
            ],
            env=_cli_env(),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            text=True,
        )
        for h in range(n_hosts)
    ]
    errs = [p.communicate(timeout=timeout)[1] for p in procs]
    codes = [p.returncode for p in procs]
    assert codes == [0] * n_hosts, "\n".join(errs)[-4000:]


def _run_single(argv, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "sctagger", *argv],
        env=_cli_env(), capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


def _assert_jax_transport(sync_dir) -> None:
    """The fs transport drops redNNNNN*.npy / barNNNNN files per collective;
    a jax-transport run must leave none (part merges may still use blobs)."""
    leftovers = [
        p.name
        for p in sync_dir.glob("*")
        if p.name.startswith(("red", "bar"))
    ]
    assert leftovers == [], leftovers


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mhjax")
    rng = np.random.default_rng(17)
    bcs = [random_dna(rng, 16) for _ in range(25)]
    lines = []
    for i in range(90):
        bc = mutate(rng, bcs[int(rng.integers(len(bcs)))],
                    int(rng.integers(0, 3)))
        body = random_dna(rng, int(rng.integers(60, 180)))
        r = rng.random()
        if r < 0.45:
            pos = int(rng.integers(3, 18))
            seq = body[:pos] + mutate(
                rng, ADAPTER, int(rng.integers(0, 3))) + bc + body[pos:]
        elif r < 0.8:
            from sctagger.core import rev_compl

            cut = max(0, len(body) - int(rng.integers(3, 18)))
            seq = body[:cut] + rev_compl(ADAPTER + bc) + body[cut:]
        else:
            seq = body
        lines.append(f"@r{i} c\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "reads.fastq"
    fq.write_text("".join(lines))
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t{500 - j}\n" for j, b in enumerate(bcs)))
    return tmp, fq, sr


def test_jax_transport_collectives_multiprocess(tmp_path):
    """HostGroup(transport='jax') across 2 REAL processes: int64 sum/min/max
    with values past 32 bits (the x64 scoping at multihost.py:162-167),
    allgather_scalar ordering, and barrier — results identical on both."""
    script = textwrap.dedent(
        """
        import sys
        pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        import jax
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=n, process_id=pid)
        import numpy as np
        from sctagger.parallel.multihost import HostGroup, \\
            jax_processes_match
        assert jax_processes_match(n)
        g = HostGroup(pid, n, sys.argv[4])  # transport auto-detects 'jax'
        assert g.transport == "jax", g.transport
        s = g.allreduce(np.array([1 << 40, -(1 << 41), 7], np.int64) + pid,
                        "sum")
        mn = g.allreduce(np.array([pid + 5, (1 << 50) + pid], np.int64),
                         "min")
        mx = g.allreduce(np.array([pid, -pid], np.int64), "max")
        ga = g.allgather_scalar(100 + pid)
        g.barrier()
        f = g.allreduce(np.array([0.5, -2.0]) * (pid + 1), "sum")
        print("RES", s.tolist(), mn.tolist(), mx.tolist(), ga.tolist(),
              f.tolist(), flush=True)
        """
    )
    port = _free_port()
    n = 2
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(h), str(n), str(port),
             str(tmp_path / "sync")],
            env=_cli_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for h in range(n)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o.strip().splitlines()[-1] for o, _ in outs]
    want = (
        "RES "
        f"{[(1 << 41) + 1, -(1 << 42) + 1, 15]} "
        f"{[5, 1 << 50]} {[1, 0]} {[100, 101]} {[1.5, -6.0]}"
    )
    assert lines == [want, want], lines
    # nothing rode the fs transport
    assert not (tmp_path / "sync").exists() or not list(
        (tmp_path / "sync").glob("red*")
    )


def test_extract_lr_bc_multihost_jax(fixtures, tmp_path):
    """Stage 1 over 2 jax.distributed processes == single-host, byte for
    byte (incl. the cross-host range-detection histogram psum)."""
    tmp, fq, _ = fixtures
    single = tmp / "single.tsv.gz"
    if not single.exists():
        _run_single(["extract_lr_bc", "-r", str(fq), "-o", str(single)])
    multi = tmp_path / "multi.tsv.gz"
    sync = tmp_path / "sync"
    _run_hosts_jax(
        ["extract_lr_bc", "-r", str(fq), "-o", str(multi)], 2, sync
    )
    assert gzip.open(multi, "rb").read() == gzip.open(single, "rb").read()
    _assert_jax_transport(sync)


def test_match_trie_multihost_jax(fixtures, tmp_path):
    """The flagship over 2 jax.distributed processes == single-host."""
    tmp, fq, sr = fixtures
    lr = tmp / "single.tsv.gz"
    if not lr.exists():
        _run_single(["extract_lr_bc", "-r", str(fq), "-o", str(lr)])
    single = tmp_path / "m_single.tsv"
    _run_single([
        "match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2", "-t", "1",
        "-o", str(single),
    ])
    multi = tmp_path / "m_multi.tsv"
    sync = tmp_path / "sync_mt"
    _run_hosts_jax(
        ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2", "-t",
         "1", "-o", str(multi)], 2, sync,
    )
    assert multi.read_text() == single.read_text()
    _assert_jax_transport(sync)
