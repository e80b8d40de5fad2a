"""Multi-host stage execution parity: N cooperating CLI processes (fs
transport, CPU backend) must produce byte-identical final output to the
single-host run — stage 1 (incl. the cross-host range-detection histogram
merge), the stage-3 flagship, and the alt-stage-2 whitelist recovery."""

import gzip
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from oracle import mutate, random_dna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("SCTAG_CHECKPOINT_DIR", None)
    return env


def _run_hosts(argv_base, n_hosts, timeout=240):
    """Launch one CLI process per host concurrently; assert all succeed."""
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "sctagger", *argv_base,
                "--n-hosts", str(n_hosts), "--host-id", str(h),
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
    assert codes == [0] * n_hosts, "\n".join(errs)[-3000:]


def _run_single(argv, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "sctagger", *argv],
        env=_cli_env(),
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


def _gz_bytes(path):
    return gzip.open(path, "rb").read()


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """FASTQ with planted adapters + a whitelist hit by the segments."""
    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(99)
    bcs = [random_dna(rng, 16) for _ in range(30)]
    lines = []
    for i in range(120):
        bc = bcs[int(rng.integers(len(bcs)))]
        bc = mutate(rng, bc, int(rng.integers(0, 3)))
        body = random_dna(rng, int(rng.integers(60, 200)))
        r = rng.random()
        if r < 0.45:
            pos = int(rng.integers(3, 20))
            ad = mutate(rng, ADAPTER, int(rng.integers(0, 3)))
            seq = body[:pos] + ad + bc + body[pos:]
        elif r < 0.8:
            from sctagger.core import rev_compl

            ins = rev_compl(ADAPTER + bc)
            cut = max(0, len(body) - int(rng.integers(3, 20)))
            seq = body[:cut] + ins + body[cut:]
        else:
            seq = body
        lines.append(f"@r{i} c\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "reads.fastq"
    fq.write_text("".join(lines))
    wl = tmp / "whitelist.txt"
    wl.write_text("".join(b + "\n" for b in bcs))
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t{1000 - j}\n" for j, b in enumerate(bcs)))
    return tmp, fq, wl, sr


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_extract_lr_bc_multihost(fixtures, tmp_path, n_hosts):
    tmp, fq, _, _ = fixtures
    single = tmp / "single.tsv.gz"
    if not single.exists():  # shared across params
        _run_single(["extract_lr_bc", "-r", str(fq), "-o", str(single)])
    multi = tmp_path / "multi.tsv.gz"
    _run_hosts(["extract_lr_bc", "-r", str(fq), "-o", str(multi)], n_hosts)
    assert _gz_bytes(multi) == _gz_bytes(single)
    # no leftover part files
    assert not list(tmp_path.glob("*.part"))


def test_match_trie_multihost(fixtures, tmp_path):
    tmp, fq, _, sr = fixtures
    lr = tmp / "single.tsv.gz"
    if not lr.exists():
        _run_single(["extract_lr_bc", "-r", str(fq), "-o", str(lr)])
    single = tmp_path / "m_single.tsv"
    _run_single([
        "match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2", "-t", "1",
        "-o", str(single),
    ])
    multi = tmp_path / "m_multi.tsv"
    _run_hosts([
        "match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2", "-t", "1",
        "-o", str(multi),
    ], 2)
    assert multi.read_bytes() == single.read_bytes()
    assert single.read_text().count("\n") > 10  # non-trivial output


def test_extract_sr_bc_from_lr_multihost(fixtures, tmp_path):
    tmp, fq, wl, _ = fixtures
    lr = tmp / "single.tsv.gz"
    if not lr.exists():
        _run_single(["extract_lr_bc", "-r", str(fq), "-o", str(lr)])
    single = tmp_path / "w_single.tsv.gz"
    _run_single([
        "extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
        "-o", str(single),
    ])
    multi = tmp_path / "w_multi.tsv.gz"
    _run_hosts([
        "extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
        "-o", str(multi),
    ], 2)
    assert _gz_bytes(multi) == _gz_bytes(single)
    assert len(_gz_bytes(single)) > 0


def test_hostgroup_fs_collectives(tmp_path):
    """In-process fs-transport reductions: sum/min/max + barrier ordering."""
    import threading

    from sctagger.parallel.multihost import HostGroup

    results = {}

    def worker(h):
        g = HostGroup(h, 3, tmp_path / "sync")
        a = np.arange(5, dtype=np.int64) + h * 10
        results[h, "sum"] = g.allreduce(a, "sum")
        results[h, "min"] = g.allreduce(a, "min")
        results[h, "max"] = g.allreduce(a, "max")
        results[h, "gather"] = g.allgather_scalar(h + 7)
        g.barrier()

    ts = [threading.Thread(target=worker, args=(h,)) for h in range(3)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    base = np.arange(5, dtype=np.int64)
    for h in range(3):
        assert np.array_equal(results[h, "sum"], base * 3 + 30)
        assert np.array_equal(results[h, "min"], base)
        assert np.array_equal(results[h, "max"], base + 20)
        assert np.array_equal(results[h, "gather"], [7, 8, 9])


def test_extract_sr_bc_from_lr_multihost_extra_fields(fixtures, tmp_path):
    """Rows with >4 tab fields parse tolerantly at ANY host count:
    multi-host output must equal single-host output on such input."""
    tmp, _, wl, _ = fixtures
    rng = np.random.default_rng(7)
    bcs = [l for l in wl.read_text().splitlines()]
    rows = []
    for i in range(60):
        bc = bcs[int(rng.integers(len(bcs)))]
        seg = random_dna(rng, 4) + bc + random_dna(rng, 4)
        extra = "\textra\tfield" if i % 3 == 0 else ""
        loc = "NA" if i % 11 == 0 else str(int(rng.integers(0, 50)))
        rows.append(f"r{i}\t1\t{loc}\t{seg}{extra}\n")
    lr = tmp_path / "extra.tsv"
    lr.write_text("".join(rows))
    single = tmp_path / "x_single.tsv.gz"
    _run_single([
        "extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
        "-o", str(single),
    ])
    multi = tmp_path / "x_multi.tsv.gz"
    _run_hosts([
        "extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
        "-o", str(multi),
    ], 2)
    assert _gz_bytes(multi) == _gz_bytes(single)
    assert len(_gz_bytes(single)) > 0


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_extract_sr_bc_multihost(fixtures, tmp_path, n_hosts):
    """Sharded BAM scan (spill chain + first-appearance merge) must write
    byte-identical output to the single-host run."""
    from bamgen import write_bam

    rng = np.random.default_rng(55)
    pool = [random_dna(rng, 16) for _ in range(50)]
    contigs = ["c1", "c2"]
    alns = {c: [] for c in contigs}
    for i in range(6000):
        c = contigs[i % 2]
        flag = int(rng.choice([0, 16, 272], p=[0.5, 0.4, 0.1]))
        tags = [["CB", pool[int(rng.integers(50))] + "-1"]]
        alns[c].append({
            "flag": flag, "name": f"q{i}", "pos": i, "tags": tags,
            "seq": random_dna(rng, 20),
        })
    bam = str(tmp_path / "mh.bam")
    write_bam(bam, contigs, alns)

    single = tmp_path / "sr_single.tsv.gz"
    _run_single(["extract_sr_bc", "-i", bam, "-o", str(single)])
    multi = tmp_path / f"sr_multi{n_hosts}.tsv.gz"
    _run_hosts(["extract_sr_bc", "-i", bam, "-o", str(multi)], n_hosts)
    assert _gz_bytes(multi) == _gz_bytes(single)
    assert len(_gz_bytes(single)) > 0


def test_extract_sr_bc_multihost_scans_overlap(fixtures, tmp_path):
    """The stage-2 shard scans must run CONCURRENTLY: the
    self-sync protocol lets host 1 inflate+parse WITHOUT any host-0
    information. Deterministic proof (immune to process-startup skew and
    scan speed): launch host 1 ALONE and require its scan window blob
    (scanwin.h1, published right after its scan completes, before the spill
    reconcile) to appear while host 0 has not even started — under the old
    blocking protocol host 1 could not scan before host 0 published its
    spill. Then launch host 0 and check the merged output is still
    byte-identical to the single-host run."""
    import json
    import time

    from bamgen import write_bam

    rng = np.random.default_rng(56)
    pool = [random_dna(rng, 16) for _ in range(80)]
    alns = {"c1": [
        {"flag": 0, "name": f"q{i}", "pos": i,
         "tags": [["CB", pool[int(rng.integers(80))] + "-1"]],
         "seq": random_dna(rng, 150)}
        for i in range(20000)
    ]}
    bam = str(tmp_path / "big_overlap.bam")
    write_bam(bam, ["c1"], alns)

    single = tmp_path / "sr_overlap_single.tsv.gz"
    _run_single(["extract_sr_bc", "-i", bam, "-o", str(single)])

    out = tmp_path / "sr_overlap.tsv.gz"
    argv = ["extract_sr_bc", "-i", bam, "-o", str(out), "--n-hosts", "2"]
    p1 = subprocess.Popen(
        [sys.executable, "-m", "sctagger", *argv, "--host-id", "1"],
        env=_cli_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )
    # host 1 must complete its scan with host 0 not yet launched
    deadline = time.monotonic() + 120
    blob = None
    while time.monotonic() < deadline:
        hits = list(tmp_path.glob("sr_overlap.tsv.gz.sync-*/scanwin.h1.blob"))
        if hits:
            blob = hits[0]
            break
        if p1.poll() is not None:
            break
        time.sleep(0.05)
    assert blob is not None, (
        "host 1 never published its scan window while running alone: "
        + (p1.communicate()[1] or "")[-2000:]
    )
    win = json.loads(blob.read_bytes())
    assert win[1] >= win[0]  # a real (start, end) scan window

    p0 = subprocess.Popen(
        [sys.executable, "-m", "sctagger", *argv, "--host-id", "0"],
        env=_cli_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )
    errs = [p.communicate(timeout=240)[1] for p in (p0, p1)]
    assert [p0.returncode, p1.returncode] == [0, 0], "\n".join(errs)[-3000:]
    assert _gz_bytes(out) == _gz_bytes(single)
