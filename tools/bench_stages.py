#!/usr/bin/env python3
"""Measure OUR per-stage throughput with the same protocol as the reference
side (tools/measure_reference.py): identical fixtures (same generators,
sizes, seeds), full CLI walls including I/O.

Device stages (lr, alt) run the stage TWICE inside ONE process and report the
second call's wall as ``value`` (steady state): the first call pays JAX
start-up and the kernel compiles, which the reference's C extensions do not
pay and a warmed process does not repeat. The cold full-process wall is
recorded alongside as ``cold_wall_s``. Stage 2 (sr) is host C++ (no JAX).

Writes bench_out/bench_stages.json (listed in .gitignore).

Usage:
    python tools/bench_stages.py all
    python tools/bench_stages.py lr -n 50000 --read-len 2000
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "tools"))

OUT_JSON = REPO / "bench_out" / "bench_stages.json"


def _backend() -> str:
    code = ("import jax; print(jax.default_backend())")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), timeout=600,
    )
    return out.stdout.strip() or "unknown"


def _env() -> dict:
    env = dict(os.environ)
    env.pop("SCTAG_CHECKPOINT_DIR", None)
    extra = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = f"{REPO}:{extra}" if extra else str(REPO)
    return env


def _run_cli(argv: list[str], timeout: float = 7200) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sctagger", *argv],
        env=_env(), capture_output=True, text=True, timeout=timeout,
        cwd=str(REPO),
    )
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    return dt


def _run_cli_steady(argv: list[str], timeout: float = 7200,
                    out_path: str | None = None) -> tuple[float, float, dict]:
    """Run the stage twice in ONE subprocess; return (cold_wall, steady_wall,
    steady-phase PROF walls).

    cold_wall = the whole subprocess (imports + handshake + compiles + two
    stage runs); steady_wall = the second in-process stage call only. The
    second call overwrites ``out_path`` (same argv), so outputs stay valid.
    The PROF dict (sctagger.utils.misc) is cleared between the runs, so
    its keys decompose the STEADY wall (host encode vs device dispatch vs
    result sync — the transfer-floor evidence for the sustained benches).
    """
    code = (
        "import sys, time, json\n"
        "from sctagger.cli import main\n"
        "from sctagger.utils.misc import PROF\n"
        "argv = sys.argv[1:]\n"
        "main(argv)\n"
        "PROF.clear()\n"
        "t0 = time.perf_counter()\n"
        "main(argv)\n"
        "print('STEADY_S', time.perf_counter() - t0)\n"
        "print('PROF_JSON', json.dumps(PROF))\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, *argv],
        env=_env(), capture_output=True, text=True, timeout=timeout,
        cwd=str(REPO),
    )
    cold = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    steady = None
    prof: dict = {}
    for line in proc.stdout.splitlines():
        if line.startswith("STEADY_S "):
            steady = float(line.split()[1])
        elif line.startswith("PROF_JSON "):
            prof = json.loads(line[len("PROF_JSON "):])
    assert steady is not None, proc.stdout[-2000:]
    return cold, steady, prof


def _record(stage: str, entry: dict) -> None:
    data = {}
    OUT_JSON.parent.mkdir(exist_ok=True)
    if OUT_JSON.exists():
        data = json.loads(OUT_JSON.read_text())
    entry["date"] = time.strftime("%Y-%m-%d")
    data[stage] = entry
    OUT_JSON.write_text(json.dumps(data, indent=1) + "\n")
    print(f"[{stage}] {json.dumps(entry)}")


FIXTURE_CACHE = pathlib.Path("/tmp/sctag_fixture_cache")


def _cached_lr_fastq(n_reads: int, read_len: int,
                     err_rate: float = 0.0) -> tuple[pathlib.Path, int]:
    """Large stage-1 fixtures are expensive to generate (minutes at 1M
    reads); cache them by (n, len, err) across bench runs."""
    from measure_reference import make_lr_fastq

    FIXTURE_CACHE.mkdir(exist_ok=True)
    tag = "" if err_rate == 0.0 else f"_e{err_rate}"
    path = FIXTURE_CACHE / f"lr_{n_reads}_{read_len}{tag}.fastq"
    meta = path.with_suffix(".bp")
    if path.exists() and meta.exists():
        return path, int(meta.read_text())
    total_bp = make_lr_fastq(path, n_reads, read_len, err_rate=err_rate)
    meta.write_text(str(total_bp))
    return path, total_bp


def bench_lr(n_reads: int, read_len: int, stage_key: str = "lr",
             err_rate: float = 0.0) -> None:
    fq, total_bp = _cached_lr_fastq(n_reads, read_len, err_rate)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_ourlr_"))
    argv = ["extract_lr_bc", "-r", str(fq), "-o", str(tmp / "lr.tsv.gz")]
    cold, dt, prof = _run_cli_steady(argv)
    entry = {
        "value": round(n_reads / dt, 2),
        "unit": "reads/s",
        "mbp_per_s": round(total_bp / dt / 1e6, 2),
        "n_reads": n_reads,
        "mean_read_len": round(total_bp / n_reads),
        "adapter_err_rate": err_rate,
        "wall_s": round(dt, 1),
        "cold_wall_s": round(cold, 1),
        "backend": _backend(),
        # steady-wall decomposition (sums can exceed wall: sync overlaps
        # in-flight device work; encode overlaps the async dispatch queue)
        "phases_s": {k: round(v, 2) for k, v in sorted(prof.items())
                     if k.startswith(("scan.", "stage."))},
    }
    # host d0-prefilter resolution fraction (a COUNT in PROF, not seconds)
    d0 = prof.get("scan.d0_resolved_reads")
    if d0 is not None:
        entry["phases_s"].pop("scan.d0_resolved_reads", None)
        entry["d0_resolved_frac"] = round(d0 / n_reads, 4)
    d1 = prof.get("scan.d1_resolved_reads")
    if d1 is not None:  # subset of d0_resolved_frac resolved at distance 1
        entry["phases_s"].pop("scan.d1_resolved_reads", None)
        entry["d1_resolved_frac"] = round(d1 / n_reads, 4)
    _record(stage_key, entry)


def bench_sr(n_alns: int) -> None:
    from measure_reference import make_sr_bam

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_oursr_"))
    path = make_sr_bam(tmp, n_alns)
    size_mb = os.path.getsize(path) / 1e6
    # steady protocol like lr/alt: the stage is pure host C++ (no jax), but
    # interpreter start-up is a per-process cost neither side's engine owns;
    # the second in-process call times just the stage (page cache warm both
    # calls).
    cold, dt, _ = _run_cli_steady(
        ["extract_sr_bc", "-i", path, "-o", str(tmp / "out.tsv.gz"), "-t", "1"]
    )
    _record("sr", {
        "value": round(n_alns / dt, 2),
        "unit": "alignments/s",
        "mb_per_s": round(size_mb / dt, 2),
        "n_alignments": n_alns,
        "bam_mb": round(size_mb, 1),
        "wall_s": round(dt, 1),
        "cold_wall_s": round(cold, 1),
        "backend": "host-c++",
    })


def bench_alt(n_rows: int, n_whitelist: int, probe: str = "host",
              key_suffix: str = "") -> None:
    """One row per probe. The CLI default is the HOST C++ hash probe
    (cli.py marks the stage host-only unless SCTAG_PROBE=device), so the
    default row's backend is host-c++, NOT the jax backend; probe="device"
    benches the on-device binary-search kernel as a second honest entry.
    ``key_suffix`` records extra scales (e.g. "_3m" for the real 10x-sized
    ~3M-row whitelist -> ~6M fwd+rc keys, scTagger.py:793-799) without
    overwriting the default rows."""
    from measure_reference import make_alt_fixture

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_ouralt_"))
    n_wl = make_alt_fixture(tmp, n_rows, n_whitelist)
    argv = ["extract_sr_bc_from_lr", "-i", str(tmp / "lr.tsv"),
            "-wl", str(tmp / "wl.txt.gz"), "-o", str(tmp / "out.tsv.gz")]
    os.environ["SCTAG_PROBE"] = probe  # _env() snapshots os.environ
    try:
        cold, dt, _ = _run_cli_steady(argv)
    finally:
        del os.environ["SCTAG_PROBE"]
    _record(("alt" if probe == "host" else f"alt_{probe}") + key_suffix, {
        "value": round(n_rows / dt, 2),
        "unit": "rows/s",
        "n_rows": n_rows,
        "n_whitelist": n_wl,
        "wall_s": round(dt, 1),
        "cold_wall_s": round(cold, 1),
        "backend": "host-c++" if probe == "host" else _backend(),
        "probe": probe,
    })


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "stage",
        choices=["lr", "lr_sustained", "lr_sustained_q20", "sr", "alt",
                 "alt_device", "alt_3m", "alt_device_3m", "all"],
        nargs="?", default="all")
    ap.add_argument("-n", type=int, default=None)
    ap.add_argument("--read-len", type=int, default=2000)
    ap.add_argument("--whitelist", type=int, default=500_000)
    a = ap.parse_args()
    if a.stage in ("lr", "all"):
        bench_lr(a.n or 50_000, a.read_len)
    if a.stage in ("lr_sustained", "all"):
        # >=1M reads: ~30 in-flight 64M-char chunks amortize per-chunk
        # fixed costs
        bench_lr(a.n or 1_000_000, a.read_len, stage_key="lr_sustained")
    # Q20-like adapters (1% per-base substitutions): the honest device-path
    # row now that the host d0 prefilter resolves exact-adapter reads —
    # the historical fixture plants adapters VERBATIM (d0 ~ 100%)
    if a.stage == "lr_sustained_q20":
        bench_lr(a.n or 1_000_000, a.read_len,
                 stage_key="lr_sustained_q20", err_rate=0.01)
    if a.stage in ("sr", "all"):
        bench_sr(a.n or 2_000_000)
    if a.stage in ("alt", "all"):
        bench_alt(a.n or 1_000_000, a.whitelist, probe="host")
    if a.stage in ("alt_device", "all"):
        bench_alt(a.n or 1_000_000, a.whitelist, probe="device")
    # real 10x-scale whitelist (~3M rows -> ~6M keys): the device table
    # grows to ~48 MB and the binary search gains depth
    if a.stage == "alt_3m":
        bench_alt(a.n or 1_000_000, 3_000_000, probe="host",
                  key_suffix="_3m")
    if a.stage == "alt_device_3m":
        bench_alt(a.n or 1_000_000, 3_000_000, probe="device",
                  key_suffix="_3m")


if __name__ == "__main__":
    main()
