#!/usr/bin/env python3
"""Measure the reference's per-stage throughput ON THIS HOST.

The reference repo publishes no benchmark numbers (BASELINE.md), so bench.py
compares against locally measured reference rates. This tool runs the ACTUAL
reference script (/root/reference/scTagger.py) per stage on synthetic
fixtures and records rates in REF_MEASURED.json:

  match  pure-Python trie flagship (scTagger.py:643-716) — no native deps.
  lr     adapter scan driven by the NATIVE C++ Myers aligner
         (tools/refbench.cpp) standing in for edlib — same performance
         class, so the baseline is honest.
  alt    whitelist recovery driven by the NATIVE C++ Aho-Corasick automaton
         standing in for pyahocorasick.
  sr     BAM barcode extraction with the BAM-DECODING pysam stub: BGZF
         inflate via zlib (C speed, same bound as htslib) + a Python record
         walk. The stub's per-record cost is a few x real pysam's C record
         objects, so the measured rate UNDERSTATES real pysam; the JSON also
         records the raw single-stream inflate rate of the fixture — the
         htslib-class speed-of-light — and bench.py compares against that
         bound, not the stub walk.

Usage:
    python tools/measure_reference.py all            # every stage, defaults
    python tools/measure_reference.py match -n 20000 -t 1
    python tools/measure_reference.py lr -n 20000 --read-len 2000
"""

from __future__ import annotations

import argparse
import gzip
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

OUT_JSON = REPO / "REF_MEASURED.json"
ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _run_ref(args, stub_dir, timeout=7200):
    from refharness import REFERENCE

    env = dict(os.environ)
    env["PYTHONPATH"] = str(stub_dir)
    env["MPLBACKEND"] = "Agg"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, REFERENCE, *args],
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    return dt


def _record(stage: str, entry: dict) -> None:
    data = {}
    if OUT_JSON.exists():
        data = json.loads(OUT_JSON.read_text())
    entry["date"] = time.strftime("%Y-%m-%d")
    data[stage] = entry
    OUT_JSON.write_text(json.dumps(data, indent=1) + "\n")
    print(f"[{stage}] {json.dumps(entry)}")


# ---------------------------------------------------------------------------
# match (flagship)
# ---------------------------------------------------------------------------


def measure_match(n_segs: int, threads: int) -> None:
    from bench import make_inputs
    from refharness import make_stub_dir

    segs, barcodes = make_inputs(n_segs)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_refbench_"))
    (tmp / "sr.tsv").write_text("".join(f"{b}\t10\n" for b in barcodes))
    (tmp / "lr.tsv").write_text(
        "".join(f"read{i}\t0\t5\t{s}\n" for i, s in enumerate(segs))
    )
    stub = make_stub_dir(tmp)
    dt = _run_ref(
        ["match_trie", "-lr", str(tmp / "lr.tsv"), "-sr", str(tmp / "sr.tsv"),
         "-mr", "2", "-t", str(threads), "-o", str(tmp / "out.tsv")],
        stub,
    )
    _record("match", {
        "value": round(n_segs / dt, 2),
        "unit": "segments/s",
        "threads": threads,
        "n_segments": n_segs,
        "n_barcodes": 25_000,
        "wall_s": round(dt, 1),
    })


# ---------------------------------------------------------------------------
# lr (stage 1, native edlib-class aligner)
# ---------------------------------------------------------------------------


def make_lr_fastq(path: pathlib.Path, n_reads: int, read_len: int,
                  seed: int = 42, err_rate: float = 0.0) -> int:
    """Shared stage-1 fixture (also used by tools/bench_stages.py so both
    sides measure the SAME workload). Returns total bp.

    ``err_rate`` applies per-base substitutions to the planted adapter (the
    default 0.0 keeps the historical fixture: adapters verbatim, so the
    host d0 prefilter resolves ~100% — record the err_rate>0 rows alongside
    for an honest device-path picture; 0.01 ~ Q20 reads => ~80% exact)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    total_bp = 0
    with open(path, "w") as f:
        for i in range(n_reads):
            L = int(rng.integers(read_len // 2, read_len * 3 // 2))
            body = alpha[rng.integers(0, 4, size=L)].tobytes().decode()
            pos = int(rng.integers(0, 20))
            ad = ADAPTER
            if err_rate > 0.0:
                b = bytearray(ad.encode())
                for p in np.flatnonzero(rng.random(len(b)) < err_rate):
                    b[p] = int(alpha[rng.integers(0, 4)])
                ad = b.decode()
            seq = body[:pos] + ad + body[pos:]
            total_bp += len(seq)
            f.write(f"@r{i} x\n{seq}\n+\n{'I' * len(seq)}\n")
    return total_bp


def measure_lr(n_reads: int, read_len: int, threads: int) -> None:
    from refharness import make_stub_dir

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_reflr_"))
    total_bp = make_lr_fastq(tmp / "reads.fastq", n_reads, read_len)
    stub = make_stub_dir(tmp, native_edlib=True)
    dt = _run_ref(
        ["extract_lr_bc", "-r", str(tmp / "reads.fastq"),
         "-o", str(tmp / "lr.tsv"), "-t", str(threads)],
        stub,
    )
    _record("lr", {
        "value": round(n_reads / dt, 2),
        "unit": "reads/s",
        "mbp_per_s": round(total_bp / dt / 1e6, 2),
        "threads": threads,
        "n_reads": n_reads,
        "mean_read_len": round(total_bp / n_reads),
        "wall_s": round(dt, 1),
        "note": "reference driven by the C++ Myers aligner "
                "(tools/refbench.cpp) standing in for edlib",
    })


# ---------------------------------------------------------------------------
# alt (stage 2alt, native Aho-Corasick)
# ---------------------------------------------------------------------------


def make_alt_fixture(tmp: pathlib.Path, n_rows: int, n_whitelist: int,
                     seed: int = 43) -> int:
    """Shared alt-stage-2 fixture (also used by tools/bench_stages.py).
    Writes wl.txt.gz + lr.tsv; returns actual whitelist size."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    def dna(n):
        return alpha[rng.integers(0, 4, size=n)].tobytes().decode()

    wl = sorted({dna(16) for _ in range(n_whitelist)})
    with gzip.open(tmp / "wl.txt.gz", "wt") as f:
        f.write("".join(b + "\n" for b in wl))
    with open(tmp / "lr.tsv", "w") as f:
        for i in range(n_rows):
            seg = dna(4) + wl[int(rng.integers(len(wl)))] + dna(4)
            f.write(f"r{i}\t1\t5\t{seg}\n")
    return len(wl)


def measure_alt(n_rows: int, n_whitelist: int) -> None:
    from refharness import make_stub_dir

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_refalt_"))
    n_wl = make_alt_fixture(tmp, n_rows, n_whitelist)
    stub = make_stub_dir(tmp, native_ahocorasick=True)
    dt = _run_ref(
        ["extract_sr_bc_from_lr", "-i", str(tmp / "lr.tsv"),
         "-wl", str(tmp / "wl.txt.gz"), "-o", str(tmp / "out.tsv.gz")],
        stub,
    )
    _record("alt", {
        "value": round(n_rows / dt, 2),
        "unit": "rows/s",
        "n_rows": n_rows,
        "n_whitelist": n_wl,
        "wall_s": round(dt, 1),
        "note": "reference driven by the C++ Aho-Corasick automaton "
                "(tools/refbench.cpp) standing in for pyahocorasick; wall "
                "includes the automaton build (fwd+rc inserts), as in the "
                "reference",
    })


# ---------------------------------------------------------------------------
# sr (stage 2, BAM-decoding pysam stub + inflate bound)
# ---------------------------------------------------------------------------


def make_sr_bam(tmp: pathlib.Path, n_alns: int, seed: int = 44) -> str:
    import numpy as np

    from bamgen import BGZF_EOF, bam_record, bgzf_block

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = [
        alpha[rng.integers(0, 4, size=16)].tobytes().decode()
        for _ in range(2000)
    ]
    weights = 1.0 / (np.arange(len(pool)) + 1.0)
    weights /= weights.sum()
    contigs = ["chr1"]
    path = str(tmp / "sr.bam")
    import struct

    header = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 1)
    cb = b"chr1\x00"
    header += struct.pack("<i", len(cb)) + cb + struct.pack("<i", 10**6)
    # stream records straight into BGZF blocks (no whole-file byte string)
    flags = rng.choice([0, 16, 99, 147, 272, 1024], size=n_alns,
                       p=[0.3, 0.3, 0.15, 0.15, 0.05, 0.05])
    picks = rng.choice(len(pool), size=n_alns, p=weights)
    seqs = rng.integers(0, 4, size=(n_alns, 32))
    with open(path, "wb") as f:
        buf = bytearray(header)
        for i in range(n_alns):
            tags = [("NM", int(i % 5)),
                    ("CB", pool[picks[i]] + "-1")]
            buf += bam_record(
                ref_id=0, pos=i % 10**5, flag=int(flags[i]), name=f"q{i}",
                seq=alpha[seqs[i]].tobytes().decode(), tags=tags,
            )
            if len(buf) >= 60000:
                f.write(bgzf_block(bytes(buf[:60000])))
                del buf[:60000]
        while buf:
            f.write(bgzf_block(bytes(buf[:60000])))
            del buf[:60000]
        f.write(BGZF_EOF)
    with open(path + ".pysam.json", "w") as f:
        json.dump({"contigs": contigs, "stats": {"chr1": n_alns},
                   "alns": {}}, f)
    return path


def measure_sr(n_alns: int, threads: int) -> None:
    import zlib

    from refharness import make_stub_dir

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_refsr_"))
    path = make_sr_bam(tmp, n_alns)
    size_mb = os.path.getsize(path) / 1e6
    # htslib-class speed of light: single-stream BGZF inflate of this file
    raw = open(path, "rb").read()
    t0 = time.perf_counter()
    import struct as _s

    i, inflated = 0, 0
    while i < len(raw):
        xlen = _s.unpack_from("<H", raw, i + 10)[0]
        bsize = None
        j, end = i + 12, i + 12 + xlen
        while j < end:
            slen = _s.unpack_from("<H", raw, j + 2)[0]
            if raw[j] == 66 and raw[j + 1] == 67:
                bsize = _s.unpack_from("<H", raw, j + 4)[0] + 1
            j += 4 + slen
        inflated += len(zlib.decompress(raw[i + 12 + xlen : i + bsize - 8], -15))
        i += bsize
    inflate_s = time.perf_counter() - t0

    stub = make_stub_dir(tmp, bam_pysam=True)
    dt = _run_ref(
        ["extract_sr_bc", "-i", path, "-o", str(tmp / "out.tsv.gz"),
         "-t", str(threads)],
        stub,
    )
    _record("sr", {
        "value": round(n_alns / dt, 2),
        "unit": "alignments/s",
        "mb_per_s": round(size_mb / dt, 2),
        "inflate_mb_per_s": round(size_mb / inflate_s, 2),
        "inflate_alns_per_s": round(n_alns / inflate_s, 2),
        "threads": threads,
        "n_alignments": n_alns,
        "bam_mb": round(size_mb, 1),
        "wall_s": round(dt, 1),
        "note": "reference driven by the BAM-decoding pysam stub (Python "
                "record walk UNDERSTATES real pysam); inflate_* is the "
                "single-stream zlib bound — the honest htslib-class "
                "speed-of-light bench.py compares against",
    })


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stage", choices=["match", "lr", "sr", "alt", "all"],
                    nargs="?", default="match")
    ap.add_argument("-n", type=int, default=None, help="workload size")
    ap.add_argument("-t", type=int, default=1, help="reference threads")
    ap.add_argument("--read-len", type=int, default=2000)
    ap.add_argument("--whitelist", type=int, default=500_000)
    a = ap.parse_args()
    if a.stage in ("match", "all"):
        measure_match(a.n or 20_000, a.t)
    if a.stage in ("lr", "all"):
        measure_lr(a.n or 20_000, a.read_len, a.t)
    if a.stage in ("sr", "all"):
        measure_sr(a.n or 2_000_000, a.t)
    if a.stage in ("alt", "all"):
        measure_alt(a.n or 1_000_000, a.whitelist)


if __name__ == "__main__":
    main()
