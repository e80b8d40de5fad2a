#!/usr/bin/env python3
"""Benchmark: LR segments matched per second on one GPU (the flagship).

Workload: mr=2, bl=16, 25K-barcode whitelist (=> 50K fwd+rc patterns),
synthetic ~24bp segments with planted barcodes — the reference match_trie
configuration. Measures the device match (host prefilter + the fused
min/ties kernel + tie escalation) via models.matcher.match_segments, end to
end excluding file I/O, after a warm-up run that compiles every shape.

Runs on the GPU only (JAX_PLATFORMS=cuda is set before JAX is imported, so
a machine without one fails). Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "segments/s", "vs_baseline": N, ...}
with the platform, device kind and the nvidia-smi card line.

vs_baseline is against the reference match_trie throughput measured on a
CPU host (REF_MEASURED.json, tools/measure_reference.py): single-thread
segments/s scaled by the reference's declared 32-thread envelope
(Snakefile:128-132) — an idealized linear-scaling 32-core CPU reference.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Reference match_trie on a CPU host: 20K segments x 25K barcodes, mr=2,
# threads=1 -> 1267.3s = 15.8 segs/s (REF_MEASURED.json).
REF_SEGS_PER_SEC_1T = 15.8
REF_THREADS = 32  # Snakefile:130 resource envelope (ideal linear scaling)


def make_inputs(n_segs: int, n_barcodes: int = 25_000, seed: int = 0,
                indels: bool | None = None):
    """Synthetic flagship workload: planted barcodes with 0-2 edits drawn
    uniformly. Default edits are SUBSTITUTION-ONLY (the historical headline
    distribution; segments stay uniformly 24bp). ``indels`` (or
    SCTAG_BENCH_INDELS=1) draws each edit uniformly from
    {substitution, deletion, insertion} instead — ragged 22-26bp segments,
    the harder distribution.
    """
    if indels is None:
        indels = os.environ.get("SCTAG_BENCH_INDELS", "0") == "1"
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    # unique barcodes
    seen = set()
    while len(seen) < n_barcodes:
        chunk = alpha[rng.integers(0, 4, size=(n_barcodes, 16))]
        for row in chunk:
            seen.add(row.tobytes())
            if len(seen) >= n_barcodes:
                break
    barcodes = [b.decode() for b in sorted(seen)]

    segs = []
    bc_idx = rng.integers(0, n_barcodes, size=n_segs)
    errs = rng.integers(0, 3, size=n_segs)
    for i in range(n_segs):
        pre = alpha[rng.integers(0, 4, size=4)].tobytes().decode()
        post = alpha[rng.integers(0, 4, size=4)].tobytes().decode()
        bc = barcodes[bc_idx[i]]
        if errs[i]:
            b = bytearray(bc.encode())
            for _ in range(errs[i]):
                op = rng.integers(0, 3) if indels else 0
                p = int(rng.integers(0, len(b)))
                if op == 0:
                    b[p] = alpha[rng.integers(0, 4)]
                elif op == 1 and len(b) > 1:
                    del b[p]
                else:
                    b.insert(p, alpha[rng.integers(0, 4)])
            bc = b.decode()
        segs.append(pre + bc + post)
    return segs, barcodes


def main():
    os.environ["JAX_PLATFORMS"] = "cuda"
    # sustained scale: 8 chunk-multiples, so chunk-count quantization and the
    # prefilter's chunk savings both amortize
    n_segs = int(os.environ.get("SCTAG_BENCH_SEGS", 1_048_576))
    from sctagger.runtime import configure_jax, device_summary

    configure_jax()
    from chip_smoke import card_line
    from sctagger.models.matcher import match_segments

    segs, barcodes = make_inputs(n_segs)

    # warmup with the full workload so every kernel shape (small + large
    # chunks) is compiled before the timed region
    match_segments(segs, barcodes, max_error=2)

    t0 = time.perf_counter()
    result = match_segments(segs, barcodes, max_error=2)
    dt = time.perf_counter() - t0

    rate = n_segs / dt
    baseline = REF_SEGS_PER_SEC_1T * REF_THREADS
    dev = device_summary()
    print(
        json.dumps(
            {
                "metric": "lr_segments_matched_per_sec",
                "value": round(rate, 1),
                "unit": "segments/s",
                "vs_baseline": round(rate / baseline, 2),
                "detail": {
                    "n_segments": n_segs,
                    "n_barcodes": len(barcodes),
                    "mr": 2,
                    "wall_s": round(dt, 3),
                    "matched": int(result.rids.size),
                    "platform": dev["platform"],
                    "device_kind": dev["kind"],
                    "card": card_line(),
                    "baseline_segs_per_sec": baseline,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
