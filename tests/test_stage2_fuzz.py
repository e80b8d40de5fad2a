"""Adversarial multi-round fuzz of extract_sr_bc vs the real reference
(JSON-backed pysam stub), byte-equality of the gzip TSV per round.

Randomizes what the fixed golden test holds constant: flag values
(--step-size, --thresh, --max-barcode-cnt), contig count/skew, and —
the SURVEY §7 parity hazard — large groups of EQUAL-COUNT barcodes
straddling the elbow cutoff (the reference's order among equal counts is
arrival order, deterministic at -t 1; ours must reproduce it).

Default 3 rounds; SCTAG_FUZZ_ROUNDS scales it up for nightly-style runs.
"""

import gzip
import os

import numpy as np
import pytest

from sctagger.cli import main as cli_main

from bamgen import write_bam
from oracle import random_dna
from refharness import run_reference

ROUNDS = int(os.environ.get("SCTAG_FUZZ_ROUNDS", "3"))


def _make_tie_heavy_bam(tmp_path, rng):
    n_contigs = int(rng.integers(1, 6))
    contigs = [f"chr{i+1}" for i in range(n_contigs)]

    # count plan: a few distinct count VALUES shared by many barcodes each,
    # so ties cross every step boundary; plus a long tail of count-1s
    n_groups = int(rng.integers(2, 5))
    group_counts = sorted(
        rng.choice(np.arange(2, 40), size=n_groups, replace=False).tolist(),
        reverse=True,
    )
    plan: list[tuple[str, int]] = []
    seen: set[str] = set()

    def fresh_bc() -> str:
        while True:
            b = random_dna(rng, 16)
            if b not in seen:
                seen.add(b)
                return b

    for c in group_counts:
        for _ in range(int(rng.integers(3, 9))):
            plan.append((fresh_bc(), c))
    for _ in range(int(rng.integers(5, 30))):
        plan.append((fresh_bc(), 1))

    alns = {c: [] for c in contigs}
    i = 0
    for bc, cnt in plan:
        for _ in range(cnt):
            c = contigs[int(rng.integers(n_contigs))]
            r = rng.random()
            if r < 0.04:
                flag = int(rng.choice([272, 1024, 2048]))  # dropped (>256)
            elif r < 0.07:
                flag = 256  # kept: reference drops only flag > 256
            else:
                flag = int(rng.choice([0, 16, 99, 147]))
            tags = [["NM", 1]]
            r2 = rng.random()
            if r2 < 0.04:
                pass  # no CB tag at all
            elif r2 < 0.07:
                tags.append(["CB", "NA"])
            else:
                suffix = "-1" if rng.random() < 0.8 else ""
                tags.append(["CB", bc + suffix])
            alns[c].append(
                {"flag": flag, "name": f"q{i}", "pos": i % 997, "tags": tags,
                 "seq": random_dna(rng, int(rng.integers(0, 6)) * 2)}
            )
            i += 1
    # shuffle within each contig: arrival order is per-contig scan order
    for c in contigs:
        rng.shuffle(alns[c])
    path = str(tmp_path / "fuzz.bam")
    write_bam(path, contigs, alns)
    return path


@pytest.mark.parametrize("round_i", range(ROUNDS))
def test_stage2_fuzz_parity(tmp_path, round_i):
    rng = np.random.default_rng(9100 + round_i)
    bam = _make_tie_heavy_bam(tmp_path, rng)

    step = int(rng.choice([1, 5, 25, 1000]))
    thresh = float(rng.choice([0.001, 0.005, 0.05, 0.5]))
    cap = int(rng.choice([10, 100, 25000]))
    args = ["-i", bam, "-t", "1", "--step-size", str(step),
            "--thresh", str(thresh), "--max-barcode-cnt", str(cap)]

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_sr_bc", *args, "-o", str(ref_out)],
        tmp_path,
        functional_pysam=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(["extract_sr_bc", *args, "-o", str(our_out)])

    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )
