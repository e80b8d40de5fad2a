"""Property fuzz of the WHOLE stage-1 surface vs the real reference script.

Adversarial read population: empty reads, reads shorter than the adapter,
adapters hugging both read boundaries, multiple planted adapters per read
(multi-location argmin sets + fwd/rc distance ties), N/lowercase junk, and
homopolymers. Byte-equality of the full TSV is asserted per round.

Default is 3 rounds to keep the suite fast; set SCTAG_FUZZ_ROUNDS for a
nightly-style long run (each round is a fresh seed and a fresh reference
subprocess).
"""

import gzip
import os
import pathlib

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import mutate, random_dna
from refharness import run_reference

ADAPTER = "CTACACGACGCTCTTCCGATCT"
ROUNDS = int(os.environ.get("SCTAG_FUZZ_ROUNDS", "3"))


def _adversarial_fastq(path: pathlib.Path, rng, n_reads: int) -> None:
    lines = []
    for i in range(n_reads):
        kind = rng.random()
        if kind < 0.04:
            seq = ""  # empty read
        elif kind < 0.08:
            seq = random_dna(rng, int(rng.integers(1, len(ADAPTER))))
        elif kind < 0.18:
            # multiple adapters (same or opposite strands) => ties/multi-locs
            seq = random_dna(rng, int(rng.integers(10, 40)))
            for _ in range(int(rng.integers(2, 4))):
                ad = ADAPTER if rng.random() < 0.5 else rev_compl(ADAPTER)
                ad = mutate(rng, ad, int(rng.integers(0, 3)))
                p = int(rng.integers(0, len(seq) + 1))
                seq = seq[:p] + ad + seq[p:]
        elif kind < 0.28:
            # adapter exactly at a boundary
            ad = mutate(rng, ADAPTER, int(rng.integers(0, 4)))
            if rng.random() < 0.5:
                ad = rev_compl(ad)
            body = random_dna(rng, int(rng.integers(20, 120)))
            seq = ad + body if rng.random() < 0.5 else body + ad
        elif kind < 0.34:
            seq = "A" * int(rng.integers(30, 200))  # homopolymer
        else:
            n = int(rng.integers(40, 300))
            seq = random_dna(rng, n)
            if rng.random() < 0.75:
                ad = mutate(rng, ADAPTER, int(rng.integers(0, 5)))
                if rng.random() < 0.5:
                    ad = rev_compl(ad)
                p = int(rng.integers(0, n + 1))
                seq = seq[:p] + ad + seq[p:]
        if seq and rng.random() < 0.25:  # N / lowercase junk
            b = list(seq)
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(len(b)))
                b[p] = "N" if rng.random() < 0.7 else b[p].lower()
            seq = "".join(b)
        lines.append(f"@fz{i} c\n{seq}\n+\n{'I' * len(seq)}\n")
    path.write_text("".join(lines))


@pytest.mark.parametrize("round_i", range(ROUNDS))
def test_stage1_fuzz_parity(tmp_path, round_i):
    rng = np.random.default_rng(1000 + round_i)
    fq = tmp_path / "fuzz.fastq"
    _adversarial_fastq(fq, rng, n_reads=120)

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_lr_bc", "-r", str(fq), "-t", "1", "-o", str(ref_out)],
        tmp_path,
        functional_edlib=True,
    )
    ours = tmp_path / "ours.tsv.gz"
    cli_main(["extract_lr_bc", "-r", str(fq), "-o", str(ours)])
    a = gzip.open(ours, "rb").read()
    b = gzip.open(ref_out, "rb").read()
    assert a == b
