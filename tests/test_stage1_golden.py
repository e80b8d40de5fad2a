"""End-to-end golden parity for extract_lr_bc vs the REAL reference script
(running with an oracle-DP edlib substitute — see refharness.py)."""

import gzip
import pathlib

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import mutate, random_dna
from refharness import run_reference

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _make_fastq(tmp_path: pathlib.Path, rng, n_reads=150, gz=False):
    lines = []
    for i in range(n_reads):
        n = int(rng.integers(60, 280))
        seq = random_dna(rng, n)
        r = rng.random()
        if r < 0.45:  # forward adapter near the start
            pos = int(rng.integers(5, 30))
            ad = mutate(rng, ADAPTER, int(rng.integers(0, 4)))
            seq = seq[:pos] + ad + seq[pos:]
        elif r < 0.85:  # reverse-complement adapter near the end
            pos_from_end = int(rng.integers(5, 30))
            ad = mutate(rng, rev_compl(ADAPTER), int(rng.integers(0, 4)))
            cut = max(0, len(seq) - pos_from_end)
            seq = seq[:cut] + ad + seq[cut:]
        # else: no adapter
        if rng.random() < 0.1:
            p = int(rng.integers(len(seq)))
            seq = seq[:p] + "N" + seq[p + 1 :]
        lines.append(f"@read{i} extra stuff\n{seq}\n+\n{'I' * len(seq)}\n")
    data = "".join(lines)
    path = tmp_path / ("reads.fastq.gz" if gz else "reads.fastq")
    if gz:
        path.write_bytes(gzip.compress(data.encode()))
    else:
        path.write_text(data)
    return path


@pytest.mark.parametrize("preset", [None, ["f1:40", "r1:45"]])
def test_extract_lr_bc_parity(tmp_path, preset):
    rng = np.random.default_rng(21 if preset else 20)
    fq = _make_fastq(tmp_path, rng)
    extra = ["-g", *preset] if preset else []

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_lr_bc", "-r", str(fq), "-t", "1", "-o", str(ref_out), *extra],
        tmp_path,
        functional_edlib=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["extract_lr_bc", "-r", str(fq), "-t", "1", "-o", str(our_out), *extra]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )


def test_extract_lr_bc_gz_and_multifile(tmp_path):
    rng = np.random.default_rng(33)
    fq1 = _make_fastq(tmp_path, rng, n_reads=60, gz=True)
    fq2_path = tmp_path / "reads2.fastq"
    fq2 = _make_fastq(tmp_path / "sub", rng, n_reads=40) if False else None
    # second plain-text file in the same dir
    (tmp_path / "sub").mkdir(exist_ok=True)
    fq2 = _make_fastq(tmp_path / "sub", rng, n_reads=40)

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_lr_bc", "-r", str(fq1), str(fq2), "-t", "1", "-o", str(ref_out)],
        tmp_path,
        functional_edlib=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["extract_lr_bc", "-r", str(fq1), str(fq2), "-t", "1", "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )
