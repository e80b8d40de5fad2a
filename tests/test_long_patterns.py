"""Long adapters (>32 bp) and long barcodes (>32 bp) via multi-word Myers:
golden parity with the reference on both stages."""

import gzip

import numpy as np

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import mutate, random_dna
from refharness import run_reference


def test_long_adapter_golden(tmp_path):
    rng = np.random.default_rng(80)
    adapter = random_dna(rng, 45)
    lines = []
    for i in range(60):
        n = int(rng.integers(120, 260))
        t = random_dna(rng, n)
        r = rng.random()
        if r < 0.4:
            pos = int(rng.integers(0, 20))
            t = t[:pos] + mutate(rng, adapter, int(rng.integers(0, 4))) + t[pos:]
        elif r < 0.8:
            pos = max(0, n - int(rng.integers(5, 25)))
            t = t[:pos] + mutate(rng, rev_compl(adapter), int(rng.integers(0, 4))) + t[pos:]
        lines.append(f"@r{i}\n{t}\n+\n{'I' * len(t)}\n")
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(lines))

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_lr_bc", "-r", str(fq), "-sa", adapter, "-t", "1",
         "-o", str(ref_out)],
        tmp_path,
        functional_edlib=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["extract_lr_bc", "-r", str(fq), "-sa", adapter, "-t", "1",
         "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )


def test_long_barcode_match_trie_golden(tmp_path):
    rng = np.random.default_rng(81)
    bl = 40
    barcodes = sorted({random_dna(rng, bl) for _ in range(25)})
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{b}\t9\n" for b in barcodes))
    rows = []
    for i in range(50):
        seg = random_dna(rng, int(rng.integers(bl, bl + 25)))
        if rng.random() < 0.7:
            bc = barcodes[int(rng.integers(len(barcodes)))]
            if rng.random() < 0.5:
                bc = rev_compl(bc)
            bc = mutate(rng, bc, int(rng.integers(0, 4)))
            pos = int(rng.integers(0, 5))
            seg = seg[:pos] + bc + seg[pos:]
        rows.append(f"r{i}\t0\t3\t{seg}")
    lr = tmp_path / "lr.tsv"
    lr.write_text("\n".join(rows) + "\n")

    ref_out = tmp_path / "ref.tsv"
    run_reference(
        ["match_trie", "-lr", str(lr), "-sr", str(sr), "-bl", str(bl),
         "-mr", "3", "-t", "1", "-o", str(ref_out)],
        tmp_path,
    )
    our_out = tmp_path / "ours.tsv"
    cli_main(
        ["match_trie", "-lr", str(lr), "-sr", str(sr), "-bl", str(bl),
         "-mr", "3", "-t", "1", "-o", str(our_out)]
    )
    assert our_out.read_text() == ref_out.read_text()
