"""End-to-end golden parity: our match_trie vs the REAL reference script."""

import gzip
import pathlib

import numpy as np
import pytest

from sctagger.cli import main as cli_main

from oracle import mutate, random_dna
from refharness import run_reference


def _make_inputs(tmp_path: pathlib.Path, rng, n_barcodes=60, n_reads=120, bl=16):
    barcodes = []
    seen = set()
    while len(barcodes) < n_barcodes:
        b = random_dna(rng, bl)
        if b not in seen:
            seen.add(b)
            barcodes.append(b)
    sr_path = tmp_path / "sr.tsv"
    sr_path.write_text(
        "".join(f"{b}\t{int(rng.integers(1, 500))}\n" for b in barcodes)
    )

    lr_rows = []
    for i in range(n_reads):
        kind = rng.random()
        if kind < 0.12:  # invalid stage-1 row: empty segment
            lr_rows.append((f"read{i}", "-1", "NA", ""))
            continue
        n = int(rng.integers(18, 40))
        seg = random_dna(rng, n)
        if kind < 0.75:  # plant a (possibly revcomp, possibly mutated) barcode
            bc = barcodes[int(rng.integers(n_barcodes))]
            if rng.random() < 0.5:
                from sctagger.core import rev_compl

                bc = rev_compl(bc)
            bc = mutate(rng, bc, int(rng.integers(0, 4)))
            pos = int(rng.integers(0, max(1, len(seg) - 3)))
            seg = seg[:pos] + bc + seg[pos:]
        if rng.random() < 0.05:  # sprinkle N characters
            pos = int(rng.integers(len(seg)))
            seg = seg[:pos] + "N" + seg[pos + 1 :]
        lr_rows.append((f"read{i}", str(int(rng.integers(0, 5))), "5", seg))
    lr_path = tmp_path / "lr.tsv"
    lr_path.write_text("".join("\t".join(r) + "\n" for r in lr_rows))
    return sr_path, lr_path


@pytest.mark.parametrize("mr", [0, 1, 2, 3])
def test_match_trie_parity(tmp_path, mr):
    rng = np.random.default_rng(100 + mr)
    sr, lr = _make_inputs(tmp_path, rng)

    ref_out = tmp_path / "ref.tsv"
    run_reference(
        [
            "match_trie",
            "-lr", str(lr),
            "-sr", str(sr),
            "-mr", str(mr),
            "-t", "1",
            "-o", str(ref_out),
        ],
        tmp_path,
    )

    our_out = tmp_path / "ours.tsv"
    cli_main(
        [
            "match_trie",
            "-lr", str(lr),
            "-sr", str(sr),
            "-mr", str(mr),
            "-t", "1",
            "-o", str(our_out),
        ]
    )

    ref_text = ref_out.read_text()
    our_text = our_out.read_text()
    assert our_text == ref_text


def test_match_trie_gz_output_and_gz_inputs(tmp_path):
    rng = np.random.default_rng(7)
    sr, lr = _make_inputs(tmp_path, rng, n_barcodes=25, n_reads=40)
    # gzip both inputs (readers must auto-detect .gz)
    sr_gz = tmp_path / "sr.tsv.gz"
    lr_gz = tmp_path / "lr.tsv.gz"
    sr_gz.write_bytes(gzip.compress(sr.read_bytes()))
    lr_gz.write_bytes(gzip.compress(lr.read_bytes()))

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["match_trie", "-lr", str(lr_gz), "-sr", str(sr_gz), "-t", "1",
         "-o", str(ref_out)],
        tmp_path,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["match_trie", "-lr", str(lr_gz), "-sr", str(sr_gz), "-t", "1",
         "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )
