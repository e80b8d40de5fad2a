"""extract_sr_bc_from_lr golden parity vs the real reference (functional
ahocorasick stub)."""

import gzip

import numpy as np

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import random_dna
from refharness import run_reference


def _make_inputs(tmp_path, rng, n_wl=300, n_reads=800):
    wl = sorted({random_dna(rng, 16) for _ in range(n_wl)})
    wl_path = tmp_path / "whitelist.txt.gz"
    wl_path.write_bytes(gzip.compress(("\n".join(wl) + "\n").encode()))

    weights = 1.0 / (np.arange(len(wl)) + 1.0) ** 1.2
    weights /= weights.sum()
    rows = []
    for i in range(n_reads):
        r = rng.random()
        if r < 0.1:  # NA row: skipped by the stage
            rows.append(f"read{i}\t-1\tNA\t{random_dna(rng, 30)}")
            continue
        seg = random_dna(rng, int(rng.integers(17, 45)))
        r2 = rng.random()
        if r2 < 0.7:  # plant exactly one whitelist hit (fwd or rc)
            bc = wl[int(rng.choice(len(wl), p=weights))]
            if rng.random() < 0.5:
                bc = rev_compl(bc)
            pos = int(rng.integers(0, max(1, len(seg) - 16)))
            seg = seg[:pos] + bc + seg[pos:]
        elif r2 < 0.8:  # plant two hits => ambiguous, dropped
            b1 = wl[int(rng.integers(len(wl)))]
            b2 = wl[int(rng.integers(len(wl)))]
            seg = seg[:2] + b1 + seg[2:4] + b2 + seg[4:]
        if rng.random() < 0.05:
            p = int(rng.integers(len(seg)))
            seg = seg[:p] + "N" + seg[p + 1 :]
        rows.append(f"read{i}\t1\t5\t{seg}")
    lr_path = tmp_path / "lr.tsv"
    lr_path.write_text("\n".join(rows) + "\n")
    return wl_path, lr_path


def test_extract_sr_bc_from_lr_parity(tmp_path):
    rng = np.random.default_rng(77)
    wl, lr = _make_inputs(tmp_path, rng)

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
         "--step-size", "20", "-o", str(ref_out)],
        tmp_path,
        functional_ahocorasick=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl),
         "--step-size", "20", "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )


def test_extract_sr_bc_from_lr_palindrome_overlap(tmp_path):
    """Words that are both a forward barcode and another barcode's revcomp
    must keep the revcomp (overwritten) value."""
    rng = np.random.default_rng(3)
    b1 = random_dna(rng, 16)
    wl = [b1, rev_compl(b1), random_dna(rng, 16)]
    wl_path = tmp_path / "wl.txt"
    wl_path.write_text("\n".join(wl) + "\n")
    rows = [
        f"r0\t0\t3\tAA{b1}CC",            # hits word b1: fwd idx0 AND rc of idx1
        f"r1\t0\t3\tAA{rev_compl(b1)}CC",  # the mirror word
        f"r2\t0\t3\tAA{wl[2]}CC",
    ]
    lr = tmp_path / "lr.tsv"
    lr.write_text("\n".join(rows) + "\n")

    ref_out = tmp_path / "ref.tsv"
    run_reference(
        ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl_path),
         "-o", str(ref_out)],
        tmp_path,
        functional_ahocorasick=True,
    )
    our_out = tmp_path / "ours.tsv"
    cli_main(
        ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl_path),
         "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )
