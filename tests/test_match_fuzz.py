"""Adversarial multi-round fuzz of the WHOLE match_trie surface vs the real
reference script (byte-equality of the output TSV per round).

Targets the paths plain golden tests under-exercise:
  * tie sets larger than the kernel's TIES_K slots (host escalation path):
    clusters of 10+ barcodes within edit distance <=2 of one core;
  * self-revcomp barcodes (e.g. ACGTACGT...) -> the same bid matching on
    BOTH strands at the min distance (strand tie ordering False<True);
  * rc-pair barcodes (b and rev_compl(b) both whitelisted) -> cross-bid
    strand ties;
  * duplicate barcodes (two bids, identical sequence);
  * non-default barcode lengths (bl cycles 16, 12, 20 across rounds);
  * degenerate segments: empty, all-N, shorter than bl-mr, 100+ bp with
    several planted barcodes, and exact concatenations of barcodes.

Default 3 rounds; set SCTAG_FUZZ_ROUNDS for a nightly-style long run.
"""

import os
import pathlib

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import mutate, random_dna
from refharness import run_reference

ROUNDS = int(os.environ.get("SCTAG_FUZZ_ROUNDS", "3"))
BLS = [16, 12, 20]
MRS = [2, 1, 3]


def _self_rc(bl: int) -> str:
    # (unit repeated) where unit == its own revcomp; "ACGT" works for bl%4==0,
    # "AT" for even bl
    if bl % 4 == 0:
        return "ACGT" * (bl // 4)
    assert bl % 2 == 0, bl
    return "AT" * (bl // 2)


def _make_barcodes(rng, bl: int, n_total: int) -> tuple[list[str], str]:
    seen: set[str] = set()
    bcs: list[str] = []

    def add(b: str) -> None:
        if len(b) == bl and b not in seen:
            seen.add(b)
            bcs.append(b)

    # tie cluster: substitution-only neighbors of one core (same length),
    # enough of them to overflow TIES_K=8 kernel slots
    core = random_dna(rng, bl)
    add(core)
    while len(bcs) < 12:
        b = bytearray(core.encode())
        for p in rng.choice(bl, size=int(rng.integers(1, 3)), replace=False):
            b[p] = ord(rng.choice(list("ACGT")))
        add(bytes(b).decode())

    add(_self_rc(bl))
    pair = random_dna(rng, bl)
    add(pair)
    add(rev_compl(pair))

    while len(bcs) < n_total - 1:
        add(random_dna(rng, bl))
    return bcs, core


def _make_inputs(tmp_path: pathlib.Path, rng, bl: int, mr: int,
                 n_reads: int = 90):
    bcs, core = _make_barcodes(rng, bl, n_total=45)
    # duplicate barcode: same sequence under two bids
    bcs = bcs + [bcs[0]]

    sr_path = tmp_path / "sr.tsv"
    sr_path.write_text(
        "".join(f"{b}\t{int(rng.integers(1, 100))}\n" for b in bcs)
    )

    rows = []
    for i in range(n_reads):
        kind = rng.random()
        if kind < 0.06:
            seg = ""
        elif kind < 0.12:
            seg = "N" * int(rng.integers(1, 2 * bl))
        elif kind < 0.18:
            seg = random_dna(rng, int(rng.integers(1, max(2, bl - mr))))
        elif kind < 0.30:
            # the tie-cluster core (often overflows the kernel tie slots)
            seg = (random_dna(rng, int(rng.integers(0, 5)))
                   + mutate(rng, core, int(rng.integers(0, mr + 1)))
                   + random_dna(rng, int(rng.integers(0, 5))))
        elif kind < 0.40:
            # exact concatenation of 2-4 whitelist barcodes
            k = int(rng.integers(2, 5))
            seg = "".join(bcs[int(rng.integers(len(bcs)))] for _ in range(k))
        elif kind < 0.50:
            # long segment with several planted (possibly rc) barcodes
            seg = random_dna(rng, int(rng.integers(80, 140)))
            for _ in range(int(rng.integers(2, 4))):
                b = bcs[int(rng.integers(len(bcs)))]
                if rng.random() < 0.5:
                    b = rev_compl(b)
                b = mutate(rng, b, int(rng.integers(0, mr + 2)))
                p = int(rng.integers(0, len(seg) + 1))
                seg = seg[:p] + b + seg[p:]
        else:
            seg = random_dna(rng, int(rng.integers(bl, 3 * bl)))
            if rng.random() < 0.7:
                b = bcs[int(rng.integers(len(bcs)))]
                if rng.random() < 0.5:
                    b = rev_compl(b)
                b = mutate(rng, b, int(rng.integers(0, mr + 2)))
                p = int(rng.integers(0, len(seg) + 1))
                seg = seg[:p] + b + seg[p:]
        loc = "NA" if seg == "" else str(int(rng.integers(0, 30)))
        d = "-1" if seg == "" else str(int(rng.integers(0, 5)))
        rows.append((f"read{i}", d, loc, seg))

    lr_path = tmp_path / "lr.tsv"
    lr_path.write_text("".join("\t".join(r) + "\n" for r in rows))
    return sr_path, lr_path


@pytest.mark.parametrize("round_i", range(ROUNDS))
def test_match_fuzz_parity(tmp_path, round_i, monkeypatch):
    # force BOTH host prefilter tiers on (they are default-on, but the fuzz
    # must not silently lose coverage if a runner env disables them): every
    # round exercises dist-0 and dist-1 host resolution incl. indel reads
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    monkeypatch.setenv("SCTAG_PREFILTER_D1", "1")
    rng = np.random.default_rng(7000 + round_i)
    bl = BLS[round_i % len(BLS)]
    mr = MRS[round_i % len(MRS)]
    sr, lr = _make_inputs(tmp_path, rng, bl, mr)

    args = ["-lr", str(lr), "-sr", str(sr), "-mr", str(mr),
            "-bl", str(bl), "-t", "1"]
    ref_out = tmp_path / "ref.tsv"
    run_reference(["match_trie", *args, "-o", str(ref_out)], tmp_path)
    our_out = tmp_path / "ours.tsv"
    cli_main(["match_trie", *args, "-o", str(our_out)])

    assert our_out.read_text() == ref_out.read_text()
