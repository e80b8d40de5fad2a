"""End-to-end pipeline runner test (LR-only path: extract_lr_bc ->
extract_sr_bc_from_lr -> match_trie) with resume behavior."""

import gzip
import time

import numpy as np
import yaml

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _make_sample(tmp_path, rng, n_reads=120, n_wl=200):
    wl = sorted({random_dna(rng, 16) for _ in range(n_wl)})
    wl_path = tmp_path / "wl.txt.gz"
    wl_path.write_bytes(gzip.compress(("\n".join(wl) + "\n").encode()))

    lines = []
    for i in range(n_reads):
        barcode = wl[int(rng.integers(len(wl)))]
        # read = prefix + adapter + barcode + tail (forward orientation)
        seq = (
            random_dna(rng, int(rng.integers(3, 10)))
            + mutate(rng, ADAPTER, int(rng.integers(0, 2)))
            + barcode
            + random_dna(rng, int(rng.integers(30, 80)))
        )
        if rng.random() < 0.4:  # reverse strand reads
            seq = rev_compl(seq)
        lines.append(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp_path / "lr.fastq"
    fq.write_text("".join(lines))
    return fq, wl_path


def test_pipeline_lr_only(tmp_path):
    rng = np.random.default_rng(9)
    fq, wl = _make_sample(tmp_path, rng)
    cfg = {
        "outpath": str(tmp_path / "out"),
        "exec": {"scTagger": "unused"},
        "samples": {
            "s1": {
                "ref": "hs",
                "whiltlist": str(wl),
                "lr_fastqs": [str(fq)],
                "sr": {"I1": "x", "R1": "x", "R2": "x", "dir": ".",
                       "prefix": "p", "cell_count": 10},
            }
        },
        "references": {"hs": {"cellranger_ref": "unused"}},
    }
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    cli_main(["pipeline", "-c", str(cfg_path), "--from-lr-only", "-t", "1"])

    out = tmp_path / "out" / "s1"
    lr_tsv = out / "s1.lr_bc.tsv.gz"
    sr_tsv = out / "s1.sr_bc_from_lr.tsv.gz"
    matches = out / "s1.lr_bc_from_lr_matches.tsv.gz"
    assert lr_tsv.exists() and sr_tsv.exists() and matches.exists()

    rows = gzip.decompress(matches.read_bytes()).decode().strip().split("\n")
    assert len(rows) > 0
    for row in rows:
        cols = row.split("\t")
        assert len(cols) == 5
        assert int(cols[1]) <= 2

    # resume: nothing should rerun (mtimes unchanged)
    mtimes = {p: p.stat().st_mtime for p in (lr_tsv, sr_tsv, matches)}
    time.sleep(0.05)
    cli_main(["pipeline", "-c", str(cfg_path), "--from-lr-only", "-t", "1"])
    for p, t in mtimes.items():
        assert p.stat().st_mtime == t, f"{p} was rerun"
