"""Structured stage stats (SCTAG_STATS) smoke test."""

import json

import numpy as np

from sctagger.cli import main as cli_main

from oracle import random_dna


def test_stats_file(tmp_path, monkeypatch):
    stats_path = tmp_path / "stats.jsonl"
    monkeypatch.setenv("SCTAG_STATS", str(stats_path))

    rng = np.random.default_rng(0)
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{random_dna(rng, 16)}\t5\n" for _ in range(10)))
    lr = tmp_path / "lr.tsv"
    lr.write_text("".join(f"r{i}\t0\t3\t{random_dna(rng, 24)}\n" for i in range(20)))
    out = tmp_path / "out.tsv"
    cli_main(["match_trie", "-lr", str(lr), "-sr", str(sr), "-o", str(out)])

    records = [json.loads(l) for l in stats_path.read_text().splitlines()]
    assert len(records) == 1
    rec = records[0]
    assert rec["stage"] == "match_trie"
    assert rec["counters"]["reads"] == 20
    assert rec["counters"]["barcodes"] == 10
    assert "match" in rec["timers_s"]
    assert rec["wall_s"] >= 0
