"""Batch-granular checkpointing: byte-identical output, batches resume."""

import gzip

import numpy as np
import pytest

import sctagger.models.adapter as adapter_mod
import sctagger.stages.match_trie as mt_mod
from sctagger.cli import main as cli_main

from oracle import mutate, random_dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _match_inputs(tmp_path, rng, n_reads=60):
    barcodes = sorted({random_dna(rng, 16) for _ in range(30)})
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{b}\t3\n" for b in barcodes))
    rows = []
    for i in range(n_reads):
        seg = random_dna(rng, 20)
        if rng.random() < 0.7:
            bc = mutate(rng, barcodes[int(rng.integers(len(barcodes)))],
                        int(rng.integers(0, 3)))
            seg = seg[:4] + bc + seg[4:]
        rows.append(f"r{i}\t0\t3\t{seg}")
    lr = tmp_path / "lr.tsv"
    lr.write_text("\n".join(rows) + "\n")
    return sr, lr


def test_match_trie_checkpoint_resume(tmp_path, monkeypatch):
    rng = np.random.default_rng(90)
    sr, lr = _match_inputs(tmp_path, rng)
    argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-t", "1"]

    # baseline without checkpointing
    base_out = tmp_path / "base.tsv"
    cli_main([*argv, "-o", str(base_out)])

    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "16")

    calls = []
    real = mt_mod.match_segments
    monkeypatch.setattr(
        mt_mod, "match_segments",
        lambda *a, **k: (calls.append(1), real(*a, **k))[1],
    )

    out1 = tmp_path / "c1.tsv"
    cli_main([*argv, "-o", str(out1)])
    assert out1.read_text() == base_out.read_text()
    n_first = len(calls)
    assert n_first == 4  # 60 reads / 16 per batch

    # delete one part: only that batch recomputes
    parts = sorted(ckpt.glob("match_trie-*/part*.tsv"))
    assert len(parts) == 4
    parts[2].unlink()
    calls.clear()
    out2 = tmp_path / "c2.tsv"
    cli_main([*argv, "-o", str(out2)])
    assert out2.read_text() == base_out.read_text()
    assert len(calls) == 1

    # fully cached: zero recomputes
    calls.clear()
    out3 = tmp_path / "c3.tsv"
    cli_main([*argv, "-o", str(out3)])
    assert out3.read_text() == base_out.read_text()
    assert len(calls) == 0


def test_match_trie_checkpoint_key_invalidation(tmp_path, monkeypatch):
    """Changing an input invalidates the part store (new key)."""
    rng = np.random.default_rng(91)
    sr, lr = _match_inputs(tmp_path, rng, n_reads=20)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-t", "1"]
    cli_main([*argv, "-o", str(tmp_path / "a.tsv")])
    dirs1 = {p.name for p in ckpt.iterdir()}
    import time

    time.sleep(1.1)  # mtime resolution
    lr.write_text(lr.read_text() + "rX\t0\t3\tACGTACGTACGTACGTAAAA\n")
    cli_main([*argv, "-o", str(tmp_path / "b.tsv")])
    dirs2 = {p.name for p in ckpt.iterdir()}
    assert dirs2 - dirs1, "expected a fresh part store for changed input"


def test_match_trie_checkpoint_batch_change_invalidation(tmp_path, monkeypatch):
    """Changing SCTAG_CHECKPOINT_BATCH re-keys the part store: a resume with
    a different batch size must never reuse parts whose row spans no longer
    match the new span geometry."""
    rng = np.random.default_rng(95)
    sr, lr = _match_inputs(tmp_path, rng, n_reads=48)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-t", "1"]

    monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "16")
    out_a = tmp_path / "a.tsv"
    cli_main([*argv, "-o", str(out_a)])
    dirs1 = {p.name for p in ckpt.iterdir()}

    # same inputs, different batch: fresh store, byte-identical output
    monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "20")
    out_b = tmp_path / "b.tsv"
    cli_main([*argv, "-o", str(out_b)])
    dirs2 = {p.name for p in ckpt.iterdir()}
    assert dirs2 - dirs1, "expected a fresh part store for a new batch size"
    assert out_b.read_text() == out_a.read_text()


def test_extract_lr_bc_checkpoint_resume(tmp_path, monkeypatch):
    rng = np.random.default_rng(92)
    lines = []
    for i in range(40):
        t = random_dna(rng, int(rng.integers(80, 160)))
        if rng.random() < 0.6:
            pos = int(rng.integers(0, 15))
            t = t[:pos] + mutate(rng, ADAPTER, int(rng.integers(0, 2))) + t[pos:]
        lines.append(f"@r{i}\n{t}\n+\n{'I' * len(t)}\n")
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(lines))
    argv = ["extract_lr_bc", "-r", str(fq), "-t", "1"]

    base_out = tmp_path / "base.tsv.gz"
    cli_main([*argv, "-o", str(base_out)])

    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "16")

    calls = []
    real = adapter_mod.scan_adapters
    import sctagger.stages.extract_lr_bc as s1_mod

    monkeypatch.setattr(
        s1_mod, "scan_adapters",
        lambda *a, **k: (calls.append(1), real(*a, **k))[1],
    )

    out1 = tmp_path / "c1.tsv.gz"
    cli_main([*argv, "-o", str(out1)])
    assert gzip.decompress(out1.read_bytes()) == gzip.decompress(
        base_out.read_bytes()
    )
    assert len(calls) == 3  # 40 reads / 16

    calls.clear()
    out2 = tmp_path / "c2.tsv.gz"
    cli_main([*argv, "-o", str(out2)])
    assert gzip.decompress(out2.read_bytes()) == gzip.decompress(
        base_out.read_bytes()
    )
    assert len(calls) == 0  # fully cached scan; ranges/filter recomputed


def test_extract_sr_bc_from_lr_checkpoint_resume(tmp_path, monkeypatch):
    """Alt-stage-2 probe scan resumes at batch granularity, including a
    kill mid-scan."""
    import sctagger.ops.exact_lookup as xl_mod
    import sctagger.stages.extract_sr_bc_from_lr as alt_mod

    rng = np.random.default_rng(93)
    bcs = sorted({random_dna(rng, 16) for _ in range(25)})
    wl = tmp_path / "wl.txt"
    wl.write_text("".join(b + "\n" for b in bcs))
    rows = []
    for i in range(60):
        seg = random_dna(rng, 4) + bcs[int(rng.integers(len(bcs)))] + random_dna(rng, 4)
        rows.append(f"r{i}\t1\t5\t{seg}\n")
    lr = tmp_path / "lr.tsv"
    lr.write_text("".join(rows))
    argv = ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl)]

    base_out = tmp_path / "base.tsv.gz"
    cli_main([*argv, "-o", str(base_out)])

    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "16")

    calls = []
    real = xl_mod.probe_segments

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(alt_mod, "probe_segments", counting)

    # killed mid-scan: the 3rd batch raises; 2 parts survive on disk
    def dying(*a, **k):
        if len(calls) >= 2:
            raise KeyboardInterrupt("killed mid-scan")
        return counting(*a, **k)

    monkeypatch.setattr(alt_mod, "probe_segments", dying)
    with pytest.raises(KeyboardInterrupt):
        cli_main([*argv, "-o", str(tmp_path / "dead.tsv.gz")])
    assert len(list(ckpt.glob("extract_sr_bc_from_lr_scan-*/part*.npz"))) == 2

    # resume: only the remaining 2 of 4 batches recompute; output identical
    calls.clear()
    monkeypatch.setattr(alt_mod, "probe_segments", counting)
    out1 = tmp_path / "c1.tsv.gz"
    cli_main([*argv, "-o", str(out1)])
    assert len(calls) == 2
    assert gzip.open(out1, "rb").read() == gzip.open(base_out, "rb").read()

    # fully cached: zero probes
    calls.clear()
    out2 = tmp_path / "c2.tsv.gz"
    cli_main([*argv, "-o", str(out2)])
    assert len(calls) == 0
    assert gzip.open(out2, "rb").read() == gzip.open(base_out, "rb").read()


def test_extract_sr_bc_checkpoint_resume(tmp_path, monkeypatch):
    """Stage-2 BAM scan resumes at compressed-byte-range granularity,
    including a kill mid-scan."""
    import sctagger.stages.extract_sr_bc as s2_mod
    from test_stage2_golden import _make_bam

    rng = np.random.default_rng(94)
    path, *_ = _make_bam(tmp_path, rng, n_alns=4000)

    argv = ["extract_sr_bc", "-i", path, "-t", "1"]
    base_out = tmp_path / "base.tsv.gz"
    cli_main([*argv, "-o", str(base_out)])

    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    # ~4 batches on a tiny synthetic BAM
    import os

    batch = max(1, os.path.getsize(path) // 4)
    monkeypatch.setenv("SCTAG_SR_BATCH_BYTES", str(batch))

    calls = []
    real = s2_mod.extract_cb_counts_range

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    # killed mid-scan: the 3rd batch raises; 2 parts survive on disk
    def dying(*a, **k):
        if len(calls) >= 2:
            raise KeyboardInterrupt("killed mid-scan")
        return counting(*a, **k)

    monkeypatch.setattr(s2_mod, "extract_cb_counts_range", dying)
    with pytest.raises(KeyboardInterrupt):
        cli_main([*argv, "-o", str(tmp_path / "dead.tsv.gz")])
    n_parts = len(list(ckpt.glob("extract_sr_bc-*/part*.npz")))
    assert n_parts == 2

    # resume: only the remaining batches recompute; output byte-identical
    calls.clear()
    monkeypatch.setattr(s2_mod, "extract_cb_counts_range", counting)
    out1 = tmp_path / "c1.tsv.gz"
    cli_main([*argv, "-o", str(out1)])
    n_batches = n_parts + len(calls)
    assert len(calls) == n_batches - 2 and n_batches >= 4
    assert gzip.open(out1, "rb").read() == gzip.open(base_out, "rb").read()

    # fully cached: zero range scans
    calls.clear()
    out2 = tmp_path / "c2.tsv.gz"
    cli_main([*argv, "-o", str(out2)])
    assert len(calls) == 0
    assert gzip.open(out2, "rb").read() == gzip.open(base_out, "rb").read()
