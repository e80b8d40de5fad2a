"""extract_sr_bc: native BAM reader unit tests + golden parity vs the real
reference (running with the JSON-backed pysam stub)."""

import gzip

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.io.bam import extract_cb_counts

from bamgen import write_bam
from oracle import random_dna
from refharness import run_reference


def _make_bam(tmp_path, rng, n_barcodes=40, n_alns=3000, n_contigs=3):
    pool = [random_dna(rng, 16) for _ in range(n_barcodes)]
    # skewed frequencies
    weights = 1.0 / (np.arange(n_barcodes) + 1.0)
    weights /= weights.sum()
    contigs = [f"chr{i+1}" for i in range(n_contigs)]
    alns = {c: [] for c in contigs}
    for i in range(n_alns):
        c = contigs[int(rng.integers(n_contigs))]
        r = rng.random()
        tags = [["NM", int(rng.integers(5))]]
        if r < 0.05:
            flag = int(rng.choice([272, 512, 1024, 2048]))  # dropped
        elif r < 0.08:
            flag = 256  # kept! (reference keeps flag == 256)
        else:
            flag = int(rng.choice([0, 16, 83, 99, 147, 163]))
        r2 = rng.random()
        if r2 < 0.05:
            pass  # no CB tag
        elif r2 < 0.08:
            tags.append(["CB", "NA"])  # counted in total, no barcode
        else:
            bc = pool[int(rng.choice(n_barcodes, p=weights))]
            suffix = "-1" if rng.random() < 0.9 else ""
            tags.append(["CB", bc + suffix])
        if rng.random() < 0.1:
            tags.append(["AS", int(rng.integers(100))])
        if rng.random() < 0.05:
            tags.append(["XA", [1, 2, 3]])  # B-array skipping
        alns[c].append(
            {"flag": flag, "name": f"q{i}", "pos": i % 1000, "tags": tags,
             "seq": random_dna(rng, int(rng.integers(0, 8)) * 2)}
        )
    path = str(tmp_path / "test.bam")
    write_bam(path, contigs, alns)
    return path, pool, contigs, alns


def test_native_reader_counts(tmp_path):
    rng = np.random.default_rng(5)
    path, pool, contigs, alns = _make_bam(tmp_path, rng, n_alns=500)
    barcodes, counts, total = extract_cb_counts(path)

    # independent python recount from the source-of-truth aln dicts
    exp_total = 0
    exp_counts: dict[str, int] = {}
    for c in contigs:
        for a in alns[c]:
            if a["flag"] > 256:
                continue
            exp_total += 1
            tags = dict((t[0], t[1]) for t in a["tags"])
            cb = str(tags.get("CB", "NA")).split("-")[0]
            if cb == "NA":
                continue
            exp_counts[cb] = exp_counts.get(cb, 0) + 1
    assert total == exp_total
    assert dict(zip(barcodes, counts.tolist())) == exp_counts
    # first-appearance ordering
    seen = []
    for c in contigs:
        for a in alns[c]:
            if a["flag"] > 256:
                continue
            tags = dict((t[0], t[1]) for t in a["tags"])
            cb = str(tags.get("CB", "NA")).split("-")[0]
            if cb != "NA" and cb not in seen:
                seen.append(cb)
    assert barcodes == seen


@pytest.mark.parametrize("step", [10, 1000])
def test_extract_sr_bc_parity(tmp_path, step):
    rng = np.random.default_rng(100 + step)
    path, *_ = _make_bam(tmp_path, rng)

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_sr_bc", "-i", path, "-t", "1", "--step-size", str(step),
         "-o", str(ref_out)],
        tmp_path,
        functional_pysam=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(
        ["extract_sr_bc", "-i", path, "-t", "1", "--step-size", str(step),
         "-o", str(our_out)]
    )
    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )


def test_bam_pysam_stub_matches_json_stub(tmp_path):
    """The BAM-DECODING pysam stub (honest baseline measurement,
    tools/measure_reference.py) drives the reference to the same output as
    the JSON-sidecar stub."""
    rng = np.random.default_rng(31)
    path, *_ = _make_bam(tmp_path, rng, n_alns=2000)
    out_a = tmp_path / "a.tsv.gz"
    out_b = tmp_path / "b.tsv.gz"
    run_reference(
        ["extract_sr_bc", "-i", path, "-o", str(out_a), "-t", "1"],
        tmp_path, functional_pysam=True,
    )
    run_reference(
        ["extract_sr_bc", "-i", path, "-o", str(out_b), "-t", "1"],
        tmp_path, bam_pysam=True,
    )
    a = gzip.open(out_a, "rb").read()
    b = gzip.open(out_b, "rb").read()
    assert a == b and len(a) > 0
