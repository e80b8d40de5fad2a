"""Edge cases: custom adapters, gzipped flag, empty inputs, plots."""

import gzip

import numpy as np

from sctagger.cli import main as cli_main

from oracle import mutate, random_dna
from refharness import run_reference


def test_custom_short_adapter_golden(tmp_path):
    """-sa with a non-default (10 bp) adapter, exercising m != 22 everywhere
    (Peq width, SHW window 2m, histogram)."""
    rng = np.random.default_rng(70)
    adapter = "ACGTTGCAGT"
    from sctagger.core import rev_compl

    lines = []
    for i in range(80):
        n = int(rng.integers(60, 150))
        t = random_dna(rng, n)
        r = rng.random()
        if r < 0.4:
            pos = int(rng.integers(0, 15))
            t = t[:pos] + mutate(rng, adapter, int(rng.integers(0, 2))) + t[pos:]
        elif r < 0.8:
            pos = max(0, n - int(rng.integers(3, 18)))
            t = t[:pos] + mutate(rng, rev_compl(adapter), int(rng.integers(0, 2))) + t[pos:]
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


def test_gzipped_flag_on_plain_extension(tmp_path):
    """-z forces gzip reading even without a .gz extension."""
    rng = np.random.default_rng(71)
    lines = []
    for i in range(10):
        t = random_dna(rng, 80)
        lines.append(f"@r{i}\n{t}\n+\n{'I' * len(t)}\n")
    fq = tmp_path / "reads.fastq.data"
    fq.write_bytes(gzip.compress("".join(lines).encode()))
    out = tmp_path / "out.tsv.gz"
    cli_main(["extract_lr_bc", "-r", str(fq), "-z", "-t", "1", "-o", str(out)])
    rows = gzip.decompress(out.read_bytes()).decode().strip("\n").split("\n")
    assert len(rows) == 10


def test_match_trie_no_matches(tmp_path):
    """Segments with nothing matchable -> empty output file, no crash."""
    sr = tmp_path / "sr.tsv"
    sr.write_text("ACGTACGTACGTACGA\t5\n")
    lr = tmp_path / "lr.tsv"
    lr.write_text("r0\t-1\tNA\t\nr1\t0\t3\tTTTT\n")
    out = tmp_path / "out.tsv"
    cli_main(["match_trie", "-lr", str(lr), "-sr", str(sr), "-o", str(out)])
    assert out.read_text() == ""


def test_plots_smoke(tmp_path):
    from sctagger.plots import (
        plot_extract_lr_bc,
        plot_match_trie,
        plot_sr_bc_coverage,
    )

    p1 = tmp_path / "a.png"
    plot_extract_lr_bc(["r1", "r2", "r3"], np.array([0, -1, 2]), str(p1))
    p2 = tmp_path / "b.png"
    plot_sr_bc_coverage({10: 0.5, 20: 0.8, 30: 0.85}, 10, 20, str(p2))
    p3 = tmp_path / "c.png"
    plot_match_trie(np.array([0, 0, 1, 2]), str(p3))
    assert p1.exists() and p2.exists() and p3.exists()


def test_stage1_plotfile(tmp_path):
    rng = np.random.default_rng(72)
    lines = []
    for i in range(12):
        t = random_dna(rng, 100)
        lines.append(f"@r{i}\n{t}\n+\n{'I' * len(t)}\n")
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(lines))
    out = tmp_path / "o.tsv.gz"
    plot = tmp_path / "p.png"
    cli_main(
        ["extract_lr_bc", "-r", str(fq), "-t", "1", "-o", str(out),
         "-p", str(plot)]
    )
    assert plot.exists()


def test_match_trie_tiny_whitelist(tmp_path):
    """Whitelists smaller than the tie-slot width (regression: top_k k>n)."""
    sr = tmp_path / "sr.tsv"
    sr.write_text("AAAAAACCGGTTACGT\t5\nTTGGCCAATTGGAAAA\t3\n")
    lr = tmp_path / "lr.tsv"
    lr.write_text(
        "r0\t0\t3\tGGAAAAAACCGGTTACGTTT\n"
        "r1\t0\t3\tCCTTGGCCAATTGGAAAATT\n"
    )
    out = tmp_path / "out.tsv"
    cli_main(["match_trie", "-lr", str(lr), "-sr", str(sr), "-o", str(out)])
    rows = out.read_text().strip().split("\n")
    assert len(rows) == 2
    assert rows[0].split("\t")[4] == "AAAAAACCGGTTACGT"


def test_stage2_plotfile(tmp_path):
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from bamgen import write_bam

    rng = np.random.default_rng(73)
    pool = [random_dna(rng, 16) for _ in range(8)]
    alns = {"chr1": [
        {"flag": 0, "name": f"q{i}",
         "tags": [["CB", pool[int(rng.integers(8))] + "-1"]]}
        for i in range(200)
    ]}
    path = str(tmp_path / "p.bam")
    write_bam(path, ["chr1"], alns)
    out = tmp_path / "o.tsv.gz"
    plot = tmp_path / "p.png"
    cli_main(["extract_sr_bc", "-i", path, "--step-size", "2",
              "-o", str(out), "-p", str(plot)])
    assert plot.exists() and out.exists()


def test_hash_probe_matches_sorted_probe():
    """Open-addressing device probe vs the sorted-array binary search on
    adversarial keys: clustered sequential keys, extreme values, misses."""
    import jax.numpy as jnp
    import numpy as np

    from sctagger.ops.exact_lookup import (
        _hash_probe,
        _probe,
        build_hash_table,
    )

    rng = np.random.default_rng(8)
    # clustered keys (hash collisions via sequential values) + extremes
    keys = np.unique(
        np.concatenate([
            rng.integers(0, 2**32, size=5000, dtype=np.uint32),
            np.arange(7_000_000, 7_002_000, dtype=np.uint32),
            np.array([0, 1, 2**32 - 1, 2**32 - 2], dtype=np.uint32),
        ])
    ).astype(np.uint32)
    vals = rng.integers(-3_000_000, 3_000_000, size=keys.size).astype(np.int64)

    tk, tv = build_hash_table(keys, vals)
    queries = np.concatenate([
        keys[:: 3],
        rng.integers(0, 2**32, size=4000, dtype=np.uint32),  # mostly misses
        np.array([0, 2**32 - 1], dtype=np.uint32),
    ]).astype(np.uint32)
    qvalid = rng.random(queries.size) < 0.9

    h1, v1 = _hash_probe(
        jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(queries),
        jnp.asarray(qvalid),
    )
    h2, v2 = _probe(
        jnp.asarray(keys), jnp.asarray(vals.astype(np.int32)),
        jnp.asarray(queries), jnp.asarray(qvalid),
    )
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))


def test_hash_table_empty_and_tiny():
    import jax.numpy as jnp
    import numpy as np

    from sctagger.ops.exact_lookup import _hash_probe, build_hash_table

    tk, tv = build_hash_table(np.empty(0, np.uint32), np.empty(0, np.int64))
    h, v = _hash_probe(
        jnp.asarray(tk), jnp.asarray(tv),
        jnp.asarray(np.array([5, 9], np.uint32)),
        jnp.asarray(np.array([True, True])),
    )
    assert not np.asarray(h).any()

    tk, tv = build_hash_table(
        np.array([42], np.uint32), np.array([-7], np.int64)
    )
    h, v = _hash_probe(
        jnp.asarray(tk), jnp.asarray(tv),
        jnp.asarray(np.array([42, 43], np.uint32)),
        jnp.asarray(np.array([True, True])),
    )
    assert np.asarray(h).tolist() == [True, False]
    assert np.asarray(v)[0] == -7


def test_sortjoin_probe_matches_sorted_probe():
    """Sort-join (opt-in probe) vs binary search, incl. queries below/above the
    whole table range and 2-D query shapes."""
    import jax.numpy as jnp
    import numpy as np

    from sctagger.ops.exact_lookup import _probe, _sortjoin_probe

    rng = np.random.default_rng(21)
    keys = np.unique(
        rng.integers(100, 2**32 - 100, size=4000, dtype=np.uint32)
    ).astype(np.uint32)
    vals = rng.integers(-3_000_000, 3_000_000, size=keys.size).astype(np.int64)
    queries = np.concatenate([
        keys[::2],
        rng.integers(0, 2**32, size=3000, dtype=np.uint32),
        np.array([0, 1, 99, 2**32 - 1], dtype=np.uint32),  # outside range
    ]).astype(np.uint32)
    rng.shuffle(queries)
    queries = queries[: (queries.size // 4) * 4].reshape(-1, 4)  # 2-D shape
    qvalid = rng.random(queries.shape) < 0.9

    h1, v1 = _sortjoin_probe(
        jnp.asarray(keys), jnp.asarray(vals.astype(np.int32)),
        jnp.asarray(queries), jnp.asarray(qvalid),
    )
    h2, v2 = _probe(
        jnp.asarray(keys), jnp.asarray(vals.astype(np.int32)),
        jnp.asarray(queries), jnp.asarray(qvalid),
    )
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))


def test_sortjoin_probe_empty_table():
    import jax.numpy as jnp
    import numpy as np

    from sctagger.ops.exact_lookup import _sortjoin_probe

    h, v = _sortjoin_probe(
        jnp.asarray(np.empty(0, np.uint32)),
        jnp.asarray(np.empty(0, np.int32)),
        jnp.asarray(np.array([[7, 8]], np.uint32)),
        jnp.asarray(np.array([[True, True]])),
    )
    assert not np.asarray(h).any()


def test_tie_overflow_single_escalation():
    """A tie set > 2*TOPK_INIT pins the (single) escalation in _collect_ties:
    40 duplicate barcodes tie the same segment at d=0, overflowing both the
    kernel/initial top-k (TIES_K=8, TOPK_INIT=16) so k jumps straight to
    max(cnt)=40 in one pass."""
    from sctagger.models.matcher import TOPK_INIT, match_segments

    bc = "ACGTTGCAGTCAGTCA"  # 16 bp, not self-revcomp
    n_dup = 2 * TOPK_INIT + 8
    barcodes = [bc] * n_dup + [random_dna(np.random.default_rng(3), 16)
                               for _ in range(5)]
    res = match_segments([bc, "TTTTTTTTTTTTTTTT"], barcodes, max_error=0)
    row = int(np.searchsorted(res.rids, 0))
    assert res.rids[row] == 0 and res.dists[row] == 0
    ties = res.ties_of(row)
    # forward strand of every duplicate bid: pattern id 2*bid+1, ascending
    assert ties.tolist() == [2 * b + 1 for b in range(n_dup)]
    assert int(res.tie_counts[row]) == n_dup
