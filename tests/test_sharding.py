"""Multi-host input sharding: per-host shards must reassemble to the
single-stream parse exactly, for any host count."""

import gzip

import numpy as np
import pytest

from sctagger.io.fastq import read_fastqs
from sctagger.io.sharding import (
    fastq_record_counts,
    read_fastq_shard,
    shard_ranges,
)

from oracle import random_dna


def _write_fastqs(tmp_path, rng):
    paths = []
    for fi, n_reads in enumerate([13, 1, 0, 27]):
        lines = []
        for i in range(n_reads):
            s = random_dna(rng, int(rng.integers(20, 60)))
            lines.append(f"@f{fi}r{i} comment\n{s}\n+\n{'I' * len(s)}\n")
        p = tmp_path / f"part{fi}.fastq" if fi % 2 == 0 else tmp_path / f"part{fi}.fastq.gz"
        data = "".join(lines)
        if str(p).endswith(".gz"):
            p.write_bytes(gzip.compress(data.encode()))
        else:
            p.write_text(data)
        paths.append(str(p))
    return paths


def test_shard_ranges_cover():
    rs = shard_ranges(10, 3)
    assert rs == [(0, 4), (4, 7), (7, 10)]
    assert shard_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_fastq_shards_reassemble(tmp_path, n_hosts):
    rng = np.random.default_rng(0)
    paths = _write_fastqs(tmp_path, rng)
    ref_names, ref_seqs = read_fastqs(paths, gzipped=False, quiet=True)
    counts = fastq_record_counts(paths)
    assert sum(counts) == len(ref_names)

    all_names, all_seqs = [], []
    expected_start = 0
    for h in range(n_hosts):
        start, names, seqs = read_fastq_shard(paths, h, n_hosts, counts=counts)
        assert start == expected_start
        expected_start += len(names)
        all_names.extend(names)
        all_seqs.extend(seqs)
    assert all_names == ref_names
    assert all_seqs == ref_seqs
