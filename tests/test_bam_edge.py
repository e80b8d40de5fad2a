"""Native BAM reader edge cases."""

import numpy as np
import pytest

from sctagger.io.bam import extract_cb_counts

from bamgen import write_bam


def test_empty_bam(tmp_path):
    path = str(tmp_path / "empty.bam")
    write_bam(path, ["chr1"], {"chr1": []})
    barcodes, counts, total = extract_cb_counts(path)
    assert barcodes == [] and counts.size == 0 and total == 0


def test_all_filtered(tmp_path):
    path = str(tmp_path / "f.bam")
    write_bam(
        path,
        ["chr1"],
        {"chr1": [
            {"flag": 2048, "name": "a", "tags": [["CB", "ACGT-1"]]},
            {"flag": 512, "name": "b", "tags": [["CB", "ACGT-1"]]},
        ]},
    )
    barcodes, counts, total = extract_cb_counts(path)
    assert total == 0 and barcodes == []


def test_flag_256_kept(tmp_path):
    path = str(tmp_path / "s.bam")
    write_bam(
        path,
        ["chr1"],
        {"chr1": [
            {"flag": 256, "name": "a", "tags": [["CB", "AAAA-1"]]},
            {"flag": 257, "name": "b", "tags": [["CB", "CCCC-1"]]},
        ]},
    )
    barcodes, counts, total = extract_cb_counts(path)
    # flag == 256 kept (reference `> 256` test); 257 skipped
    assert total == 1
    assert barcodes == ["AAAA"]


def test_cb_without_suffix_and_float_tags(tmp_path):
    path = str(tmp_path / "t.bam")
    write_bam(
        path,
        ["chr1"],
        {"chr1": [
            {"flag": 0, "name": "a",
             "tags": [["XF", 1.5], ["CB", "GGTT"], ["NM", 3]]},
        ]},
    )
    barcodes, counts, total = extract_cb_counts(path)
    assert barcodes == ["GGTT"] and counts.tolist() == [1] and total == 1


def test_missing_file():
    with pytest.raises(RuntimeError):
        extract_cb_counts("/nonexistent/x.bam")


def test_not_a_bam(tmp_path):
    p = tmp_path / "x.bam"
    p.write_bytes(b"this is not a bam file")
    with pytest.raises(RuntimeError):
        extract_cb_counts(str(p))


def test_crc_corruption_detected(tmp_path):
    """A flipped payload byte must surface as a zlib data-check error, not
    silently parse (gzread validates each BGZF member's CRC32)."""
    path = str(tmp_path / "crc.bam")
    write_bam(
        path,
        ["chr1"],
        {"chr1": [
            {"flag": 0, "name": f"q{i}", "tags": [["CB", "ACGTACGT-1"]]}
            for i in range(50)
        ]},
    )
    raw = bytearray(open(path, "rb").read())
    # flip one bit inside the first member's DEFLATE payload (after the
    # 18-byte BGZF header, before the trailer)
    raw[40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(RuntimeError):
        extract_cb_counts(path)


def test_missing_eof_marker_warns_but_parses(tmp_path, capfd):
    """Truncating the BGZF EOF block warns (htslib/pysam behavior) while the
    records still parse."""
    from bamgen import BGZF_EOF

    path = str(tmp_path / "noeof.bam")
    write_bam(
        path,
        ["chr1"],
        {"chr1": [{"flag": 0, "name": "a", "tags": [["CB", "GGGG-1"]]}]},
    )
    raw = open(path, "rb").read()
    assert raw.endswith(BGZF_EOF)
    open(path, "wb").write(raw[: -len(BGZF_EOF)])
    barcodes, counts, total = extract_cb_counts(path)
    assert barcodes == ["GGGG"] and total == 1
    assert "BGZF EOF marker" in capfd.readouterr().err


def test_extract_cb_range_shard_chain(tmp_path):
    """Sharded scan: chaining arbitrary byte-range shards through the spill
    handoff reproduces the full sequential scan exactly (counts, totals, and
    global first-appearance order)."""
    import numpy as np

    from sctagger.io.bam import (
        bam_file_size,
        extract_cb_counts,
        extract_cb_counts_range,
    )

    from bamgen import write_bam
    from oracle import random_dna

    rng = np.random.default_rng(77)
    pool = [random_dna(rng, 16) for _ in range(60)]
    contigs = ["c1", "c2"]
    alns = {c: [] for c in contigs}
    for i in range(8000):
        c = contigs[i % 2]
        flag = int(rng.choice([0, 16, 256, 272, 1024], p=[0.4, 0.4, 0.1, 0.05, 0.05]))
        tags = [["CB", pool[int(rng.integers(60))] + "-1"]] if rng.random() > 0.05 else []
        alns[c].append({
            "flag": flag, "name": f"q{i}", "pos": i,
            "tags": tags, "seq": random_dna(rng, 24),
        })
    path = str(tmp_path / "big.bam")
    write_bam(path, contigs, alns)

    want_bc, want_counts, want_total = extract_cb_counts(path)
    size = bam_file_size(path)
    assert size > 120_000, size  # must span several BGZF blocks

    for n_shards in (2, 3, 5):
        bounds = [size * i // n_shards for i in range(n_shards + 1)]
        skip = 0
        agg = {}
        total = 0
        kept_off = 0
        for h in range(n_shards):
            bcs, counts, firsts, t, kept, spill, _ = extract_cb_counts_range(
                path, bounds[h], bounds[h + 1], skip, parse_header=(h == 0),
            )
            total += t
            for b, c, f in zip(bcs, counts, firsts):
                g = kept_off + int(f)
                if b not in agg:
                    agg[b] = [int(c), g]
                else:
                    agg[b][0] += int(c)
                    agg[b][1] = min(agg[b][1], g)
            kept_off += kept
            skip = spill
        assert skip == 0  # last shard never spills
        assert total == want_total
        ranked = sorted(agg.items(), key=lambda kv: kv[1][1])
        assert [b for b, _ in ranked] == want_bc
        assert [v[0] for _, v in ranked] == list(want_counts)


def test_extract_cb_range_self_sync(tmp_path):
    """skip=-1 self-synchronization must discover exactly the boundary the
    spill chain dictates (found_skip == upstream spill) and return identical
    scan results — for every shard of several shardings, so boundaries land
    at varied offsets inside records."""
    import numpy as np

    from sctagger.io.bam import bam_file_size, extract_cb_counts_range

    from bamgen import write_bam
    from oracle import random_dna

    rng = np.random.default_rng(41)
    pool = [random_dna(rng, 16) for _ in range(40)]
    alns = {"c1": [
        {"flag": 0, "name": f"q{i}", "pos": i,
         "tags": [["CB", pool[int(rng.integers(40))] + "-1"]],
         "seq": random_dna(rng, int(rng.integers(20, 120)))}
        for i in range(6000)
    ]}
    path = str(tmp_path / "sync.bam")
    write_bam(path, ["c1"], alns)
    size = bam_file_size(path)

    for n_shards in (2, 4):
        bounds = [size * i // n_shards for i in range(n_shards + 1)]
        # authoritative spill chain
        spills = [0]
        chained = []
        for h in range(n_shards):
            res = extract_cb_counts_range(
                path, bounds[h], bounds[h + 1], spills[-1],
                parse_header=(h == 0),
            )
            chained.append(res)
            spills.append(res[5])
        # self-sync every non-first shard, no upstream info
        for h in range(1, n_shards):
            res = extract_cb_counts_range(
                path, bounds[h], bounds[h + 1], -1, parse_header=False
            )
            assert res[6] == spills[h], (n_shards, h)  # found == true skip
            want = chained[h]
            assert res[0] == want[0], (n_shards, h)  # barcodes
            assert (res[1] == want[1]).all() and (res[2] == want[2]).all()
            assert res[3:6] == want[3:6], (n_shards, h)


def test_bam_crc_mismatch_detected(tmp_path):
    """A flipped payload byte must surface as a CRC diagnostic, not silent
    corruption (ROADMAP: CRC validation in the BGZF reader)."""
    import numpy as np
    import pytest

    from sctagger.io.bam import extract_cb_counts

    from bamgen import write_bam
    from oracle import random_dna

    rng = np.random.default_rng(3)
    alns = {"c1": [
        {"flag": 0, "name": f"q{i}", "pos": i,
         "tags": [["CB", random_dna(rng, 16)]], "seq": ""}
        for i in range(200)
    ]}
    path = str(tmp_path / "crc.bam")
    write_bam(path, ["c1"], alns)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # corrupt a compressed payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(RuntimeError, match="corrupt BGZF|CRC32|inflate"):
        extract_cb_counts(path)
