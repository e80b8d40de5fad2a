"""Adversarial multi-round fuzz of extract_sr_bc_from_lr vs the real
reference (functional ahocorasick stub), byte-equality per round.

Beyond the fixed golden test, each round stresses:
  * overlapping occurrences (homopolymer whitelist word in a homopolymer
    segment -> several overlapping hits -> ambiguous, read dropped);
  * palindromic (self-revcomp) whitelist words;
  * duplicate whitelist lines (automaton keeps the LAST value for a word);
  * a whitelist file WITHOUT a trailing newline — the reference strips one
    char per line (l[:-1]), truncating the last barcode to 15bp, which makes
    the whitelist ragged and must route our packed-16-mer device path to the
    host fallback;
  * segments exactly 16bp / shorter than 16bp, N inside planted words;
  * randomized --step-size/--thresh/--max-barcode-cnt with equal-count
    groups at the cutoff.

Default 3 rounds; SCTAG_FUZZ_ROUNDS scales it.
"""

import gzip
import os

import numpy as np
import pytest

from sctagger.cli import main as cli_main
from sctagger.core import rev_compl

from oracle import random_dna
from refharness import run_reference

ROUNDS = int(os.environ.get("SCTAG_FUZZ_ROUNDS", "3"))


def _make_inputs(tmp_path, rng, trailing_newline: bool):
    wl: list[str] = []
    seen: set[str] = set()

    def add(b: str) -> None:
        if b not in seen:
            seen.add(b)
            wl.append(b)

    add("A" * 16)                      # homopolymer: overlapping-hit bait
    add("ACGT" * 4)                    # self-revcomp
    p = random_dna(rng, 16)
    add(p)
    add(rev_compl(p))                  # rc pair
    while len(wl) < int(rng.integers(40, 120)):
        add(random_dna(rng, 16))
    lines = list(wl)
    lines.append(wl[int(rng.integers(len(wl)))])  # duplicate line (last wins)

    wl_path = tmp_path / "wl.txt"
    text = "\n".join(lines) + ("\n" if trailing_newline else "")
    wl_path.write_text(text)

    weights = 1.0 / (np.arange(len(wl)) + 1.0)
    weights /= weights.sum()
    rows = []
    for i in range(int(rng.integers(150, 400))):
        r = rng.random()
        if r < 0.08:
            rows.append(f"read{i}\t-1\tNA\t{random_dna(rng, 25)}")
            continue
        r2 = rng.random()
        if r2 < 0.08:
            seg = "A" * int(rng.integers(16, 26))   # overlapping hits
        elif r2 < 0.14:
            seg = wl[int(rng.integers(len(wl)))]     # exactly one 16bp window
        elif r2 < 0.20:
            seg = random_dna(rng, int(rng.integers(0, 16)))  # too short
        else:
            seg = random_dna(rng, int(rng.integers(17, 50)))
            if rng.random() < 0.75:
                bc = wl[int(rng.choice(len(wl), p=weights))]
                if rng.random() < 0.5:
                    bc = rev_compl(bc)
                if rng.random() < 0.08:
                    k = int(rng.integers(16))
                    bc = bc[:k] + "N" + bc[k + 1 :]  # kill the hit with N
                pos = int(rng.integers(0, max(1, len(seg) - 16)))
                seg = seg[:pos] + bc + seg[pos:]
            if rng.random() < 0.10:  # second planted word => ambiguous
                b2 = wl[int(rng.integers(len(wl)))]
                pos = int(rng.integers(0, len(seg) + 1))
                seg = seg[:pos] + b2 + seg[pos:]
        rows.append(f"read{i}\t1\t5\t{seg}")
    lr_path = tmp_path / "lr.tsv"
    lr_path.write_text("\n".join(rows) + "\n")
    return wl_path, lr_path


@pytest.mark.parametrize("round_i", range(ROUNDS))
def test_stage2alt_fuzz_parity(tmp_path, round_i):
    rng = np.random.default_rng(8200 + round_i)
    trailing_newline = round_i % 3 != 2  # every 3rd round: ragged whitelist
    wl, lr = _make_inputs(tmp_path, rng, trailing_newline)

    step = int(rng.choice([1, 7, 20, 1000]))
    thresh = float(rng.choice([0.001, 0.005, 0.08]))
    cap = int(rng.choice([15, 25000]))
    args = ["-i", str(lr), "-wl", str(wl), "--step-size", str(step),
            "--thresh", str(thresh), "--max-barcode-cnt", str(cap)]

    ref_out = tmp_path / "ref.tsv.gz"
    run_reference(
        ["extract_sr_bc_from_lr", *args, "-o", str(ref_out)],
        tmp_path,
        functional_ahocorasick=True,
    )
    our_out = tmp_path / "ours.tsv.gz"
    cli_main(["extract_sr_bc_from_lr", *args, "-o", str(our_out)])

    assert gzip.decompress(our_out.read_bytes()) == gzip.decompress(
        ref_out.read_bytes()
    )


def test_numeric_rc_keys_match_explicit_strings():
    """build_key_table(words) with numerically derived rc keys must produce
    IDENTICAL (sorted_keys, values) to the explicit rc-strings path — over
    several k, with duplicate words, rc collisions, and self-rc words (the
    keep-last duplicate semantics must break ties the same way)."""
    import numpy as np

    from sctagger.core.packing import rev_compl
    from sctagger.ops.exact_lookup import build_key_table

    from oracle import random_dna

    rng = np.random.default_rng(3)
    for k in (1, 4, 8, 12, 15, 16):
        bcs = [random_dna(rng, k) for _ in range(3000)]
        bcs[7] = bcs[3]  # duplicate word
        bcs[9] = rev_compl(bcs[5])  # rc collision across words
        if k % 2 == 0:
            bcs[11] = "AT" * (k // 2)  # self-rc word
        a_keys, a_vals = build_key_table(bcs)
        b_keys, b_vals = build_key_table(bcs, [rev_compl(b) for b in bcs])
        np.testing.assert_array_equal(a_keys, b_keys)
        np.testing.assert_array_equal(a_vals, b_vals)


def test_ragged_whitelist_sum_multiple_falls_back():
    """Regression (r4 review): a ragged whitelist whose lengths SUM to a
    multiple of the first word's length (8+14+2 = 3*8) must still raise
    ValueError (-> host-dict fallback), not silently mis-split into wrong
    keys."""
    import pytest

    from sctagger.ops.exact_lookup import build_key_table

    with pytest.raises(ValueError):
        build_key_table(["ACGTACGT", "ACGTACGTACGTAC", "GT"])
    # and through the words_rc-given path too
    from sctagger.core.packing import rev_compl

    words = ["ACGTACGT", "ACGTACGTACGTAC", "GT"]
    with pytest.raises(ValueError):
        build_key_table(words, [rev_compl(w) for w in words])


def test_host_probe_matches_device_probe(monkeypatch):
    """The native C++ hash probe (default backend, exact_probe.cpp) agrees
    with the device binary-search probe on fuzz segments incl. non-ACGT
    chars, empty rows, and planted fwd/rc barcodes."""
    import os

    import numpy as np

    from sctagger.core.packing import rev_compl
    from sctagger.ops.exact_lookup import (
        _probe_rows_host,
        build_key_table,
        probe_segments,
    )

    from oracle import random_dna

    rng = np.random.default_rng(44)
    bcs = sorted({random_dna(rng, 16) for _ in range(300)})
    sk, vals = build_key_table(bcs, [rev_compl(b) for b in bcs])
    segs = []
    for _ in range(3000):
        s = random_dna(rng, int(rng.integers(0, 40)))
        if rng.random() < 0.6:
            b = bcs[int(rng.integers(len(bcs)))]
            p = int(rng.integers(0, max(1, len(s))))
            s = s[:p] + b + s[p:]
        if rng.random() < 0.1:
            s = s[:5] + "N" + s[5:]
        segs.append(s)
    monkeypatch.setenv("SCTAG_PROBE", "device")
    cd, vd = probe_segments(segs, sk, vals, 16)
    ch, vh = _probe_rows_host(segs, sk, vals, 16)
    np.testing.assert_array_equal(cd, ch)
    np.testing.assert_array_equal(vd[cd == 1], vh[cd == 1])

    # r5 packed device path (single-device: SCTAG_MAX_DEVICES=1 drops the
    # CPU test mesh so _probe_segments_packed engages, incl. its junk-row
    # host re-probe and the final-chunk pad) must agree too
    monkeypatch.setenv("SCTAG_MAX_DEVICES", "1")
    monkeypatch.setenv("SCTAG_PROBE_CHUNK", "1024")
    cp, vp = probe_segments(segs, sk, vals, 16)
    np.testing.assert_array_equal(cp, ch)
    np.testing.assert_array_equal(vp[cp == 1], vh[cp == 1])

    # the opt-in bucketed kernel (recorded negative, SCTAG_BUCKET_PROBE=1)
    # must stay output-identical
    import sctagger.ops.exact_lookup as xl

    monkeypatch.setenv("SCTAG_BUCKET_PROBE", "1")
    xl._DEV_TABLE_CACHE.clear()  # re-derive the table entry with offsets
    cb, vb = probe_segments(segs, sk, vals, 16)
    monkeypatch.delenv("SCTAG_BUCKET_PROBE")
    xl._DEV_TABLE_CACHE.clear()
    np.testing.assert_array_equal(cb, ch)
    np.testing.assert_array_equal(vb[cb == 1], vh[cb == 1])

    # and with the native lib unavailable the junk rows take the unpacked
    # device fallback instead

    def _boom(*a, **k):
        raise OSError("native unavailable (test)")

    real = xl._probe_rows_host
    monkeypatch.setattr(xl, "_probe_rows_host", _boom)
    cq, vq = probe_segments(segs, sk, vals, 16)
    monkeypatch.setattr(xl, "_probe_rows_host", real)
    np.testing.assert_array_equal(cq, ch)
    np.testing.assert_array_equal(vq[cq == 1], vh[cq == 1])
