"""Exact-match prefilter (ops/exact_prefilter.py) vs brute force, and
match_segments parity with the prefilter on vs off."""

import numpy as np
import pytest

from sctagger.core import LENIENT_TABLE, encode_seqs, rev_compl
from sctagger.models.matcher import _build_patterns, match_segments
from sctagger.ops.exact_prefilter import exact_tie_probe

from oracle import random_dna


def _brute_hits(segs, pats):
    """dict read -> sorted distinct pattern ids occurring as substrings."""
    out = {}
    for r, s in enumerate(segs):
        ids = sorted({i for i, p in enumerate(pats) if p in s})
        if ids:
            out[r] = ids
    return out


@pytest.mark.parametrize("bl", [12, 16, 20, 31])
def test_probe_vs_brute_force(bl):
    rng = np.random.default_rng(bl)
    pats = [random_dna(rng, bl) for _ in range(40)]
    pats[3] = pats[0]  # duplicate pattern id
    pats[7] = rev_compl(pats[1])  # rc collision
    segs = []
    for r in range(300):
        body = random_dna(rng, int(rng.integers(bl - 3, 3 * bl)))
        if rng.random() < 0.6:
            p = pats[int(rng.integers(len(pats)))]
            at = int(rng.integers(0, max(1, len(body) - 2)))
            body = body[:at] + p + body[at:]
        if rng.random() < 0.1:
            body = body[: len(body) // 2] + "N" + body[len(body) // 2 :]
        segs.append(body)
    seg_codes, lens = encode_seqs(
        segs, pad_to=max(len(s) for s in segs), table=LENIENT_TABLE
    )
    pat_codes, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    got = exact_tie_probe(seg_codes, lens, pat_codes)

    # brute force on the LENIENT view (N matches 'A' in trie semantics)
    lenient = [
        bytes(LENIENT_TABLE[np.frombuffer(s.encode(), np.uint8)]) for s in segs
    ]
    lpats = [
        bytes(LENIENT_TABLE[np.frombuffer(p.encode(), np.uint8)]) for p in pats
    ]
    want = _brute_hits(lenient, lpats)
    assert list(got.rids) == sorted(want)
    for i, rid in enumerate(got.rids):
        ids = got.pids[got.offsets[i] : got.offsets[i + 1]]
        assert list(ids) == want[int(rid)], rid


def test_probe_empty_and_short():
    pat_codes, _ = encode_seqs(["ACGTACGTACGTACGT"], pad_to=16,
                               table=LENIENT_TABLE)
    seg_codes, lens = encode_seqs(["ACG", ""], pad_to=8, table=LENIENT_TABLE)
    got = exact_tie_probe(seg_codes, lens, pat_codes)
    assert got.rids.size == 0 and got.pids.size == 0


def test_match_segments_prefilter_parity(monkeypatch):
    """match_segments with the prefilter on == off, including tie overflow
    (duplicated barcodes force >TIES_K dist-0 ties)."""
    rng = np.random.default_rng(11)
    base = [random_dna(rng, 16) for _ in range(10)]
    barcodes = base + [base[0]] * 10  # 11 copies -> dist-0 ties > TIES_K
    segs = []
    for r in range(400):
        body = random_dna(rng, 24)
        roll = rng.random()
        if roll < 0.5:  # exact plant -> prefilter path
            b = base[int(rng.integers(len(base)))]
            segs.append(body[:4] + b + body[4:8])
        elif roll < 0.8:  # 1-2 errors -> device/fallback path
            b = list(base[int(rng.integers(len(base)))])
            for _ in range(int(rng.integers(1, 3))):
                b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
            segs.append(body[:4] + "".join(b) + body[4:8])
        else:
            segs.append(body)

    def run():
        r = match_segments(segs, barcodes, max_error=2)
        return (
            r.rids.tolist(),
            r.dists.tolist(),
            r.tie_counts.tolist(),
            [r.ties_of(i).tolist() for i in range(r.rids.size)],
        )

    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    on = run()
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")
    off = run()
    assert on == off
    # the prefilter really resolved something: some read has dist 0
    assert 0 in on[1]
    # and overflow tie sets exist (>TIES_K from the duplicated barcodes)
    from sctagger.ops.match_pallas import TIES_K

    assert max(on[2]) > TIES_K


def test_match_segments_streaming_kernel_path(monkeypatch):
    """The kernel-path streaming dispatcher (per-slice probe, survivor
    repacking across slice boundaries, partial flush per bucket) in pallas
    interpret mode == the plain jnp path, with the prefilter on and off.

    PASS1_CHUNK is shrunk to one kernel block so several slices stream
    through the carry buffer."""
    import sctagger.models.matcher as matcher

    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    rng = np.random.default_rng(23)
    base = [random_dna(rng, 16) for _ in range(12)]
    barcodes = base + [base[0]] * 10  # overflow ties on exact reads
    segs = []
    for r in range(2600):
        body = random_dna(rng, 24 if r % 5 else 40)  # two length buckets
        roll = rng.random()
        if roll < 0.5:
            b = base[int(rng.integers(len(base)))]
            segs.append(body[:4] + b + body[4:8])
        elif roll < 0.8:
            b = list(base[int(rng.integers(len(base)))])
            for _ in range(int(rng.integers(1, 3))):
                b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
            segs.append(body[:4] + "".join(b) + body[4:8])
        else:
            segs.append(body)

    def run(fk):
        r = matcher.match_segments(segs, barcodes, max_error=2,
                                   force_kernel=fk)
        return (
            r.rids.tolist(),
            r.dists.tolist(),
            r.tie_counts.tolist(),
            [r.ties_of(i).tolist() for i in range(r.rids.size)],
        )

    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    kern_on = run(True)
    ref = run(False)
    assert kern_on == ref
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")
    kern_off = run(True)
    assert kern_off == ref


def test_match_segments_carry_reprobe_parity(monkeypatch):
    """The r5 opportunistic d1 re-probe of carried exact-only survivors is
    output-invisible: with the neighborhood index pre-built (nb_ready()
    guaranteed True at dispatch time, so the re-probe branch definitely
    runs on slice 0's survivors) the result equals the jnp fallback."""
    import sctagger.models.matcher as matcher

    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    rng = np.random.default_rng(77)
    barcodes = [random_dna(rng, 16) for _ in range(12)]
    segs = []
    for r in range(2300):
        body = random_dna(rng, 24)
        roll = rng.random()
        if roll < 0.4:
            b = barcodes[int(rng.integers(len(barcodes)))]
            segs.append(body[:4] + b + body[4:8])
        elif roll < 0.8:
            b = list(barcodes[int(rng.integers(len(barcodes)))])
            for _ in range(int(rng.integers(1, 3))):
                b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
            segs.append(body[:4] + "".join(b) + body[4:8])
        else:
            segs.append(body)

    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    ctx = matcher.MatchContext(barcodes)
    ctx.nb_index()  # block until built: dispatch-time nb_ready() is True
    assert ctx.nb_ready()
    r = matcher.match_segments(
        segs, barcodes, max_error=2, force_kernel=True, ctx=ctx
    )
    ref = matcher.match_segments(segs, barcodes, max_error=2)
    assert r.rids.tolist() == ref.rids.tolist()
    assert r.dists.tolist() == ref.dists.tolist()
    assert r.tie_counts.tolist() == ref.tie_counts.tolist()
    for i in range(r.rids.size):
        assert r.ties_of(i).tolist() == ref.ties_of(i).tolist()


@pytest.mark.parametrize("bl", [4, 12, 16, 20, 31])
def test_neighborhood_probe_vs_oracle(bl):
    """NeighborhoodIndex.probe == DP oracle on every read with min <= 1:
    exact min (0/1) and exact tie set; reads with min >= 2 absent."""
    from oracle import hw_best

    from sctagger.ops.exact_prefilter import NeighborhoodIndex

    rng = np.random.default_rng(bl)
    pats = [random_dna(rng, bl) for _ in range(25)]
    pats[3] = pats[0]  # duplicate pattern ids
    segs = []
    for r in range(250):
        body = random_dna(rng, int(rng.integers(max(1, bl - 3), 3 * bl)))
        if rng.random() < 0.7:  # plant with 0-2 random edits (sub/del/ins)
            p = list(pats[int(rng.integers(len(pats)))])
            for _ in range(int(rng.integers(0, 3))):
                op = rng.integers(0, 3)
                pos = int(rng.integers(0, max(1, len(p))))
                if op == 0 and p:
                    p[pos] = "ACGT"[int(rng.integers(4))]
                elif op == 1 and len(p) > 1:
                    del p[pos]
                else:
                    p.insert(pos, "ACGT"[int(rng.integers(4))])
            at = int(rng.integers(0, max(1, len(body))))
            body = body[:at] + "".join(p) + body[at:]
        segs.append(body)
    seg_codes, lens = encode_seqs(
        segs, pad_to=max(len(s) for s in segs), table=LENIENT_TABLE
    )
    pat_codes, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    got = NeighborhoodIndex(pat_codes).probe(seg_codes, lens)
    got_map = {
        int(got.rids[i]): (
            int(got.dists[i]),
            list(got.pids[got.offsets[i] : got.offsets[i + 1]]),
        )
        for i in range(got.rids.size)
    }
    for r, s in enumerate(segs):
        ds = [hw_best(p, s) for p in pats]
        mn = min(ds)
        if mn <= 1:
            want = (mn, [i for i, d in enumerate(ds) if d == mn])
            assert got_map.get(r) == want, (bl, r, got_map.get(r), want)
        else:
            assert r not in got_map, (bl, r)


def test_match_segments_d1_parity(monkeypatch):
    """match_segments with the dist<=1 tier on == d0-only == prefilter off,
    on a workload heavy in dist-1 reads (subs AND indels), incl. a dist-1
    tie overflow cluster (>TIES_K barcodes at distance 1 of one read)."""
    rng = np.random.default_rng(31)
    core = random_dna(rng, 16)
    # 12 barcodes, each one substitution from `core`: a segment containing
    # `core` verbatim is at dist 1 from ALL of them (tie overflow at d1)
    cluster = []
    while len(cluster) < 12:
        b = list(core)
        b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
        if "".join(b) != core and "".join(b) not in cluster:
            cluster.append("".join(b))
    barcodes = cluster + [random_dna(rng, 16) for _ in range(20)]
    segs = []
    for r in range(500):
        body = random_dna(rng, 24)
        roll = rng.random()
        if roll < 0.15:
            segs.append(body[:4] + core + body[4:8])  # d1 overflow ties
        elif roll < 0.65:  # one random edit of a barcode (sub, del, or ins)
            b = list(barcodes[int(rng.integers(len(barcodes)))])
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(b)))
            if op == 0:
                b[pos] = "ACGT"[int(rng.integers(4))]
            elif op == 1:
                del b[pos]
            else:
                b.insert(pos, "ACGT"[int(rng.integers(4))])
            segs.append(body[:4] + "".join(b) + body[4:8])
        elif roll < 0.85:  # exact
            segs.append(body[:4] + barcodes[int(rng.integers(len(barcodes)))]
                        + body[4:8])
        else:
            segs.append(body)

    def run():
        r = match_segments(segs, barcodes, max_error=2)
        return (
            r.rids.tolist(),
            r.dists.tolist(),
            r.tie_counts.tolist(),
            [r.ties_of(i).tolist() for i in range(r.rids.size)],
        )

    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    monkeypatch.setenv("SCTAG_PREFILTER_D1", "1")
    d1_on = run()
    monkeypatch.setenv("SCTAG_PREFILTER_D1", "0")
    d0_only = run()
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")
    off = run()
    assert d1_on == d0_only
    assert d1_on == off
    assert 1 in d1_on[1]  # dist-1 reads really present
    from sctagger.ops.match_pallas import TIES_K

    # some dist-1 read overflowed the tie slots
    d1_rows = [i for i, d in enumerate(d1_on[1]) if d == 1]
    assert max(d1_on[2][i] for i in d1_rows) > TIES_K


def test_match_segments_d1_mr0(monkeypatch):
    """max_error=0: dist-1 reads resolved by the d1 tier must be EXCLUDED
    from the output (reference omits reads beyond mr) while dist-0 reads
    keep exact tie sets."""
    rng = np.random.default_rng(77)
    barcodes = [random_dna(rng, 16) for _ in range(10)]
    segs = []
    for r in range(60):
        b = barcodes[int(rng.integers(len(barcodes)))]
        if r % 2 == 0:
            segs.append("ACGT" + b + "AC")
        else:  # one deletion -> usually dist exactly 1
            pos = int(rng.integers(16))
            segs.append("ACGT" + b[:pos] + b[pos + 1 :] + "AC")
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    monkeypatch.setenv("SCTAG_PREFILTER_D1", "1")
    r1 = match_segments(segs, barcodes, max_error=0)
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")
    r0 = match_segments(segs, barcodes, max_error=0)
    assert r1.rids.tolist() == r0.rids.tolist()
    assert (r1.dists == 0).all()
    assert r1.tie_counts.tolist() == r0.tie_counts.tolist()
    assert [r1.ties_of(i).tolist() for i in range(r1.rids.size)] == [
        r0.ties_of(i).tolist() for i in range(r0.rids.size)
    ]
    # every exact plant matched; most deletion reads excluded (mr=0)
    assert set(range(0, 60, 2)) <= set(r1.rids.tolist())
    assert len(r1.rids) < 60


def test_match_context_batched_parity(monkeypatch):
    """Batched calls sharing a MatchContext (pinned global buckets, reused
    neighborhood index, probe_first on later batches) == one-shot call —
    including a batch whose length distribution differs from the global fit
    (all-long reads) and the streaming kernel path."""
    import sctagger.models.matcher as matcher
    from sctagger.core.packing import seq_lengths
    from sctagger.models.matcher import MatchContext, fit_buckets

    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    monkeypatch.setenv("SCTAG_PREFILTER_D1", "1")
    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    rng = np.random.default_rng(9)
    base = [random_dna(rng, 16) for _ in range(15)]
    segs = []
    for r in range(3200):
        # first half short reads, second half long: per-batch length
        # distributions differ from the global one
        body = random_dna(rng, 24 if r < 1600 else 72)
        roll = rng.random()
        if roll < 0.4:
            b = base[int(rng.integers(len(base)))]
            segs.append(body[:4] + b + body[4:8])
        elif roll < 0.7:
            b = list(base[int(rng.integers(len(base)))])
            for _ in range(int(rng.integers(1, 3))):
                b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
            segs.append(body[:4] + "".join(b) + body[4:8])
        else:
            segs.append(body)

    def summarize(r, off=0):
        return [
            (int(r.rids[i]) + off, int(r.dists[i]),
             r.ties_of(i).tolist())
            for i in range(r.rids.size)
        ]

    one = summarize(
        matcher.match_segments(segs, base, max_error=2, force_kernel=True)
    )
    ctx = MatchContext(base, buckets=fit_buckets(seq_lengths(segs)))
    batched = []
    for bi, s in enumerate(range(0, 3200, 800)):
        r = matcher.match_segments(
            segs[s : s + 800], base, max_error=2, force_kernel=True,
            ctx=ctx, probe_first=(bi > 0),
        )
        batched.extend(summarize(r, off=s))
    assert batched == one
    # the neighborhood index really was shared (built exactly once)
    assert ctx._nb_thread is not None


@pytest.mark.parametrize("prefilter", ["1", "0"])
def test_match_segments_dynls_ragged(monkeypatch, prefilter):
    """Ragged buckets on the single-device kernel path (the kernel's
    per-tile length bound cuts the sweep of short tiles) give output
    identical to the plain jnp path, with the host prefilter on and off."""
    import sctagger.models.matcher as matcher
    import sctagger.parallel.mesh as mesh_mod

    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    monkeypatch.setattr(mesh_mod, "local_mesh", lambda *a, **k: None)
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", prefilter)
    rng = np.random.default_rng(41)
    base = [random_dna(rng, 16) for _ in range(14)]
    segs = []
    for r in range(2600):
        # heavily ragged: lengths 16..64 in ONE quantile bucket ladder
        body = random_dna(rng, int(rng.integers(16, 65)))
        roll = rng.random()
        if roll < 0.4 and len(body) >= 24:
            b = base[int(rng.integers(len(base)))]
            segs.append(body[:4] + b + body[4 + 16 :])
        elif roll < 0.7:
            b = list(base[int(rng.integers(len(base)))])
            for _ in range(int(rng.integers(1, 3))):
                b[int(rng.integers(16))] = "ACGT"[int(rng.integers(4))]
            segs.append(body[:4] + "".join(b) + body[4:8])
        else:
            segs.append(body)

    def run(fk):
        r = matcher.match_segments(segs, base, max_error=2, force_kernel=fk)
        return (
            r.rids.tolist(),
            r.dists.tolist(),
            r.tie_counts.tolist(),
            [r.ties_of(i).tolist() for i in range(r.rids.size)],
        )

    assert run(True) == run(False)


def test_match_segments_prefilter_all_exact(monkeypatch):
    """Every read resolved by the prefilter: no device chunks at all."""
    rng = np.random.default_rng(5)
    barcodes = [random_dna(rng, 16) for _ in range(8)]
    segs = ["AC" + b + "GT" for b in barcodes]
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "1")
    r = match_segments(segs, barcodes, max_error=2)
    assert r.rids.tolist() == list(range(len(segs)))
    assert (r.dists == 0).all()
