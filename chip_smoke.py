#!/usr/bin/env python3
"""Smoke run of scTagger's device path on one NVIDIA GPU.

    python chip_smoke.py           # phases a-c on one GPU
    python chip_smoke.py --four    # phase d only, on four GPUs

Phases (each runs in its own child process, one at a time, so only one
process ever holds the card; CPU comparison runs set JAX_PLATFORMS=cpu):

  a. device: jax.devices(), device_kind, the nvidia-smi card line; fails
     unless the platform is gpu.
  b. kernels: the stage-3 Pallas kernel, compiled for the card, against
     its plain-jnp twin at real widths (131,072 segments x 50,176 padded
     patterns at Ls=24, plus a ragged 16-64 bucket), and the stage-1 device
     scan against the mask path (32K reads x ~2 kbp); both against the C++
     oracles (tools/refbench.cpp) on 4,096 segments / 2,048 reads. Integer
     outputs, exact equality (no float matmul anywhere, so TF32 does not
     apply).
  c. CLI: extract_lr_bc (200,000 reads of ~2 kbp, 5% adapter error),
     extract_sr_bc_from_lr on its output, extract_sr_bc on a generated BAM,
     match_trie (1,048,576 segments x 25,000 barcodes, mr=2), each through
     `python -m sctagger` with a nonzero device-kernel dispatch count,
     plus byte comparisons against the same CLI on the CPU on a subset.
  d. (--four) extract_lr_bc and match_trie at phase-c sizes over the local
     4-GPU mesh, and match_trie again with SCTAG_MODEL_PARALLEL=2, each
     byte-compared with SCTAG_MAX_DEVICES=1.

Walls printed here are smoke figures, not benchmark results. The last line
of stdout is one JSON object: {"ok": true, "device": {...}}. Any failed
phase exits nonzero without it.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
TIES_K = 8
N_LR, N_LR_CPU = 200_000, 20_000
N_SEG, N_SEG_CPU = 1_048_576, 65_536
N_BC = 25_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def child_env(platform: str, **extra) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platform
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tools"), str(REPO / "tests")]
    )
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_child(phase: str, *args: str) -> dict:
    """Run one phase of this script in a GPU child; returns its result."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--phase", phase, *args],
        env=child_env("cuda"), capture_output=True, text=True,
    )
    for line in proc.stdout.splitlines():
        if not line.startswith("RESULT "):
            log(line)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"phase {phase} failed (exit {proc.returncode})")
    res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(res[-1][len("RESULT "):])


# ---------------------------------------------------------------------------
# phase a + b (run inside a GPU child)
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    import sctagger  # noqa: F401  (fails outside the repo)

    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    d = {"platform": devs[0].platform, "kind": devs[0].device_kind,
         "count": len(devs)}
    log(f"device_kind: {d['kind']}  count: {d['count']}")
    if d["platform"] != "gpu":
        raise SystemExit(f"platform is {d['platform']}, not gpu")
    return d


def _timed(fn, reps: int = 3) -> tuple[object, float]:
    """(result, best-of-reps seconds) after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


def _stage3_inputs(n: int, ragged: bool, seed: int):
    """Seeded segments against 25,000 barcodes (50,000 fwd+rc patterns).
    Uniform 24-bp segments with planted 0-2-substitution barcodes, or a
    ragged bucket with lengths 16-64 sorted ascending."""
    import numpy as np

    from bench import make_inputs
    from sctagger.core import LENIENT_TABLE, encode_seqs
    from sctagger.models.matcher import _build_patterns

    segs, barcodes = make_inputs(n, N_BC, seed=seed, indels=False)
    if ragged:
        rng = np.random.default_rng(seed + 1)
        lens = np.sort(rng.integers(16, 65, n))
        alpha = np.array(list("ACGT"))
        out = []
        for s, L in zip(segs, lens):
            pad = "".join(alpha[rng.integers(0, 4, max(0, L - len(s)))])
            out.append((pad[: len(pad) // 2] + s + pad[len(pad) // 2 :])[:L])
        segs = out
    ls = 64 if ragged else 24
    codes, lens = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    return codes, lens, _build_patterns(barcodes, 16), ls


def _check_stage3(codes, lens, pats, ls, tag: str, oracle_rows: int):
    import jax.numpy as jnp
    import numpy as np

    import native_oracles
    from sctagger.ops.match_pallas import (
        match_full, prep_peq_rows, prep_segs_T, tile_maxlens,
    )
    from sctagger.ops.myers import build_peq_multi, match_full_ref

    R = codes.shape[0]
    peq = build_peq_multi(pats)
    p_pad = 50_176  # 49 x 1024: a multiple of every tile width used below
    peq_p = np.zeros((5, p_pad), np.int32)
    peq_p[:, : peq.shape[1]] = peq
    seg_T = jnp.asarray(prep_segs_T(codes, ls, r_pad=R))
    peq_rows = jnp.asarray(prep_peq_rows(peq_p))
    ml = jnp.asarray(tile_maxlens(lens, R))
    t0 = time.perf_counter()
    got = np.asarray(match_full(seg_T, peq_rows, ml, 16))
    log(f"[b] stage-3 {tag}: first call (compile + run) "
        f"{time.perf_counter() - t0:.1f} s")
    _, t_kernel = _timed(lambda: match_full(seg_T, peq_rows, ml, 16))
    seg_i = seg_T.astype(jnp.int32)
    peq_j = jnp.asarray(peq_p)
    want, t_plain = _timed(
        lambda: match_full_ref(seg_i, peq_j, 16, k=TIES_K, r_tile=4096,
                               p_tile=3584),
        reps=1,
    )
    want = np.asarray(want)
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).any(axis=0))
        raise SystemExit(f"stage-3 {tag}: kernel != plain on {bad.size} "
                         f"segments, first {bad[:5]}")
    log(f"[b] stage-3 {tag}: {R} segments x {p_pad} patterns Ls={ls}: "
        f"kernel == plain jnp (exact, all {TIES_K + 2} rows); kernel "
        f"{t_kernel:.4f} s, plain min+ties sweep {t_plain:.4f} s")
    if oracle_rows:
        n = oracle_rows
        ref = native_oracles.match_full(codes[:n], lens[:n], pats, TIES_K)
        if not np.array_equal(got[:, :n], ref):
            bad = np.flatnonzero((got[:, :n] != ref).any(axis=0))
            raise SystemExit(f"stage-3 {tag}: kernel != C++ oracle on "
                             f"{bad.size} of {n} segments")
        log(f"[b] stage-3 {tag}: first {n} segments == C++ oracle (exact)")
    return {"kernel_s": t_kernel, "plain_s": t_plain}


def _stage1_inputs(n: int, seed: int):
    """n reads of 1.5-2.5 kbp (sorted by length, as the driver buckets
    them) with a planted adapter (0-3 substitutions) on either strand."""
    import numpy as np

    from sctagger.core import rev_compl

    adapter = "CTACACGACGCTCTTCCGATCT"
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    lens = np.sort(rng.integers(1536, 2561, n))
    reads = []
    for L in lens:
        body = bytearray(alpha[rng.integers(0, 4, L)].tobytes())
        ad = bytearray((adapter if rng.random() < 0.5
                        else rev_compl(adapter)).encode())
        for p in rng.integers(0, len(ad), rng.integers(0, 4)):
            ad[p] = int(alpha[rng.integers(0, 4)])
        pos = int(rng.integers(0, L - len(ad)))
        body[pos : pos + len(ad)] = ad
        reads.append(body.decode())
    return reads, adapter


def _check_stage1(n: int, oracle_rows: int):
    import jax.numpy as jnp
    import numpy as np

    import native_oracles
    from sctagger.core import STRICT_TABLE, encode_seqs, encode_str, rev_compl
    from sctagger.models.adapter import _hw_block
    from sctagger.ops.adapter_scan import (
        SLOTS_K, _adapter_scan, n_out_for, pack_codes, pad_len,
        unpack_scan_out,
    )
    from sctagger.ops.myers import build_peq_multi

    reads, adapter = _stage1_inputs(n, seed=7)
    m = len(adapter)
    codes, lens = encode_seqs(reads, pad_to=max(map(len, reads)),
                              table=STRICT_TABLE)
    l_total = pad_len(codes.shape[1])
    pk = jnp.asarray(pack_codes(codes, l_total))
    ln = jnp.asarray(lens.astype(np.int32))
    peq2 = jnp.asarray(build_peq_multi(
        np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    ))
    n_out = n_out_for(l_total)
    got, t_scan = _timed(lambda: _adapter_scan(pk, ln, peq2, m, n_out))
    fwd, rc = unpack_scan_out(np.asarray(got), n)
    # the plain reference: the mask path's distances and argmin end sets
    (d, mask), t_mask = _timed(lambda: _hw_block(
        jnp.asarray(codes.T.astype(np.int32)), peq2, ln, m), reps=1)
    d, mask = np.asarray(d), np.asarray(mask)
    for p, res in ((0, fwd), (1, rc)):
        mk = mask[:, :, p]
        cnt = mk.sum(axis=0)
        rank = np.cumsum(mk, axis=0)
        ok = np.array_equal(res["d"], d[:, p]) and np.array_equal(
            res["cnt"], cnt)
        for k in range(SLOTS_K):
            has = cnt > k
            first = np.argmax(rank == k + 1, axis=0)
            ok = ok and np.array_equal(res["slots"][has, k], first[has])
        if not ok:
            raise SystemExit(f"stage-1: device scan != mask path (strand {p})")
    log(f"[b] stage-1: {n} reads x {int(lens.mean())} bp mean "
        f"(l_total {l_total}): device scan == mask path (d, end count, "
        f"first {SLOTS_K} ends; exact); scan {t_scan:.4f} s, mask path "
        f"{t_mask:.4f} s")
    lib = native_oracles.load()
    for i in range(oracle_rows):
        for q, res in ((adapter, fwd), (rev_compl(adapter), rc)):
            dd, locs = native_oracles.hw_locations(q, reads[i], lib)
            ends = [e for _s, e in locs]
            k = min(len(ends), SLOTS_K)
            if (int(res["d"][i]) != dd or int(res["cnt"][i]) != len(ends)
                    or list(res["slots"][i][:k]) != ends[:k]):
                raise SystemExit(f"stage-1: read {i} != C++ oracle")
    log(f"[b] stage-1: first {oracle_rows} reads == C++ oracle "
        "(d, end count, first 4 ends; both strands)")
    return {"scan_s": t_scan, "mask_path_s": t_mask}


def phase_kernels() -> dict:
    import numpy as np

    log("[b] integer kernels: exact equality; no float matmul, so TF32 "
        "does not apply")
    res = {}
    codes, lens, pats, ls = _stage3_inputs(131_072, ragged=False, seed=1)
    res["stage3_flagship"] = _check_stage3(codes, lens, pats, ls,
                                           "flagship", 4096)
    codes, lens, pats, ls = _stage3_inputs(131_072, ragged=True, seed=2)
    assert lens.min() >= 16 and lens.max() <= 64, (lens.min(), lens.max())
    res["stage3_ragged"] = _check_stage3(codes, lens, pats, ls, "ragged", 0)
    res["stage1"] = _check_stage1(32_768, 2048)
    del np
    return res


# ---------------------------------------------------------------------------
# phase c / d (parent: generates inputs, drives the CLI)
# ---------------------------------------------------------------------------


def _gen_lr(path: str, n: int) -> str:
    from measure_reference import make_lr_fastq

    make_lr_fastq(pathlib.Path(path), n, 2000, seed=42, err_rate=0.05)
    return path


def _gen_match(lr_path: str, sr_path: str, n: int) -> str:
    from bench import make_inputs

    segs, barcodes = make_inputs(n, N_BC, seed=0, indels=False)
    with open(lr_path, "w") as f:
        f.writelines(f"s{i}\t1\t0\t{s}\n" for i, s in enumerate(segs))
    with open(sr_path, "w") as f:
        f.writelines(f"{b}\t{N_BC - j}\n" for j, b in enumerate(barcodes))
    return lr_path


def _gen_bam(tmp: str) -> str:
    from measure_reference import make_sr_bam

    return make_sr_bam(pathlib.Path(tmp), 500_000)


def _whitelist(lr_tsv_gz: str, path: str) -> None:
    """10x-style whitelist: the 16-mer at the start of every second valid
    stage-1 segment (so a share of the probes hit) plus seeded decoys."""
    import numpy as np

    keys = set()
    with gzip.open(lr_tsv_gz, "rt") as f:
        for i, line in enumerate(f):
            seg = line.rstrip("\n").split("\t")[3]
            if len(seg) >= 16 and i % 2 == 0:
                keys.add(seg[:16])
    rng = np.random.default_rng(5)
    alpha = np.array(list("ACGT"))
    for row in alpha[rng.integers(0, 4, (100_000, 16))]:
        keys.add("".join(row))
    with open(path, "w") as f:
        f.writelines(k + "\n" for k in sorted(keys))


def _read_out(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


def cli(tmp: str, tag: str, argv: list[str], platform: str = "cuda",
        expect_kernel: str | None = None, **env) -> tuple[bytes, dict]:
    """Run one CLI stage; returns (output bytes, stage stats record)."""
    stats = os.path.join(tmp, f"stats_{tag}.jsonl")
    out = argv[argv.index("-o") + 1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sctagger", *argv],
        env=child_env(platform, SCTAG_STATS=stats, **env),
        capture_output=True, text=True, cwd=tmp,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"{tag}: exit {proc.returncode}")
    with open(stats) as f:
        rec = json.loads(f.readlines()[-1])
    dev = rec.get("device", {})
    calls = rec.get("kernel_calls", {})
    where = (f"{dev['platform']} {dev['kind']} x{dev['count']}" if dev
             else "the host only (the stage imports no JAX)")
    log(f"[{tag}] wall {wall:.1f} s (stage {rec['wall_s']} s) on {where}; "
        f"kernel dispatches {calls}")
    # scan.d0_resolved_reads rides the timer table but is a read count
    top = sorted((kv for kv in rec.get("timers_s", {}).items()
                  if not kv[0].endswith("_reads")), key=lambda kv: -kv[1])
    log(f"[{tag}] largest stage timers (s, nested timers overlap): "
        + ", ".join(f"{k} {v}" for k, v in top[:6]))
    if expect_kernel is not None:
        if dev.get("platform") != "gpu":
            raise SystemExit(f"{tag}: ran on {dev}, not the gpu")
        if calls.get(expect_kernel, 0) <= 0:
            raise SystemExit(f"{tag}: no {expect_kernel} dispatches")
    rec["wall"] = wall
    return _read_out(out), rec


def _same(tag: str, a: bytes, b: bytes) -> None:
    if a != b:
        raise SystemExit(f"{tag}: outputs differ ({len(a)} vs {len(b)} "
                         "bytes)")
    log(f"[{tag}] byte-identical ({len(a)} bytes, {a.count(b'\n')} rows)")


def phase_cli(tmp: str, gens: dict) -> dict:
    walls = {}
    j = os.path.join
    for g in list(gens.values()):  # no generator competes with timed stages
        g.result()
    lr_fq = gens["lr"].result()
    lr_out = j(tmp, "lr.tsv.gz")
    _, rec = cli(tmp, "extract_lr_bc", ["extract_lr_bc", "-r", lr_fq, "-o",
                 lr_out], expect_kernel="adapter_scan")
    c = rec["counters"]
    n_reads = c.get("reads", N_LR)
    t = rec["timers_s"]
    # host tiers resolve reads before the device; the rest is device work
    host = t.get("scan.d0_resolved_reads", 0.0)
    log(f"[extract_lr_bc] host prefilter resolved {host:.0f} of "
        f"{n_reads:.0f} reads; device share {1 - host / n_reads:.3f}")
    walls["extract_lr_bc"] = rec["wall"]

    wl = j(tmp, "wl.txt")
    _whitelist(lr_out, wl)
    _, rec = cli(tmp, "extract_sr_bc_from_lr", [
        "extract_sr_bc_from_lr", "-i", lr_out, "-wl", wl, "-o",
        j(tmp, "alt.tsv")])
    walls["extract_sr_bc_from_lr"] = rec["wall"]

    bam = gens["bam"].result()
    _, rec = cli(tmp, "extract_sr_bc", ["extract_sr_bc", "-i", bam, "-o",
                 j(tmp, "sr_bam.tsv")])
    walls["extract_sr_bc"] = rec["wall"]

    seg_lr = gens["match"].result()
    _, rec = cli(tmp, "match_trie", [
        "match_trie", "-lr", seg_lr, "-sr", j(tmp, "sr.tsv"), "-mr", "2",
        "-o", j(tmp, "match.tsv")], expect_kernel="match_full")
    walls["match_trie"] = rec["wall"]

    # GPU vs CPU on seeded subsets the CPU finishes in minutes
    small_fq = gens["lr_small"].result()
    small_seg = gens["match_small"].result()
    for plat in ("cuda", "cpu"):
        kind = "adapter_scan" if plat == "cuda" else None
        outs = {}
        outs["lr"], _ = cli(tmp, f"extract_lr_bc_{N_LR_CPU}_{plat}", [
            "extract_lr_bc", "-r", small_fq, "-o",
            j(tmp, f"lr_small_{plat}.tsv.gz")], plat, expect_kernel=kind)
        outs["mt"], _ = cli(tmp, f"match_trie_{N_SEG_CPU}_{plat}", [
            "match_trie", "-lr", small_seg, "-sr", j(tmp, "sr_small.tsv"),
            "-mr", "2", "-o", j(tmp, f"match_small_{plat}.tsv")], plat,
            expect_kernel="match_full" if plat == "cuda" else None)
        gens[plat] = outs
    _same(f"extract_lr_bc {N_LR_CPU} reads gpu vs cpu",
          gens["cuda"]["lr"], gens["cpu"]["lr"])
    _same(f"match_trie {N_SEG_CPU} segments gpu vs cpu",
          gens["cuda"]["mt"], gens["cpu"]["mt"])
    return walls


def phase_four(tmp: str, gens: dict) -> None:
    j = os.path.join
    lr_fq = gens["lr"].result()
    gens["match"].result()  # no generator competes with the timed stages
    one, _ = cli(tmp, "extract_lr_bc_1dev", ["extract_lr_bc", "-r", lr_fq,
                 "-o", j(tmp, "lr1.tsv.gz")], expect_kernel="adapter_scan",
                 SCTAG_MAX_DEVICES=1)
    four, rec = cli(tmp, "extract_lr_bc_4dev", ["extract_lr_bc", "-r", lr_fq,
                    "-o", j(tmp, "lr4.tsv.gz")], expect_kernel="adapter_scan")
    if rec["device"]["count"] != 4:
        raise SystemExit(f"expected 4 devices, got {rec['device']}")
    _same("extract_lr_bc 1 vs 4 GPUs", one, four)
    seg_lr = gens["match"].result()
    argv = ["match_trie", "-lr", seg_lr, "-sr", j(tmp, "sr.tsv"), "-mr", "2",
            "-o"]
    one, _ = cli(tmp, "match_trie_1dev", argv + [j(tmp, "m1.tsv")],
                 expect_kernel="match_full", SCTAG_MAX_DEVICES=1)
    four, _ = cli(tmp, "match_trie_4dev", argv + [j(tmp, "m4.tsv")],
                  expect_kernel="match_full")
    _same("match_trie 1 vs 4 GPUs (model_parallel 1)", one, four)
    mp2, _ = cli(tmp, "match_trie_4dev_mp2", argv + [j(tmp, "m4mp.tsv")],
                 expect_kernel="match_full", SCTAG_MODEL_PARALLEL=2)
    _same("match_trie 1 vs 4 GPUs (2x2 mesh, model_parallel 2)", one, mp2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path[:0] = [str(REPO), str(REPO / "tools"), str(REPO / "tests")]

    if args.phase:  # child: one GPU phase, result on a RESULT line
        fn = {"device": phase_device, "kernels": phase_kernels}[args.phase]
        print("RESULT " + json.dumps(fn()), flush=True)
        return 0

    from concurrent.futures import ProcessPoolExecutor

    t_start = time.perf_counter()
    dev = run_child("device")
    card = card_line()
    log(f"[a] card: {card}")
    # the host library builds on first use; build it here, outside every
    # timed stage and before the input generators run in parallel
    from sctagger.native.build import ensure_built

    t0 = time.perf_counter()
    ensure_built()
    log(f"[setup] native host library ready in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    j = os.path.join
    pool = ProcessPoolExecutor(4)
    try:
        gens = {
            "lr": pool.submit(_gen_lr, j(tmp, "reads.fastq"), N_LR),
            "match": pool.submit(_gen_match, j(tmp, "segs.tsv"),
                                 j(tmp, "sr.tsv"), N_SEG),
        }
        if not args.four:
            gens["bam"] = pool.submit(_gen_bam, tmp)
            gens["lr_small"] = pool.submit(
                _gen_lr, j(tmp, "reads_small.fastq"), N_LR_CPU)
            gens["match_small"] = pool.submit(
                _gen_match, j(tmp, "segs_small.tsv"),
                j(tmp, "sr_small.tsv"), N_SEG_CPU)
            kern = run_child("kernels")
            walls = phase_cli(tmp, gens)
            log("[c] smoke walls (s, not benchmark results): "
                + json.dumps({k: round(v, 1) for k, v in walls.items()})
                + f" on {card}")
            log("[b] device times (s): " + json.dumps(kern)
                + f" on {card}")
        else:
            if dev["count"] < 4:
                raise SystemExit(f"--four needs 4 GPUs, found {dev['count']}")
            phase_four(tmp, gens)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.0f} s; card: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
