#!/usr/bin/env python3
"""Time the stage-3 Pallas kernel against the plain-jnp path on a GPU.

    python tools/bench_kernels.py            # kernel vs plain at real widths
    python tools/bench_kernels.py --sweep    # tile / warp sweep
    python tools/bench_kernels.py --e2e      # end to end through match_trie

Shapes: 131,072 segments x 50,176 padded patterns (Ls=24, and a ragged
16-64 bucket). The plain version is the unrolled jnp sweep XLA fuses
(ops/myers.py match_min_tiled). ``--e2e`` runs match_trie (1,048,576
segments x 25,000 barcodes, mr=2) in process, in the order kernel, plain,
plain, kernel. Both legs take the same streamed matcher path (prefilter
probe overlapped with the device chunks); the plain leg swaps only the
device sweep: each chunk goes to ops/myers.py match_full_ref, the jnp twin
with the kernel's output contract, instead of the Pallas kernel.

Prints one JSON line per measurement, each with the device and the
nvidia-smi card line. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tools"), str(REPO / "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cuda")

import chip_smoke  # noqa: E402

CARD = chip_smoke.card_line()


def emit(rec: dict) -> None:
    import jax

    d = jax.devices()[0]
    rec.update(device=d.device_kind, platform=d.platform, card=CARD)
    print(json.dumps(rec), flush=True)


def _timed(fn, reps: int = 3) -> float:
    return chip_smoke._timed(fn, reps)[1]


def stage3(sweep: bool) -> None:
    import jax.numpy as jnp
    import numpy as np

    from sctagger.ops import match_pallas as mp
    from sctagger.ops.myers import build_peq_multi, match_min_tiled

    for ragged in (False, True):
        codes, lens, pats, ls = chip_smoke._stage3_inputs(
            131_072, ragged=ragged, seed=1
        )
        R = codes.shape[0]
        peq = np.zeros((5, 50_176), np.int32)
        peq[:, : pats.shape[0]] = build_peq_multi(pats)
        seg_T = jnp.asarray(mp.prep_segs_T(codes, ls, r_pad=R))
        peq_rows = jnp.asarray(mp.prep_peq_rows(peq))
        tag = "ragged16-64" if ragged else "flagship"
        configs = [(mp.DEF_BR, mp.DEF_BP, mp.NUM_WARPS)]
        if sweep:
            configs += [(16, 64, 4), (32, 128, 4), (64, 64, 4), (64, 64, 8),
                        (32, 64, 2), (64, 128, 8), (16, 128, 4)]
        for br, bp, nw in configs:
            ml = jnp.asarray(mp.tile_maxlens(lens, R, br))
            try:
                t = _timed(lambda: mp._match_full(
                    seg_T, peq_rows, ml, 16, br, bp, False, nw))
            except Exception as e:  # a tile the compiler refuses
                emit({"bench": "stage3_kernel", "shape": tag, "br": br,
                      "bp": bp, "num_warps": nw, "error": str(e)[:300]})
                continue
            emit({"bench": "stage3_kernel", "shape": tag, "br": br, "bp": bp,
                  "num_warps": nw, "seconds": t,
                  "pair_chars_per_s": R * 50_176 * float(np.mean(lens)) / t})
        # plain: the fused min sweep alone (the plain matcher's pass 1)
        peq_j = jnp.asarray(np.pad(peq, ((0, 0), (0, 4096 * 13 - 50_176))))
        seg_i = seg_T.astype(jnp.int32)
        t = _timed(lambda: match_min_tiled(seg_i, peq_j, 16, r_tile=16384,
                                           p_tile=4096), reps=2)
        emit({"bench": "stage3_plain_min", "shape": tag, "seconds": t})


def e2e() -> None:
    """match_trie walls in process, kernel vs plain sweep, order K P P K;
    the two outputs must be byte-identical."""
    import functools

    import jax
    import jax.numpy as jnp

    from sctagger.cli import main as cli_main
    from sctagger.ops import match_pallas as mp
    from sctagger.ops.myers import match_full_ref
    from sctagger.utils import round_up

    tmp = tempfile.mkdtemp(prefix="bench_kernels_")
    j = os.path.join
    segs = chip_smoke._gen_match(j(tmp, "segs.tsv"), j(tmp, "sr.tsv"),
                                 chip_smoke.N_SEG)
    kernel = mp.match_full
    P_TILE = 3584  # the plain sweep's tile in chip_smoke phase b

    @functools.partial(jax.jit, static_argnames=("m",))
    def plain_full(seg_T, peq_rows, maxlens, m, interpret=False):
        # same inputs and (TIES_K+2, R) output as the kernel; chunk rows are
        # multiples of 4096, pattern columns are padded to a P_TILE multiple
        # with empty patterns (the kernel pads with them too)
        p = peq_rows.shape[1]
        peq = jnp.pad(peq_rows[:5], ((0, 0), (0, round_up(p, P_TILE) - p)))
        return match_full_ref(seg_T.astype(jnp.int32), peq, m,
                              k=mp.TIES_K, r_tile=4096, p_tile=P_TILE)

    def run(plain: bool) -> float:
        mp.match_full = plain_full if plain else kernel
        t0 = time.perf_counter()
        try:
            cli_main(["match_trie", "-lr", segs, "-sr", j(tmp, "sr.tsv"),
                      "-mr", "2", "-o", j(tmp, "m.tsv")])
        finally:
            mp.match_full = kernel
        return time.perf_counter() - t0

    outs = {}
    for plain in (False, True):  # warm-up: compiles
        run(plain)
        with open(j(tmp, "m.tsv"), "rb") as f:
            outs[plain] = f.read()
    if outs[False] != outs[True]:
        raise SystemExit("kernel and plain sweep outputs differ")
    walls = {"kernel": [], "plain": []}
    for plain in (False, True, True, False):
        walls["plain" if plain else "kernel"].append(run(plain))
    emit({"bench": "e2e_match_trie", "walls_s": walls,
          "identical_bytes": len(outs[False])})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    import jax

    from sctagger.runtime import configure_jax

    configure_jax()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    if args.e2e:
        e2e()
    else:
        stage3(args.sweep)


if __name__ == "__main__":
    main()
