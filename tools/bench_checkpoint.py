#!/usr/bin/env python3
"""Checkpointed-flagship benchmark.

Runs the REAL match_trie stage via cli_main in ONE process (start-up and
compiles amortized by a warmup run):
  1. warmup uncheckpointed run (compiles),
  2. timed uncheckpointed run,
  3. timed run with SCTAG_CHECKPOINT_DIR set (cold store: every batch
     computed and written as a native part file),
  4. timed resume run over the populated store (all batches cached).

Writes bench_out/checkpoint_bench.json. Done-criterion: (3) within ~5% of (2).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SEGS = int(os.environ.get("SCTAG_BENCH_SEGS", 1_048_576))


def main() -> None:
    from bench import make_inputs

    from sctagger.runtime import configure_jax

    configure_jax()
    from sctagger.cli import main as cli_main

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sctag_ckpt_bench_"))
    try:
        segs, barcodes = make_inputs(N_SEGS)
        sr = tmp / "sr.tsv"
        sr.write_text("".join(f"{b}\t7\n" for b in barcodes))
        lr = tmp / "lr.tsv"
        with open(lr, "w") as f:
            f.writelines(
                f"read{i}\t0\t4\t{s}\n" for i, s in enumerate(segs)
            )
        del segs

        argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2",
                "-t", "1", "-o", str(tmp / "out.tsv")]

        def run(tag: str, ckpt: bool) -> float:
            if ckpt:
                os.environ["SCTAG_CHECKPOINT_DIR"] = str(tmp / "ckpt")
            else:
                os.environ.pop("SCTAG_CHECKPOINT_DIR", None)
            t0 = time.perf_counter()
            cli_main(argv)
            dt = time.perf_counter() - t0
            print(f"[{tag}] {dt:.2f}s = {N_SEGS / dt:,.0f} segs/s",
                  file=sys.stderr)
            return dt

        run("warmup", ckpt=False)
        t_plain = run("uncheckpointed", ckpt=False)
        base = (tmp / "out.tsv").read_bytes()
        t_ckpt = run("checkpointed-cold", ckpt=True)
        assert (tmp / "out.tsv").read_bytes() == base, "ckpt output differs"
        t_resume = run("checkpointed-resume", ckpt=True)
        assert (tmp / "out.tsv").read_bytes() == base, "resume output differs"
        os.environ.pop("SCTAG_CHECKPOINT_DIR", None)

        out = {
            "n_segments": N_SEGS,
            "uncheckpointed": {"wall_s": round(t_plain, 3),
                               "segs_per_s": round(N_SEGS / t_plain, 1)},
            "checkpointed_cold": {"wall_s": round(t_ckpt, 3),
                                  "segs_per_s": round(N_SEGS / t_ckpt, 1)},
            "checkpointed_resume": {"wall_s": round(t_resume, 3),
                                    "segs_per_s": round(N_SEGS / t_resume, 1)},
            "cold_vs_plain": round(t_ckpt / t_plain, 3),
            "batch_rows": int(os.environ.get("SCTAG_CHECKPOINT_BATCH",
                                             524_288)),
            "date": time.strftime("%Y-%m-%d"),
            "note": ("one process, warm backend/compiles; byte-identical "
                     "outputs asserted across all runs"),
        }
        dest = pathlib.Path(__file__).resolve().parent.parent / "bench_out"
        dest.mkdir(exist_ok=True)
        (dest / "checkpoint_bench.json").write_text(json.dumps(out, indent=1))
        print(json.dumps(out))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
