"""`match_trie` stage driver — TSV-parity port of the reference's flagship.

Input/behavior contract (scTagger.py:758-790):
  * barcodes: col 0 of the SR TSV, in file order (bid = line index); all must
    have uniform length == --barcode-length (asserted).
  * long reads: cols 0 and 3 of EVERY row of the LR TSV (including dist=-1
    rows, whose segment is empty and can never match).
  * output row per MATCHED read only, ascending read id:
      name \t e \t n_bids \t seg \t bc1,bc2,...
    where the tie list is sorted by (bid, strand) with strand False (revcomp)
    before True (forward), and revcomp matches print rev_compl(barcode).
  * output gzipped only if the path ends with 'gz'.
  * --mem and --plotfile are accepted and unused (reference parity:
    scTagger.py:88-95,141 — parsed, never consumed).

Optional batch-granular checkpointing: with SCTAG_CHECKPOINT_DIR set, the
input is processed in SCTAG_CHECKPOINT_BATCH-row batches whose rendered rows
persist as part files; re-runs skip completed batches (pipeline/checkpoint).
Because batches are contiguous rid ranges and output rows are ascending-rid
within a batch, concatenating parts reproduces the exact global output.
"""

from __future__ import annotations

import os
import sys

from ..core.packing import rev_compl
from ..io.tsv import open_out, read_lr_segments_tsv, read_sr_barcodes_tsv
from ..models.matcher import match_segments
from ..observability import stage_scope
from ..pipeline.checkpoint import PartStore, job_key
from ..utils import batch_iter


def run(args) -> None:
    with stage_scope("match_trie") as stats:
        _run(args, stats)


def _render_rows(result, names, segs, barcodes, rid_offset: int = 0) -> str:
    fwd_strs = list(barcodes)
    rc_strs = [rev_compl(b) for b in barcodes]
    out = []
    for i in range(result.rids.size):
        rid = int(result.rids[i])
        ties = result.ties_of(i)
        matches = ",".join(
            fwd_strs[p >> 1] if p & 1 else rc_strs[p >> 1] for p in ties
        )
        out.append(
            f"{names[rid_offset + rid]}\t{result.dists[i]}\t{ties.size}\t"
            f"{segs[rid]}\t{matches}\n"
        )
    return "".join(out)


def _ascii_batch(names, s: int, e: int, seg_b) -> bool:
    """True iff the batch's names and segment bytes are pure ASCII (then the
    native latin-1 part bytes decode identically under load_text's UTF-8)."""
    if not all(n.isascii() for n in names[s:e]):
        return False
    buf = getattr(seg_b, "buf", None)
    offs = getattr(seg_b, "offs", None)
    if buf is None or offs is None or len(seg_b) == 0:
        return buf is not None
    lo, hi = int(offs[0]), int(offs[-1])
    return not bool((buf[lo:hi] > 127).any())


def _run(args, stats) -> None:
    barcodes = read_sr_barcodes_tsv(args.short_read_barcodes)
    print(f"There are {len(barcodes):,} SR barcodes", file=sys.stderr)
    barcode_lens = {len(b) for b in barcodes}
    assert barcode_lens == {args.barcode_length}, barcode_lens

    n_hosts = getattr(args, "n_hosts", 1) or 1
    if n_hosts > 1:
        _run_multi(args, stats, barcodes, n_hosts)
        return

    names, _, _, segs = read_lr_segments_tsv(args.long_read_segments)
    print(f"There are {len(names):,} LRs", file=sys.stderr)

    stats.count("barcodes", len(barcodes))
    stats.count("reads", len(names))

    # the batch size defines the part-span geometry, so it MUST key the
    # store: a resume with a different SCTAG_CHECKPOINT_BATCH (or across a
    # default change) would otherwise silently reuse parts whose row spans
    # no longer match
    batch = int(os.environ.get("SCTAG_CHECKPOINT_BATCH", 524_288))
    store = PartStore(
        "match_trie",
        job_key(
            "match_trie",
            [args.long_read_segments, args.short_read_barcodes],
            {"mr": args.max_error, "bl": args.barcode_length, "batch": batch},
        ),
    )
    if args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive match
        # (the native writer opens only after matching; the pre-r3 Python
        # writer opened upfront and we keep that contract)
        open(args.outfile, "wb").close()
    n_matched = 0
    with stats.timer("match"):
        if store.enabled:
            # Batched path parity with the single-shot path:
            # (1) buckets fitted ONCE over the global length distribution and
            # pinned via MatchContext, so shifted per-batch distributions
            # cannot mint new compiled kernel shapes; (2) the neighborhood
            # index builds once and is reused by every batch; (3) batches
            # after the first probe EVERY slice (their pipeline is warm);
            # (4) parts are written by the native TSV formatter (plain text;
            # the final file is assembled through open_out as before).
            from concurrent.futures import ThreadPoolExecutor

            from ..core.packing import seq_lengths
            from ..io.tsv import write_match_tsv_native
            from ..models.matcher import MatchContext, fit_buckets

            ctx = MatchContext(
                barcodes,
                buckets=fit_buckets(seq_lengths(segs)),
                pipelined=True,
            )
            outfile = open_out(args.outfile, force_gzip=False)
            spans = list(batch_iter(len(segs), batch))

            def _match(bi: int):
                s, e = spans[bi]
                return match_segments(
                    segments=segs[s:e],
                    barcodes=barcodes,
                    max_error=args.max_error,
                    progress=True,
                    ctx=ctx,
                    probe_first=(bi > 0),
                )

            # two-deep batch pipeline: batch bi+1 runs CONCURRENTLY with
            # batch bi (2 workers), so bi+1's host phases (encode, probe,
            # async dispatch) fill the gaps while bi's device tail drains
            # and its part writes — without this, every checkpoint boundary
            # stalls the device for a full drain+render+write
            pool = ThreadPoolExecutor(2)
            futs: dict[int, object] = {}

            def _ensure(bi: int) -> None:
                if (
                    0 <= bi < len(spans)
                    and bi not in futs
                    and not store.has(bi, "tsv")
                ):
                    futs[bi] = pool.submit(_match, bi)

            from ..utils import progress_bar

            bar = progress_bar(total=len(segs), desc="match", unit="seg")
            try:
                _ensure(0)
                _ensure(1)
                for bi, (s, e) in enumerate(spans):
                    _ensure(bi + 1)
                    result = futs.pop(bi).result() if bi in futs else None
                    _ensure(bi + 2)
                    if result is None:
                        text = store.load_text(bi)
                        stats.count("batches_skipped")
                    else:
                        seg_b = segs[s:e]
                        # ASCII guard: part files are read back with
                        # load_text (UTF-8); the native writer emits raw
                        # latin-1 bytes, which only coincide for ASCII —
                        # non-ASCII names/segments (out-of-spec FASTQ) take
                        # the Python text path instead of crashing resume
                        ok = _ascii_batch(names, s, e, seg_b) and store.save_file(
                            bi, "tsv",
                            lambda p: write_match_tsv_native(
                                p, names[s:e], seg_b, barcodes, result
                            ),
                        )
                        if not ok:
                            store.save_text(
                                bi,
                                _render_rows(result, names, seg_b, barcodes,
                                             rid_offset=s),
                            )
                        text = store.load_text(bi)
                        stats.count("batches_computed")
                    n_matched += text.count("\n")  # exact for cached parts too
                    outfile.write(text)
                    bar.update(e - s)
            finally:
                bar.close()
                pool.shutdown(wait=True)
            if outfile is not sys.stdout:
                outfile.close()
        else:
            result = match_segments(
                segments=segs,
                barcodes=barcodes,
                max_error=args.max_error,
                progress=True,
            )
            n_matched = int(result.rids.size)
            wrote = False
            if args.outfile is not None:
                from ..io.tsv import write_match_tsv_native

                wrote = write_match_tsv_native(
                    args.outfile, names, segs, barcodes, result
                )
            if not wrote:
                outfile = open_out(args.outfile, force_gzip=False)
                outfile.write(_render_rows(result, names, segs, barcodes))
                if outfile is not sys.stdout:
                    outfile.close()
    stats.count("matched", n_matched)


def _run_multi(args, stats, barcodes, n_hosts: int) -> None:
    """Sharded flagship: contiguous LR row ranges per host, replicated
    whitelist, host-0 part merge. Shards are contiguous global-rid ranges and
    rows render in ascending rid within a shard, so concatenation reproduces
    the single-stream sorted-by-rid output byte for byte (scTagger.py:777)."""
    from ..io.sharding import read_tsv_shard
    from ..parallel.multihost import make_host_group

    group = make_host_group(
        args,
        "match_trie",
        [args.long_read_segments, args.short_read_barcodes],
        {"mr": args.max_error, "bl": args.barcode_length},
    )
    _, lines = read_tsv_shard(args.long_read_segments, args.host_id, n_hosts)
    names, segs = [], []
    for line in lines:
        c = line.split("\t")
        names.append(c[0])
        segs.append(c[3])
    print(
        f"[host {args.host_id}/{n_hosts}] {len(names):,} LRs in shard",
        file=sys.stderr,
    )
    stats.count("barcodes", len(barcodes))
    stats.count("reads", len(names))
    with stats.timer("match"):
        result = match_segments(
            segments=segs,
            barcodes=barcodes,
            max_error=args.max_error,
            progress=True,
        )
        text = _render_rows(result, names, segs, barcodes)
    stats.count("matched", int(result.rids.size))
    group.write_part_and_merge(
        args.outfile, text, lambda p: open_out(p, force_gzip=False)
    )
