"""`extract_lr_bc` stage driver — adapter localization on long reads.

Mirrors the reference pipeline (scTagger.py:362-383): FASTQ ingest ->
adapter scan (device) -> global range detection (host, unless preset via -g)
-> per-read filtering -> TSV (gzipped whenever -o is given) -> optional plot.

Output row (scTagger.py:317-320): rname \t dist \t loc \t seq[s:e or None]
with Python slicing semantics (negative indices, e==0 -> slice to end), and
dist=-1 / loc='NA' / empty segment for invalid reads.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.ranges import (
    RangeMembership,
    detect_ranges,
    filter_alignments,
    find_peak_ranges_hist,
)
from ..io.fastq import read_fastqs
from ..io.sharding import read_fastq_shard
from ..io.tsv import open_out
from ..models.adapter import AdapterScanResult, scan_adapters
from ..observability import stage_scope
from ..pipeline.checkpoint import PartStore, job_key
from ..utils import PROF, batch_iter, prof_timer


def run(args) -> None:
    PROF.clear()  # per-run phase timers (utils.prof_timer)
    with stage_scope("extract_lr_bc") as stats:
        _run(args, stats)


def _detect_ranges_dist(group, locs_f: np.ndarray, locs_r: np.ndarray):
    """Cross-host range detection: per-strand location histograms are
    psum-merged so every host runs identical peak extraction (the global
    barrier between stage-1's two passes, SURVEY.md §3.1)."""
    quiet = group.host_id != 0
    out = []
    imax = np.iinfo(np.int64).max
    imin = np.iinfo(np.int64).min
    for locs, label in ((locs_f, "+"), (locs_r, "-")):
        locs = np.asarray(locs, dtype=np.int64)
        lmin = int(locs.min()) if locs.size else imax
        lmax = int(locs.max()) if locs.size else imin
        gmin = int(group.allreduce(np.array([lmin], np.int64), "min")[0])
        gmax = int(group.allreduce(np.array([lmax], np.int64), "max")[0])
        if gmin > gmax:  # no qualifying locations on any host
            ranges = []
        else:
            F = np.bincount(locs - gmin, minlength=gmax - gmin + 1)
            F = group.allreduce(F.astype(np.int64), "sum")
            ranges = find_peak_ranges_hist(
                F.astype(np.float64), gmin, quiet=quiet
            )
        if not quiet:
            print(
                f"Found these ranges on {label} strand:\t{ranges}",
                file=sys.stderr,
            )
        out.append(ranges)
    return out


def _stream_batches(args, q):
    """Consumer-side iterator over the producer thread's parse queue."""
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _run_stream(args, stats):
    """Single-host streaming path: FASTQ parse (producer thread, C-level
    inflate releases the GIL) overlaps encode+dispatch+collect (consumer) —
    the ROADMAP 'stage-1 host-phase overlap' item. Returns
    (rnames, seqs: ChainSeqBuffer, scan) or None if the native streaming
    parser is unavailable (callers use the one-shot path then)."""
    import queue
    import threading

    from ..io.fastq import read_fastqs_stream
    from ..models.adapter import scan_adapters_stream

    try:
        from ..native import build as native_build

        native_build.load()
    except Exception:
        return None

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()  # consumer died: stop parsing, free the stream

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    # the d0 exact-adapter RAW scan runs here on the producer thread: the
    # batch bytes are cache-hot right after the parse, and the probe stops
    # competing with encode/dispatch/collect on the consumer core (the
    # apply half — tiny numpy on the hit subsets — stays with the model).
    # make_d0_scanner is None for multi-word adapters, the one case where
    # scan_adapters_stream delegates to the one-shot path (which would
    # discard the raw results unread).
    from ..models.adapter import make_d0_scanner

    d0 = make_d0_scanner(args.short_read_adapter)

    def _produce():
        # time the parse itself, not the q.put backpressure wait (the queue
        # fills whenever the consumer is the bottleneck; counting that wait
        # made read_fastq look like 13s of a 3s parse in the sustained bench)
        #
        # r5: the host-prefilter raw scan moved OFF the parse loop onto its
        # own single worker (attached to the queue item as a future), so
        # batch i's probe overlaps batch i+1's parse — with the d<=1 tier
        # resolving ~99% of reads the pipeline had become producer-SERIAL
        # bound (parse + probe back to back on this thread, consumer idle).
        # The ctypes probe releases the GIL, so the overlap is real.
        from concurrent.futures import ThreadPoolExecutor

        probe_pool = ThreadPoolExecutor(1) if d0 is not None else None

        def _timed_raw(sb):
            with prof_timer("scan.d0probe"):
                return d0.raw(sb)

        from ..utils import progress_bar

        try:
            it = read_fastqs_stream(args.reads, args.gzipped)
            bar = progress_bar(desc="reads", unit="read")
            try:
                while True:
                    with prof_timer("stage.read_fastq"):
                        b = next(it, None)
                    if b is not None:
                        bar.update(len(b[1]))
                        if d0 is not None:
                            b = (b[0], b[1],
                                 probe_pool.submit(_timed_raw, b[1]))
                    if not _put(b) or b is None:
                        return
            finally:
                bar.close()
                it.close()  # finalize: closes the native stream handle
        except BaseException as ex:  # surfaced by _stream_batches
            _put(ex)
        finally:
            if probe_pool is not None:
                # queued futures are still owned by already-enqueued batch
                # items the consumer will .result() — cancel them ONLY when
                # the consumer is gone (a cancel at normal EOF would raise
                # CancelledError on the tail batches; r5 review finding)
                probe_pool.shutdown(
                    wait=False, cancel_futures=stop.is_set()
                )

    threading.Thread(target=_produce, daemon=True).start()
    try:
        with stats.timer("adapter_scan"):
            rnames, seqs, scan = scan_adapters_stream(
                _stream_batches(args, q),
                args.short_read_adapter,
                progress=True,
            )
    finally:
        stop.set()  # unblock the producer if we failed mid-stream
    print(
        f"Aligned {args.short_read_adapter} to {len(seqs)} reads",
        file=sys.stderr,
    )
    return rnames, seqs, scan


def _run(args, stats) -> None:
    import os as _os

    n_hosts = getattr(args, "n_hosts", 1) or 1
    multi = n_hosts > 1
    group = None
    # batch size defines each part's read span, so it keys the store (a
    # resume with a different batch would reuse parts with mismatched spans)
    ckpt_batch = int(_os.environ.get("SCTAG_CHECKPOINT_BATCH", 250_000))
    store = PartStore(
        "extract_lr_bc_scan",
        job_key(
            "extract_lr_bc_scan",
            list(args.reads),
            {
                "sa": args.short_read_adapter,
                "z": bool(args.gzipped),
                "batch": ckpt_batch,
            },
        ),
    )
    if not multi and args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive scan
        open(args.outfile, "wb").close()
    streamed = None
    if (
        not multi
        and not store.enabled
        and _os.environ.get("SCTAG_STREAM", "1") != "0"
    ):
        streamed = _run_stream(args, stats)
    if streamed is not None:
        rnames, seqs, scan = streamed
        stats.count("reads", len(seqs))
        stats.timers.update(PROF)
        _emit(args, stats, rnames, seqs, scan, multi, group)
        return
    if multi:
        from ..parallel.multihost import make_host_group

        assert args.plotfile is None, "plotting is single-host only"
        group = make_host_group(
            args,
            "extract_lr_bc",
            list(args.reads),
            {"sa": args.short_read_adapter, "nb": args.num_bp_after},
        )
        with stats.timer("read_fastq"), prof_timer("stage.read_fastq"):
            _, rnames, seqs = read_fastq_shard(
                args.reads, args.host_id, n_hosts, args.gzipped
            )
    else:
        with stats.timer("read_fastq"), prof_timer("stage.read_fastq"):
            rnames, seqs = read_fastqs(args.reads, args.gzipped)
    print(
        f"Aligning {args.short_read_adapter} to {len(seqs)} reads",
        file=sys.stderr,
    )
    stats.count("reads", len(seqs))
    with stats.timer("adapter_scan"):
        if store.enabled and multi:
            # shard-dependent batch contents would collide on one job key
            print(
                "checkpointing disabled for multi-host runs", file=sys.stderr
            )
            store.enabled = False
        if store.enabled:
            # batch-granular scan cache: per-read scan results are position-
            # independent, so batches resume independently; the global parts
            # (range detection, filtering) re-run cheaply from the cache
            batch = ckpt_batch
            parts = []
            for bi, (s, e) in enumerate(batch_iter(len(seqs), batch)):
                if store.has(bi, "npz"):
                    parts.append(store.load_arrays(bi))
                    stats.count("batches_skipped")
                else:
                    r = scan_adapters(
                        seqs[s:e], args.short_read_adapter, progress=True
                    )
                    d = {
                        "strands": r.strands,
                        "dists": r.dists,
                        "flat_locs": r.flat_locs,
                        "loc_counts": r.loc_counts,
                    }
                    store.save_arrays(bi, **d)
                    parts.append(d)
                    stats.count("batches_computed")
            scan = AdapterScanResult(
                strands=np.concatenate([p["strands"] for p in parts])
                if parts else np.empty(0, np.int8),
                dists=np.concatenate([p["dists"] for p in parts])
                if parts else np.empty(0, np.int32),
                flat_locs=np.concatenate([p["flat_locs"] for p in parts])
                if parts else np.empty(0, np.int64),
                loc_counts=np.concatenate([p["loc_counts"] for p in parts])
                if parts else np.empty(0, np.int64),
            )
        else:
            scan = scan_adapters(seqs, args.short_read_adapter, progress=True)
    stats.timers.update(PROF)  # per-phase scan diagnostics (utils.prof_timer)
    _emit(args, stats, rnames, seqs, scan, multi, group)


def _emit(args, stats, rnames, seqs, scan, multi, group) -> None:
    """Shared stage tail: range detection -> filtering -> TSV -> plot."""
    rf_t = prof_timer("stage.ranges_filter").__enter__()
    preset = args.ranges
    if len(preset[0]) + len(preset[1]) == 0:
        if not multi or args.host_id == 0:
            print(
                "No ranges for SR adapters have been preset. "
                "Detecting directly from data...",
                file=sys.stderr,
            )
        read_of = np.repeat(np.arange(len(seqs)), scan.loc_counts)
        in_window = (scan.dists >= 0) & (scan.dists <= 5)
        sel = in_window[read_of]
        is_fwd = (scan.strands == 0)[read_of]
        if multi:
            ranges = _detect_ranges_dist(
                group, scan.flat_locs[sel & is_fwd], scan.flat_locs[sel & ~is_fwd]
            )
        else:
            ranges = detect_ranges(
                scan.flat_locs[sel & is_fwd], scan.flat_locs[sel & ~is_fwd]
            )
        memberships = [RangeMembership(r, include_end=False) for r in ranges]
    else:
        memberships = [RangeMembership(r, include_end=True) for r in preset]

    print("Filtering alignments using ranges", file=sys.stderr)
    dist, loc, s, e, valid = filter_alignments(
        scan.strands,
        scan.dists,
        scan.flat_locs,
        scan.loc_counts,
        memberships,
        args.num_bp_after,
    )

    rf_t.__exit__()
    stats.count("valid", int(valid.sum()))
    # per-distance read counts — the numbers the stage-1 plot encodes
    vals, cnts = np.unique(dist, return_counts=True)
    for v, c in zip(vals, cnts):
        stats.count(f"dist_{'NA' if v == -1 else int(v)}", int(c))
    # seq[s:e or None] without materializing full read strings (SeqBuffer);
    # the invalid-row segment seq[-1:-1] is always ''.
    substr = getattr(seqs, "substr", None) or (
        lambda i, a, b: seqs[i][a:b]
    )

    def _rows():
        # zip semantics of the reference: stop at the shorter list if a
        # trailing FASTQ record is truncated (name without sequence line)
        for i, rname in enumerate(rnames[: len(seqs)]):
            if valid[i]:
                si, ei = int(s[i]), int(e[i])
                yield f"{rname}\t{dist[i]}\t{loc[i]}\t{substr(i, si, ei or None)}\n"
            else:
                yield f"{rname}\t-1\tNA\t\n"

    if multi:
        with prof_timer("stage.write"):
            group.write_part_and_merge(
                args.outfile,
                "".join(_rows()),
                lambda p: open_out(p, force_gzip=True),
            )
    else:
        with prof_timer("stage.write"):
            wrote = False
            if args.outfile is not None:
                from ..io.tsv import write_lr_tsv_gz_native

                print(f"Writng to {args.outfile}", file=sys.stderr)
                wrote = write_lr_tsv_gz_native(
                    args.outfile, rnames, seqs, dist, loc, s, e, valid
                )
            if not wrote:
                outfile = open_out(args.outfile, force_gzip=True)
                if args.outfile is None:
                    print(f"Writng to {outfile}", file=sys.stderr)
                # batched writes: 50K per-row TextIOWrapper.write calls cost
                # ~0.3s
                import itertools

                rows = _rows()
                while True:
                    chunk = list(itertools.islice(rows, 8192))
                    if not chunk:
                        break
                    outfile.write("".join(chunk))
                if outfile is not sys.stdout:
                    outfile.close()

    if args.plotfile is not None:
        from ..plots import plot_extract_lr_bc

        plot_extract_lr_bc(rnames, dist, args.plotfile)
