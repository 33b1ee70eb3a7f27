"""RAFT run on the torch engine: parse, compute, emit.

The counterpart of ``raft_tpu.pipeline.run_pipeline``, with both of its
schedules:

* whole-file: parse everything, one ``compute_torch`` over all reads,
  then the four writers side by side;
* chunked streaming (``chunk_reads``; automatic above
  ``RAFT_AUTO_CHUNK_BYTES``, 2 GB by default): an index pass over the
  reads, the PAF parsed once (or spilled to per-chunk event files with
  ``spill_paf``), then per chunk a byte-range load, ``compute_torch`` and
  append-mode emits, software-pipelined across chunks.

Outputs are byte-identical between the two and to ``raft_tpu``. The
framework-free helpers (run stats, stage timers, the auto-chunk gate, the
event-table views, ``--auto-e`` folding, the ``-e`` advisory, input
checks, the oracle engine), the native I/O and the emitters are imported
from ``raft_tpu`` unchanged; ``raft_tpu.io.native`` builds its library at
first use. All device work runs on the calling thread; the load and emit
pools are host-only.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import sys
import time
import types
from collections import deque

import numpy as np

from raft_tpu import emit
from raft_tpu.io import native
from raft_tpu.io.fasta import (ReadStore, load_reads, parse_sim_align,
                               parse_sim_chr, parse_sim_end_pos,
                               parse_sim_start_pos)
from raft_tpu.io.paf import OverlapTable, load_paf
from raft_tpu.params import AlgoParams
from raft_tpu.pipeline import (RunStats, _apply_auto_e, _auto_chunk_reads,
                               _est_cov_hint, _EventTable,
                               _GroupedEventTable, _sum_output_bytes, _Timer,
                               _validate_inputs, compute_oracle)
from raft_tpu_torch.engine_torch import compute_torch

OUT_NAMES = (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
             ".long_repeats.bed")


@dataclasses.dataclass
class TorchRunStats(RunStats):
    """``RunStats`` plus what this pipeline knows of its own run: whether
    the native C++ I/O library was loaded for the parse (without it the
    Python parsers run, with the same results), the ``(B, W, E)`` shape
    of every bucket the torch engine ran, in run order across chunks, and
    the schedule (``whole`` or ``chunked``) with its number of chunks."""
    native_io: bool = False
    buckets: list = dataclasses.field(default_factory=list)
    schedule: str = "whole"
    n_chunks: int = 1

    def to_json(self) -> dict:
        return {**super().to_json(), "native_io": self.native_io,
                "buckets": [list(b) for b in self.buckets],
                "schedule": self.schedule, "n_chunks": self.n_chunks}

    def on_bucket(self, cfg, *_):
        """``compute_torch(on_bucket=...)`` hook: record the shape."""
        self.buckets.append((cfg.B, cfg.W, cfg.E))

    def bucket_hook(self, also=None):
        """``on_bucket``, chained with the caller's ``also`` hook."""
        if also is None:
            return self.on_bucket

        def hook(cfg, *args):
            self.on_bucket(cfg)
            also(cfg, *args)
        return hook


def load_inputs(read_path: str, paf_path: str, stats: TorchRunStats,
                use_native: bool | None = None,
                verbose: bool = False) -> tuple[ReadStore, OverlapTable]:
    """Parse the reads and the PAF, timed as ``load_reads`` and
    ``load_paf``. The PAF tokenize/intern phase has no dependency on the
    FASTA parse, so it runs beside ``load_reads`` (both native calls
    release the GIL)."""
    pre_fut = None
    if use_native is not False:
        _pre_pool = cf.ThreadPoolExecutor(max_workers=1)
        pre_fut = _pre_pool.submit(native.preparse_paf, paf_path)
        _pre_pool.shutdown(wait=False)

    def _drain_preparse():
        # an exception before resolve must not leave the preparse worker
        # running or leak its native handle
        nonlocal pre_fut
        if pre_fut is None:
            return
        fut, pre_fut = pre_fut, None
        try:
            pre = fut.result()
            if pre is not None:
                pre.close()
        except Exception:
            pass

    try:
        with _Timer(stats, "load_reads"):
            store = load_reads(read_path, use_native=use_native)
        if verbose:
            print(f"Real Reads {int(store.real_reads)} ")
        with _Timer(stats, "load_paf"):
            table = None
            if pre_fut is not None:
                fut, pre_fut = pre_fut, None
                pre = fut.result()
                if pre is not None:
                    table = native.resolve_paf(pre, store)
            if table is None:
                table = load_paf(paf_path, store, use_native=use_native)
    finally:
        _drain_preparse()
    stats.native_io = (use_native is not False
                       and native._get_lib() is not None)
    return store, table


def _report(stats: TorchRunStats, params: AlgoParams, auto_e: bool) -> None:
    """The reference's closing stdout lines, then the ``-e`` advisory on
    stderr (not in ``--auto-e`` mode, where the threshold came from the
    data)."""
    print(f"coverage per window is {stats.coverage_per_window:f} ")
    print("coverage per window/average coverage is "
          f"{stats.coverage_per_window / params.est_cov:f} ")
    print(f"fraction_of_repeat_length {stats.fraction_repeat:f} ")
    if not auto_e:
        _est_cov_hint(stats, params)


def run_pipeline(read_path: str, paf_path: str, params: AlgoParams,
                 engine: str = "torch", strict: bool = True,
                 verbose: bool = True, use_native: bool | None = None,
                 gz_out: bool = False, auto_e: bool = False,
                 device: str = "cuda", chunk_reads: int | None = None,
                 spill_paf: bool | None = None,
                 cov_out: str | None = None,
                 on_bucket=None) -> TorchRunStats:
    """Full RAFT run: parse, compute, emit the four output files.

    ``gz_out`` writes the outputs BGZF-compressed (``.gz``); ``auto_e``
    estimates ``-e`` from the overlap events; ``device`` is where the
    torch engine runs (``cuda`` or ``cpu``); ``cov_out`` is the engine's
    coverage return mode (``host``, ``diff8`` or ``cov``).

    ``chunk_reads`` > 0 runs the chunked streaming schedule in chunks of
    that many reads; 0 forces whole-file; None (the default) streams in
    chunks of ``DEFAULT_CHUNK_READS`` when either input is larger than
    ``RAFT_AUTO_CHUNK_BYTES`` (2 GB), on the torch engine with native
    I/O only — an ``--engine oracle`` or ``--pure-python-io`` run is never
    rerouted. The chunked schedule always runs the torch engine; it falls
    back to whole-file only when the native index is unavailable.
    ``spill_paf`` (chunked only) spills the PAF's coverage events to
    per-chunk files instead of keeping its columns resident; None turns
    it on for PAFs over max(2 GiB, 15% of RAM).

    ``on_bucket(cfg, lens, ev_off, ev_pk)``, where given, sees each torch
    engine bucket's device inputs before its device step, as
    ``compute_torch``'s hook does, in every chunk."""
    if engine not in ("torch", "oracle"):
        raise ValueError(f"unknown engine {engine!r}")
    if chunk_reads is None and engine == "torch" and use_native is not False:
        chunk_reads = _auto_chunk_reads(read_path, paf_path)
        if chunk_reads and verbose:
            print(f"INFO, large input: auto-streaming in chunks of "
                  f"{chunk_reads} reads (--chunk-reads 0 forces "
                  f"whole-file)", file=sys.stderr)
    if chunk_reads:
        if engine != "torch":
            raise ValueError("the chunked schedule runs the torch engine; "
                             "run --engine oracle whole-file "
                             "(--chunk-reads 0)")
        st = _run_pipeline_chunked(read_path, paf_path, params, chunk_reads,
                                   strict=strict, verbose=verbose,
                                   spill_paf=spill_paf, gz_out=gz_out,
                                   cov_out=cov_out, auto_e=auto_e,
                                   device=device, on_bucket=on_bucket)
        if st is not None:
            return st
        if verbose:
            # stderr: stdout stays line-identical to the reference, and
            # the auto-chunk gate reaches this without the user asking
            print("INFO, streaming mode unavailable for this input; "
                  "running whole-file", file=sys.stderr)

    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = TorchRunStats()
    store, table = load_inputs(read_path, paf_path, stats, use_native,
                               verbose)
    if verbose:
        print(f"INFO, Symmetric overlaps {int(table.symmetric)} ")
        print(f"INFO, length of alignments  {table.n_rows}()")

    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    grouped = None
    if auto_e:
        from raft_tpu import auto_e as _auto_e
        with _Timer(stats, "auto_e"):
            info, grouped = _auto_e.estimate_for_table(
                table, store.lens.astype(np.int64), store.n_reads,
                params.reso, params.cov_mul, strict=strict)
        params = _apply_auto_e(params, info)
    if verbose:
        print(f"high_cov {params.high_cov}")

    prefix = params.outputfilename
    un = use_native is not False
    sfx = ".gz" if gz_out else ""
    # in cov_out="host" mode .coverage.txt depends only on the binned
    # events: the engine hands them over before any device work and the
    # emitter runs beside it; in diff8/cov mode it renders from the result
    cov_pool = cf.ThreadPoolExecutor(max_workers=1)
    cov_fut: list = []

    def _on_cov(early_res):
        cov_fut.append(cov_pool.submit(
            emit.write_coverage, prefix + ".coverage.txt" + sfx,
            params.reso, early_res, un, gz=gz_out))

    try:
        with _Timer(stats, "compute"):
            if engine == "oracle":
                from raft_tpu.result import from_per_read_lists
                coverages, repeats, frags, cstats = compute_oracle(
                    store, table, params, strict=strict)
                res = from_per_read_lists(store.n_reads, coverages, repeats,
                                          frags, cstats)
            else:
                res = compute_torch(
                    store, table, params, strict=strict, cov_out=cov_out,
                    on_cov_events=_on_cov, grouped=grouped, device=device,
                    on_bucket=stats.bucket_hook(on_bucket))

        stats.n_reads = store.n_reads
        stats.n_paf_rows = table.n_rows
        stats.symmetric = table.symmetric
        stats.total_coverage = res.total_coverage
        stats.total_windows = res.total_windows
        stats.total_repeat_length = res.total_repeat_length
        stats.total_read_length = res.total_read_length
        if verbose:
            _report(stats, params, auto_e)

        with _Timer(stats, "emit"):
            # the four writers touch disjoint files and release the GIL in
            # the native emitters
            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                futs = [
                    cov_fut[0] if cov_fut else
                    ex.submit(emit.write_coverage,
                              prefix + ".coverage.txt" + sfx,
                              params.reso, res, un, gz=gz_out),
                    ex.submit(emit.write_long_repeats,
                              prefix + ".long_repeats.txt" + sfx, res, un,
                              gz=gz_out),
                    ex.submit(emit.write_long_repeats_bed,
                              prefix + ".long_repeats.bed" + sfx, store,
                              res, un, gz=gz_out),
                    ex.submit(emit.write_fragments_fasta,
                              prefix + ".reads.fasta" + sfx, store, params,
                              res, un, gz=gz_out),
                ]
                for f in futs[:-1]:
                    f.result()
                stats.n_fragments = futs[-1].result()
    finally:
        cov_pool.shutdown()
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    return stats


def _spill_auto(paf_path: str) -> bool:
    """``spill_paf=None`` policy: spill only when the PAF is over 2 GiB
    AND over 15% of this host's RAM. Resident columns take about a
    quarter of the text size, so below that keeping them costs little,
    while the spill costs a second disk pass over the PAF."""
    try:
        ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        ram = 0
    return os.path.getsize(paf_path) > max(2 << 30, int(ram * 0.15))


def _run_pipeline_chunked(read_path: str, paf_path: str, params: AlgoParams,
                          chunk_reads: int, strict: bool = True,
                          verbose: bool = True,
                          spill_paf: bool | None = None,
                          gz_out: bool = False, cov_out: str | None = None,
                          auto_e: bool = False, device: str = "cuda",
                          on_bucket=None) -> TorchRunStats | None:
    """Streaming schedule: index pass → PAF → per-chunk byte-range load,
    ``compute_torch`` and append-mode emit with global numbering offsets.

    Coverage, repeats and chopping depend only on a read's own events, so
    chunk boundaries change no output byte. Returns None when the input
    cannot be indexed (native library unavailable) so the caller runs
    whole-file. With ``spill_paf`` the overlap table is never resident
    either: a native two-pass parse writes per-chunk coverage events to
    spill files that are read back one chunk at a time.

    ``RAFT_CHUNK_TRACE=<path>`` writes one JSON line per chunk (wait,
    load, compute, drain and emit seconds and spans, the engine's stage
    timers) and a summary line; ``RAFT_CHUNK_PENDING`` (default 2) bounds
    the chunks whose emits may still be running."""
    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = TorchRunStats(schedule="chunked", native_io=True)
    bucket_hook = stats.bucket_hook(on_bucket)
    if spill_paf is None:
        spill_paf = _spill_auto(paf_path)

    # The PAF tokenize/intern phase has no FASTA dependency: it runs
    # beside the index scan (both native calls release the GIL), then
    # resolves against the index's name map. The spill binner does its
    # own two-pass read, so it takes no preparse.
    pre_fut = None
    if not spill_paf:
        _pre_pool = cf.ThreadPoolExecutor(max_workers=1)
        pre_fut = _pre_pool.submit(native.preparse_paf, paf_path)
        _pre_pool.shutdown(wait=False)

    def _drain_preparse():
        # join and free the preparse worker on every exit that did not
        # consume it: an index or resolve error must not leave it
        # tokenizing after the exception or leak its native handle
        nonlocal pre_fut
        if pre_fut is None:
            return
        fut, pre_fut = pre_fut, None
        try:
            pre = fut.result()
            if pre is not None:
                pre.close()
        except Exception:
            pass

    try:
        with _Timer(stats, "index"):
            idx = native.index_reads(read_path)
        if idx is None or idx["n"] == 0:
            return None
        n = idx["n"]
        if verbose:
            print(f"Real Reads {int(idx['real_reads'])} ")

        bins = None
        table = None
        if spill_paf:
            with _Timer(stats, "load_paf"):
                bins = native.bin_paf_events(paf_path, idx, n, chunk_reads)
            if bins is not None and strict and bins.n_unknown:
                bins.close()
                raise ValueError(
                    f"PAF names {bins.n_unknown} read(s) absent from the "
                    "input FASTA (undefined behavior in reference RAFT); "
                    "pass strict=False to drop them")
        if bins is None:
            with _Timer(stats, "load_paf"):
                # the PAF interns against the index handle's name map
                shim = types.SimpleNamespace(_native_handle=idx["handle"])
                if pre_fut is not None:
                    fut, pre_fut = pre_fut, None
                    pre = fut.result()
                    if pre is not None:
                        table = native.resolve_paf(pre, shim)
                if table is None:
                    table = native.load_paf(paf_path, shim)
                if table is None:
                    return None
    finally:
        _drain_preparse()

    symmetric = bins.symmetric if bins is not None else table.symmetric
    n_paf_rows = bins.n_rows if bins is not None else table.n_rows
    if verbose:
        print(f"INFO, Symmetric overlaps {int(symmetric)} ")
        print(f"INFO, length of alignments  {n_paf_rows}()")

    params = params.replace(real_reads=idx["real_reads"],
                            symmetric_overlaps=symmetric)
    idx_lens = idx["lens"]

    g_off = g_w0 = g_w1 = None
    if bins is None:
        # whole-input events, read-grouped and window-binned in one native
        # counting-sort pass over the index's read lengths; each chunk
        # takes a slice. Runs before the high_cov line because --auto-e
        # derives est_cov from these events.
        with _Timer(stats, "group_events"):
            eg = getattr(table, "events_grouped", None)
            g = (eg(n, idx_lens, params.reso, strict=strict)
                 if eg is not None else None)
            if g is not None:
                g_off, g_w0, g_w1 = g
            if g_off is None:
                # fallback: all events once, sorted by read id
                ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
                order = np.argsort(ev_read, kind="stable")
                ev_read = ev_read[order]
                ev_lo = ev_lo[order]
                ev_hi = ev_hi[order]

    if auto_e:
        from raft_tpu import auto_e as _auto_e
        with _Timer(stats, "auto_e"):
            if bins is not None:
                info = _auto_e.estimate_for_bins(
                    bins, idx_lens, params.reso, params.cov_mul,
                    chunk_reads)
            elif g_off is not None:
                info = _auto_e.estimate_from_hist(
                    _auto_e.cov_histogram_grouped(
                        g_off, g_w0, g_w1,
                        np.asarray(idx_lens, dtype=np.int64), params.reso),
                    params.cov_mul)
            else:
                info = _auto_e.estimate_from_hist(
                    _auto_e.cov_histogram_events(
                        ev_read, ev_lo, ev_hi,
                        np.asarray(idx_lens, dtype=np.int64), params.reso),
                    params.cov_mul)
        params = _apply_auto_e(params, info)
    if verbose:
        print(f"high_cov {params.high_cov}")

    # Software pipeline across chunks: chunk k+1's load prefetches while
    # chunk k computes, and chunk k's emits run while k+1 computes. One
    # single-worker pool per output file keeps each file's appends in
    # chunk order while the four files write concurrently. Global fragment
    # numbering needs only each chunk's fragment count, which compute
    # delivers before emit, so emit never gates the next chunk. At most
    # current + prefetched + RAFT_CHUNK_PENDING chunk stores are alive.
    cov_pool = cf.ThreadPoolExecutor(max_workers=1)
    emit_pools = [cf.ThreadPoolExecutor(max_workers=1) for _ in range(3)]
    load_pool = cf.ThreadPoolExecutor(max_workers=1)
    prefix = params.outputfilename
    sfx = ".gz" if gz_out else ""
    rec_off = idx["rec_off"]
    names = idx["names"]
    max_pending = max(1, int(os.environ.get("RAFT_CHUNK_PENDING", "2")))

    trace_path = os.environ.get("RAFT_CHUNK_TRACE")
    T0 = time.perf_counter()

    def _span(t0, t1):
        return [round(t0 - T0, 3), round(t1 - T0, 3)]

    def _load_chunk(lo, hi, rec=None):
        t0 = time.perf_counter()
        store = native.load_reads_range(
            idx["data_path"], int(rec_off[lo]), int(rec_off[hi]),
            fastq=idx["fastq"])
        t1 = time.perf_counter()
        store.real_reads = params.real_reads
        if not params.real_reads and not native.attach_sim_meta(store):
            # degenerate names: per-name python parse (exact contract)
            cn = names[lo:hi]
            store.start_pos = np.asarray(
                [parse_sim_start_pos(nm) for nm in cn], dtype=np.int64)
            store.end_pos = np.asarray(
                [parse_sim_end_pos(nm) for nm in cn], dtype=np.int64)
            store.align = [parse_sim_align(nm) for nm in cn]
            store.chrom = [parse_sim_chr(nm) for nm in cn]
        if bins is not None:
            er, el, eh = bins.events_for_bin(lo // chunk_reads)
            sub_table = _EventTable(er - lo, el, eh, symmetric)
        elif g_off is not None:
            o = g_off[lo:hi + 1]
            sub_table = _GroupedEventTable(o - o[0],
                                           g_w0[int(o[0]):int(o[-1])],
                                           g_w1[int(o[0]):int(o[-1])],
                                           symmetric)
        else:
            a, b = np.searchsorted(ev_read, [lo, hi])
            sub_table = _EventTable(ev_read[a:b] - lo, ev_lo[a:b],
                                    ev_hi[a:b], symmetric)
        if rec is not None:
            t2 = time.perf_counter()
            rec["load_span"] = _span(t0, t2)
            rec["load_read_s"] = round(t1 - t0, 3)
            rec["load_events_s"] = round(t2 - t1, 3)
        return store, sub_table

    def _timed_emit(fn, rec, key, *a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        t1 = time.perf_counter()
        rec[key] = round(t1 - t0, 3)
        rec[key.replace("_s", "_span")] = _span(t0, t1)
        return r

    def _submit(pool, rec, key, fn, *a, **k):
        if rec is None:
            return pool.submit(fn, *a, **k)
        return pool.submit(_timed_emit, fn, rec, key, *a, **k)

    chunks = [(lo, min(lo + chunk_reads, n))
              for lo in range(0, n, chunk_reads)]
    stats.n_chunks = len(chunks)
    recs = [dict(ci=ci, lo=lo, hi=hi) if trace_path else None
            for ci, (lo, hi) in enumerate(chunks)]

    def _chunk_loop() -> int:
        # every emit future is drained here, so any I/O error surfaces
        # inside the teardown guard below
        next_fut = load_pool.submit(_load_chunk, *chunks[0], rec=recs[0])
        pending: deque = deque()
        frag_num = 1
        for ci, (lo, hi) in enumerate(chunks):
            app = ci > 0
            rec = recs[ci]
            t_wait = time.perf_counter()
            with _Timer(stats, "load_reads"):
                store, sub_table = next_fut.result()
            if rec is not None:
                rec["wait_load_s"] = round(time.perf_counter() - t_wait, 3)
            if ci + 1 < len(chunks):
                next_fut = load_pool.submit(_load_chunk, *chunks[ci + 1],
                                            rec=recs[ci + 1])
            t_drain = time.perf_counter()
            while len(pending) > max_pending:
                for f in pending.popleft():
                    f.result()
            if rec is not None:
                rec["drain_s"] = round(time.perf_counter() - t_drain, 3)

            # coverage emission overlaps this chunk's device work (its
            # only input, the chunk's binned events, exists before it);
            # the FIFO cov pool keeps the append order across chunks
            cov_fut: list = []

            def _on_cov(early_res, _lo=lo, _app=app, _rec=rec):
                cov_fut.append(_submit(
                    cov_pool, _rec, "emit_cov_s", emit.write_coverage,
                    prefix + ".coverage.txt" + sfx, params.reso, early_res,
                    first_read_index=_lo, append=_app, gz=gz_out))

            eng_timers: dict = {}
            t_comp = time.perf_counter()
            with _Timer(stats, "compute"):
                res = compute_torch(store, sub_table, params, strict=strict,
                                    cov_out=cov_out, on_cov_events=_on_cov,
                                    timers_out=eng_timers, device=device,
                                    on_bucket=bucket_hook)
            if rec is not None:
                t1 = time.perf_counter()
                rec["compute_s"] = round(t1 - t_comp, 3)
                rec["compute_span"] = _span(t_comp, t1)
                rec["engine"] = {k: round(v, 3)
                                 for k, v in eng_timers.items()}
                rec["n_events"] = int(sub_table.n_rows)

            frag_base = frag_num
            frag_num += res.n_frags
            stats.total_coverage += res.total_coverage
            stats.total_windows += res.total_windows
            stats.total_repeat_length += res.total_repeat_length
            stats.total_read_length += res.total_read_length

            if not cov_fut:  # diff8/cov modes: coverage renders from res
                cov_fut.append(_submit(
                    cov_pool, rec, "emit_cov_s", emit.write_coverage,
                    prefix + ".coverage.txt" + sfx, params.reso, res,
                    first_read_index=lo, append=app, gz=gz_out))
            pending.append([
                _submit(emit_pools[0], rec, "emit_fasta_s",
                        emit.write_fragments_fasta,
                        prefix + ".reads.fasta" + sfx, store, params, res,
                        first_read_num=frag_base, append=app, gz=gz_out),
                _submit(emit_pools[1], rec, "emit_lr_s",
                        emit.write_long_repeats,
                        prefix + ".long_repeats.txt" + sfx, res,
                        first_read_index=lo, append=app, gz=gz_out),
                _submit(emit_pools[2], rec, "emit_bed_s",
                        emit.write_long_repeats_bed,
                        prefix + ".long_repeats.bed" + sfx, store, res,
                        append=app, gz=gz_out),
            ] + cov_fut)

        with _Timer(stats, "emit"):
            while pending:
                for f in pending.popleft():
                    f.result()
        return frag_num

    try:
        frag_num = _chunk_loop()
    except BaseException:
        # mid-run failure (emit I/O, compute or load error): tear the
        # pools down without waiting on queued work, release the spill
        # files, and name the outputs that hold truncated data
        for p in emit_pools + [cov_pool, load_pool]:
            p.shutdown(wait=False, cancel_futures=True)
        if bins is not None:
            bins.close()
        partial = [prefix + nm + sfx for nm in OUT_NAMES
                   if os.path.exists(prefix + nm + sfx)]
        if partial:
            print("ERROR, streaming run aborted mid-emit; these outputs "
                  "are PARTIAL and must be discarded: "
                  + " ".join(partial), file=sys.stderr)
        raise

    if trace_path:
        with open(trace_path, "w") as tf:
            for rec in recs:
                tf.write(json.dumps(rec) + "\n")
            tf.write(json.dumps(
                {"total_wall_s": round(time.perf_counter() - T0, 3),
                 "stage_seconds": {k: round(v, 3)
                                   for k, v in stats.stage_seconds.items()},
                 "chunk_reads": chunk_reads, "n_chunks": len(chunks),
                 "spill_paf": bins is not None}) + "\n")

    stats.n_reads = n
    stats.n_paf_rows = n_paf_rows
    stats.symmetric = symmetric
    stats.n_fragments = frag_num - 1
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    for p in emit_pools + [cov_pool, load_pool]:
        p.shutdown()
    if bins is not None:
        bins.close()
    if verbose:
        _report(stats, params, auto_e)
    return stats
