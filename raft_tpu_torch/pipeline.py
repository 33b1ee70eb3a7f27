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
framework-free helpers (run stats, the auto-chunk gate, the event-table
views, ``--auto-e`` folding, the ``-e`` advisory, input checks, the
oracle engine) are copies of ``raft_tpu.pipeline``'s, and the native I/O
and the emitters are the port's own copies (``raft_tpu_torch.io``,
``raft_tpu_torch.emit``); ``raft_tpu_torch.io.native`` builds its library
at first use. All device work runs on the calling thread; the load and
emit pools are host-only.

Every timing is a ``profiling`` span: the stages of ``stage_seconds``
always, the rest when the run records (``RAFT_SPANS=1``, a
``torch.profiler`` around the run, or a chunked run writing
``RAFT_CHUNK_TRACE``); ``TorchRunStats.spans`` and ``counters`` hand them
out.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import stat
import sys
import types
from collections import deque

import numpy as np

from raft_tpu_torch import emit, profiling
from raft_tpu_torch.engine_torch import COV_OUT_MODES, compute_torch
from raft_tpu_torch.io import native
from raft_tpu_torch.io.fasta import (ReadStore, load_reads, parse_sim_align,
                                     parse_sim_chr, parse_sim_end_pos,
                                     parse_sim_start_pos)
from raft_tpu_torch.io.paf import OverlapTable, load_paf
from raft_tpu_torch.ops import _lib, oracle
from raft_tpu_torch.params import AlgoParams

OUT_NAMES = (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
             ".long_repeats.bed")


# ---------------------------------------------------------------------------
# Copied from raft_tpu/pipeline.py unchanged (import paths apart): run
# stats, --auto-e folding, the -e advisory, input checks, the oracle
# engine, the auto-chunk gate and the event-table views.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunStats:
    n_reads: int = 0
    n_paf_rows: int = 0
    n_fragments: int = 0
    total_coverage: int = 0
    total_windows: int = 0
    total_repeat_length: int = 0
    total_read_length: int = 0
    symmetric: bool = False
    stage_seconds: dict = dataclasses.field(default_factory=dict)
    emit_bytes: int = 0  # total bytes of the four output files

    @property
    def coverage_per_window(self) -> float:
        return self.total_coverage / self.total_windows if self.total_windows else 0.0

    @property
    def fraction_repeat(self) -> float:
        return (self.total_repeat_length / self.total_read_length
                if self.total_read_length else 0.0)

    def to_json(self) -> dict:
        return {
            "n_reads": self.n_reads,
            "n_paf_rows": self.n_paf_rows,
            "n_fragments": self.n_fragments,
            "total_coverage": self.total_coverage,
            "total_windows": self.total_windows,
            "total_repeat_length": self.total_repeat_length,
            "total_read_length": self.total_read_length,
            "coverage_per_window": self.coverage_per_window,
            "fraction_repeat": self.fraction_repeat,
            "symmetric_overlaps": self.symmetric,
            "stage_seconds": dict(self.stage_seconds),
            "peak_rss_mb": self.peak_rss_mb,
            # emit throughput telemetry (VERDICT r2 weak 7): lets a future
            # round tell an emit-policy regression from VM CPU steal
            "emit_bytes": self.emit_bytes,
            "emit_mb_per_s": round(
                self.emit_bytes / 1e6 / self.stage_seconds["emit"], 1)
            if self.stage_seconds.get("emit") else 0.0,
        }

    @property
    def peak_rss_mb(self) -> float:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _apply_auto_e(params: AlgoParams, info: dict) -> AlgoParams:
    """Fold an --auto-e estimate into the params; stderr reporting.

    The estimate replaces any supplied ``-e`` (reported when they
    disagree). A no-signal input (no covered window) is an error: the
    estimator cannot invent a threshold, and silently running with a
    default would produce garbage fragmentation."""
    est = info["est_cov"]
    if est <= 0:
        raise ValueError(
            "--auto-e: no covered window in the input (every overlap "
            "interval empty or out of range) — est_cov cannot be "
            "estimated; supply -e explicitly")
    from raft_tpu_torch.auto_e import SAFETY_MUL
    msg = (f"INFO, --auto-e estimated est_cov = {est} (median per-window "
           f"coverage {info['refined_median']}, x{SAFETY_MUL:g} safety "
           f"bias, {info['nonzero_windows']} covered windows)")
    if params.est_cov > 0 and params.est_cov != est:
        msg += f"; ignoring supplied -e {params.est_cov}"
    print(msg, file=sys.stderr)
    return params.replace(est_cov=est)


def _est_cov_hint(stats: "RunStats", params: AlgoParams) -> None:
    """stderr advisory when ``-e`` looks mis-specified.

    est_cov is the one knob users must compute themselves
    (total_bases/genome_size, reference README:22-26) and the r4
    sensitivity sweep (EVAL.md) showed the failure mode is severe and
    asymmetric: under-estimates collapse repeat precision ~10x and
    suppress fragmentation, over-estimates >~2x cost recall. The
    reference prints the observed/supplied ratio but never interprets
    it; we add the interpretation on STDERR (stdout stays line-identical
    to the reference). RAFT_NO_HINTS=1 disables."""
    if os.environ.get("RAFT_NO_HINTS"):
        return
    if not stats.total_windows or params.est_cov <= 0:
        return
    ratio = stats.coverage_per_window / params.est_cov
    # Thresholds calibrated to the r4 sweep (EVAL.md, VERDICT r4 item
    # 6): a 0.75x under-estimate (observed/supplied ~= 1.33) ALREADY
    # halves flank-tolerant precision (0.995 -> 0.40 at 2 Mbp, 0.11 at
    # 10 Mbp), so the under-estimate hint must fire before 1.33, not at
    # the old 1.5. Over-estimates are harmless at 1.5x (ratio 0.67) and
    # cost recall at 2x (ratio 0.5, recall 0.82-0.98), so warn from
    # ratio < 0.6 — between the last-known-safe and first-damaged
    # points.
    if ratio > 1.25:
        print(f"HINT: observed coverage per window ({ratio:.2f}x the "
              f"supplied -e {params.est_cov}) suggests est_cov is "
              "UNDER-estimated; a 0.75x under-estimate already halves "
              "repeat precision and suppresses fragmentation (EVAL.md "
              "sweep). Consider -e nearer "
              f"{stats.coverage_per_window:.0f}, or --auto-e.",
              file=sys.stderr)
    elif ratio < 0.6:
        print(f"HINT: observed coverage per window is only {ratio:.2f}x "
              f"the supplied -e {params.est_cov}; a 2x over-estimate "
              "makes true repeats miss the high-coverage threshold "
              "(recall 1.0 -> 0.82-0.98, EVAL.md sweep). Consider -e "
              f"nearer {stats.coverage_per_window:.0f}, or --auto-e.",
              file=sys.stderr)


def _sum_output_bytes(prefix: str, sfx: str) -> int:
    tot = 0
    for name in (".coverage.txt", ".long_repeats.txt",
                 ".long_repeats.bed", ".reads.fasta"):
        try:
            tot += os.path.getsize(prefix + name + sfx)
        except OSError:
            pass
    return tot


def _validate_inputs(read_path: str, paf_path: str) -> None:
    """Reference check: exists + non-empty or exit (chop.hpp:336-349)."""
    for p in (read_path, paf_path):
        if not os.path.exists(p) or os.path.getsize(p) == 0:
            print(f"ERROR, break_long_reads(), {p} input file either does "
                  "not exist or is empty")
            raise SystemExit(1)


def _reserve_early(read_path: str, out_path: str) -> bool:
    """Whether the FASTA's reservation may start before the parse: the
    reads are a plain FASTA (first byte ``>``: not FASTQ, gz or BGZF), so
    their file's size bounds the output's bases from above, and the
    output path is absent or an empty regular file, so that a failed run
    leaves it as it was."""
    try:
        with open(read_path, "rb") as f:
            if f.read(1) != b">":
                return False
    except OSError:
        return False
    try:
        st = os.stat(out_path)
    except FileNotFoundError:
        return True
    except OSError:
        return False
    return stat.S_ISREG(st.st_mode) and st.st_size == 0


def compute_oracle(store: ReadStore, table: OverlapTable,
                   params: AlgoParams, strict: bool = True):
    """Reference-exact per-read compute (numpy oracle engine).

    Returns (coverages, repeats_per_read, frags_per_read, stats_partial).
    """
    n = store.n_reads
    ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
    order = np.argsort(ev_read, kind="stable")
    ev_read = ev_read[order]
    ev_lo = ev_lo[order]
    ev_hi = ev_hi[order]
    bounds = np.searchsorted(ev_read, np.arange(n + 1))

    coverages = []
    repeats_per_read = []
    frags_per_read = []
    stats = RunStats()
    hc = params.high_cov
    for i in range(n):
        length = int(store.lens[i])
        lo = ev_lo[bounds[i]:bounds[i + 1]]
        hi = ev_hi[bounds[i]:bounds[i + 1]]
        cov = oracle.coverage_one_read(length, params.reso, lo, hi,
                                       strict=strict)
        rep = oracle.repeats_one_read(cov, length, params.reso, hc,
                                      params.repeat_length,
                                      params.flanking_length)
        stars = oracle.markers_one_read(length, params.interval_length)
        finals = oracle.surviving_markers(stars, rep.intervals)
        frags = oracle.chop_one_read(length, finals, params.read_length,
                                     params.interval_length,
                                     params.overlap_length)
        coverages.append(cov)
        repeats_per_read.append(rep.intervals)
        frags_per_read.append(frags)
        stats.total_coverage += int(cov.sum())
        stats.total_windows += len(cov)
        stats.total_repeat_length += rep.repeat_length_sum
        stats.total_read_length += length
    return coverages, repeats_per_read, frags_per_read, stats


DEFAULT_CHUNK_READS = 32768  # chunk size auto-streaming picks (the 512k
#                              scale proof's measured-good size)


def _auto_chunk_reads(read_path: str, paf_path: str) -> int:
    """Auto-streaming gate for whole-file invocations (0 = stay
    whole-file). Size-based: the decision must happen before any parse,
    and input bytes are the resource the chunked schedule manages. The
    2 GB default keeps bench-scale runs (where chunking measured slightly
    slower — smaller batches cost more than the overlap saves) on the
    whole-file path."""
    try:
        thr = float(os.environ.get("RAFT_AUTO_CHUNK_BYTES", 2e9))
    except ValueError:
        print("raft: ignoring malformed RAFT_AUTO_CHUNK_BYTES "
              f"({os.environ['RAFT_AUTO_CHUNK_BYTES']!r}); using 2e9",
              file=sys.stderr)
        thr = 2e9
    if thr <= 0:
        return 0
    try:
        if (os.path.getsize(read_path) > thr
                or os.path.getsize(paf_path) > thr):
            return DEFAULT_CHUNK_READS
    except OSError:
        pass
    return 0



class _GroupedEventTable:
    """Pre-grouped window-binned event slab with the
    OverlapTable.events_grouped() contract (chunk slice of the
    whole-input native counting-sort result; strictness was enforced
    once at the global grouping)."""

    def __init__(self, off, w0, w1, symmetric):
        self._g = (np.ascontiguousarray(off, dtype=np.int64),
                   np.ascontiguousarray(w0, dtype=np.int32),
                   np.ascontiguousarray(w1, dtype=np.int32))
        self.symmetric = symmetric
        self.n_rows = len(self._g[1])

    def events_grouped(self, n_reads, lens, reso, strict=True):
        return self._g


class _EventTable:
    """Pre-built event view with the OverlapTable.events() contract."""

    def __init__(self, ev_read, ev_lo, ev_hi, symmetric):
        self._ev = (np.ascontiguousarray(ev_read, dtype=np.int32),
                    np.ascontiguousarray(ev_lo, dtype=np.int32),
                    np.ascontiguousarray(ev_hi, dtype=np.int32))
        self.symmetric = symmetric
        self.n_rows = len(ev_read)

    def events(self, n_reads, strict=True):
        return self._ev


# ---------------------------------------------------------------------------
# The torch port's own pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TorchRunStats(RunStats):
    """``RunStats`` plus what this pipeline knows of its own run: whether
    the native C++ I/O library was loaded for the parse (without it the
    Python parsers run, with the same results), the ``(B, W, E)`` shape
    of every bucket the torch engine ran, in run order across chunks, and
    the schedule (``whole`` or ``chunked``) with its number of chunks, and
    the devices the torch engine ran on (one per shard; none on the oracle
    engine). Under sharding ``buckets`` holds every shard's per-shard
    shape, one entry per pileup launch. ``launches`` is how far each
    CUDA kernel's count (``ops._lib.launches``) rose during the run: one
    launch of each per bucket on a card, none on the CPU (a second run
    in the same process at the same time would add its own).

    ``spans`` and ``counters`` are the run's ``profiling`` recording
    (empty when it did not record); ``stage_ns`` holds the integer
    nanoseconds behind ``stage_seconds``."""
    native_io: bool = False
    buckets: list = dataclasses.field(default_factory=list)
    schedule: str = "whole"
    n_chunks: int = 1
    devices: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list, repr=False)
    counters: dict = dataclasses.field(default_factory=dict)
    stage_ns: dict = dataclasses.field(default_factory=dict, repr=False)

    def to_json(self) -> dict:
        return {**super().to_json(), "native_io": self.native_io,
                "buckets": [list(b) for b in self.buckets],
                "schedule": self.schedule, "n_chunks": self.n_chunks,
                "devices": self.devices,
                "launches": self.launches,
                "span_seconds": profiling.span_seconds(self.spans),
                "counters": self.counters}

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


def _device_names(device, devices) -> list[str]:
    """The engine's devices by index: a bare ``cuda`` is the current CUDA
    device, so a default run names ``cuda:0``."""
    import torch
    out = []
    for d in devices or [device]:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(str(d))
    return out


def load_inputs(read_path: str, paf_path: str, stats: TorchRunStats,
                use_native: bool | None = None,
                verbose: bool = False,
                on_reads=None) -> tuple[ReadStore, OverlapTable]:
    """Parse the reads and the PAF, timed as ``load_reads`` and
    ``load_paf``. The PAF tokenize/intern phase has no dependency on the
    FASTA parse, so it runs beside ``load_reads`` (both native calls
    release the GIL) as ``parse.preparse_paf``; ``load_paf`` waits for it
    and resolves its names (``parse.resolve_paf``). ``on_reads(store)``,
    where given, sees the reads between the two."""
    pre_fut = None
    if use_native is not False:
        _pre_pool = cf.ThreadPoolExecutor(max_workers=1)
        pre_fut = _pre_pool.submit(
            profiling.bind(native.preparse_paf, "parse.preparse_paf"),
            paf_path)
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
        with profiling.stage(stats, "load_reads"):
            store = load_reads(read_path, use_native=use_native)
        if verbose:
            print(f"Real Reads {int(store.real_reads)} ")
        if on_reads is not None:
            on_reads(store)
        with profiling.stage(stats, "load_paf"):
            table = None
            if pre_fut is not None:
                fut, pre_fut = pre_fut, None
                pre = fut.result()
                if pre is not None:
                    with profiling.span("parse.resolve_paf"):
                        table = native.resolve_paf(pre, store)
            if table is None:
                table = load_paf(paf_path, store, use_native=use_native)
    finally:
        _drain_preparse()
    stats.native_io = (use_native is not False
                       and native._get_lib() is not None)
    _count_parse(read_path, paf_path, store.n_reads, table.n_rows)
    return store, table


def _count_parse(read_path: str, paf_path: str, n_reads: int,
                 n_rows: int) -> None:
    """The parse layer's counters: input bytes (as stored, compressed or
    not), reads and PAF rows."""
    if profiling.recording() is None:
        return
    profiling.count("parse.fasta_bytes", os.path.getsize(read_path))
    profiling.count("parse.paf_bytes", os.path.getsize(paf_path))
    profiling.count("parse.reads", n_reads)
    profiling.count("parse.paf_rows", n_rows)


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
                 on_bucket=None, devices=None) -> TorchRunStats:
    """Full RAFT run: parse, compute, emit the four output files.

    ``gz_out`` writes the outputs BGZF-compressed (``.gz``); ``auto_e``
    estimates ``-e`` from the overlap events; ``device`` is where the
    torch engine runs (``cuda`` or ``cpu``). ``cov_out``, ``raft_tpu``'s
    coverage return mode, is accepted for its command lines: a torch
    engine run refuses a value other than ``host``, ``diff8`` or ``cov``
    before it opens anything, and renders the coverage on the host in
    each, so the value changes nothing else.

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
    ``compute_torch``'s hook does, in every chunk.

    ``devices`` (a list of torch devices, ``parallel.mesh.make_devices``)
    shards each bucket over them, on either schedule, in place of
    ``device``; the outputs are the same."""
    if engine not in ("torch", "oracle"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" and (cov_out or "host") not in COV_OUT_MODES:
        raise ValueError(f"cov_out={cov_out!r}: must be one of "
                         f"{', '.join(COV_OUT_MODES)}")
    launches0 = _lib.launch_counts()
    if chunk_reads is None and engine == "torch" and use_native is not False:
        chunk_reads = _auto_chunk_reads(read_path, paf_path)
        if chunk_reads and verbose:
            print(f"INFO, large input: auto-streaming in chunks of "
                  f"{chunk_reads} reads (--chunk-reads 0 forces "
                  f"whole-file)", file=sys.stderr)
    if chunk_reads and engine != "torch":
        raise ValueError("the chunked schedule runs the torch engine; "
                         "run --engine oracle whole-file "
                         "(--chunk-reads 0)")
    # the chunk trace is written from the spans, so asking for it records
    with profiling.run(force=bool(chunk_reads and
                                  os.environ.get("RAFT_CHUNK_TRACE"))) as rec:
        st = None
        if chunk_reads:
            st = _run_pipeline_chunked(
                read_path, paf_path, params, chunk_reads, strict=strict,
                verbose=verbose, spill_paf=spill_paf, gz_out=gz_out,
                auto_e=auto_e, device=device, on_bucket=on_bucket,
                devices=devices)
            if st is None and verbose:
                # stderr: stdout stays line-identical to the reference,
                # and the auto-chunk gate reaches this without the user
                # asking
                print("INFO, streaming mode unavailable for this input; "
                      "running whole-file", file=sys.stderr)
        if st is None:
            st = _run_pipeline_whole(
                read_path, paf_path, params, engine=engine, strict=strict,
                verbose=verbose, use_native=use_native, gz_out=gz_out,
                auto_e=auto_e, device=device, on_bucket=on_bucket,
                devices=devices)
    st.launches = _lib.launch_counts(launches0)
    if rec is not None:
        st.spans, st.counters = rec.spans, dict(rec.counters)
    return st


def _run_pipeline_whole(read_path: str, paf_path: str, params: AlgoParams,
                        engine: str, strict: bool, verbose: bool,
                        use_native: bool | None, gz_out: bool, auto_e: bool,
                        device: str, on_bucket,
                        devices) -> TorchRunStats:
    """Whole-file schedule: parse, one ``compute``, then the four writers
    side by side, each a span ``emit.<file>`` on its pool thread (the
    coverage writer's starts inside ``compute``), under the ``emit``
    stage, which is the main thread's wait on them. A plain output
    FASTA's extent is reserved beside the parse and ``compute``
    (``emit.Reservation``, span ``emit.reserve``): from the start, sized
    by the input file, where the reads are a plain FASTA and the output
    is absent or empty (``_reserve_early``; attribute ``early`` 1); else
    once the reads are loaded, sized by their bases and a newline a read
    (``early`` 0)."""
    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = TorchRunStats()
    prefix = params.outputfilename
    un = use_native is not False
    sfx = ".gz" if gz_out else ""
    # the side pool's two threads: the FASTA's reservation, and the
    # coverage writer (.coverage.txt depends only on the binned events:
    # the torch engine hands them over before any device work and the
    # writer runs beside it; the oracle's are in its result)
    side_pool = cf.ThreadPoolExecutor(max_workers=2)
    cov_fut: list = []
    reservation = None
    fasta_out = prefix + ".reads.fasta"
    reserve = un and not gz_out
    if reserve and _reserve_early(read_path, fasta_out):
        # a plain FASTA holds at least its bases and a newline a read
        reservation = emit.Reservation(side_pool, fasta_out,
                                       os.path.getsize(read_path), verbose,
                                       early=True)

    def _reserve_fasta(store):
        nonlocal reservation
        reservation = emit.Reservation(
            side_pool, fasta_out,
            int(store.lens.sum(dtype=np.int64)) + store.n_reads, verbose)

    def _write_coverage(res):
        cov_fut.append(side_pool.submit(
            profiling.bind(emit.write_coverage, "emit.coverage"),
            prefix + ".coverage.txt" + sfx, params.reso, res, un, gz=gz_out))

    try:
        store, table = load_inputs(
            read_path, paf_path, stats, use_native, verbose,
            on_reads=(_reserve_fasta if reserve and reservation is None
                      else None))
        if verbose:
            print(f"INFO, Symmetric overlaps {int(table.symmetric)} ")
            print(f"INFO, length of alignments  {table.n_rows}()")

        params = params.replace(real_reads=store.real_reads,
                                symmetric_overlaps=table.symmetric)
        grouped = None
        if auto_e:
            from raft_tpu_torch import auto_e as _auto_e
            with profiling.stage(stats, "auto_e"):
                info, grouped = _auto_e.estimate_for_table(
                    table, store.lens.astype(np.int64), store.n_reads,
                    params.reso, params.cov_mul, strict=strict)
            params = _apply_auto_e(params, info)
        if verbose:
            print(f"high_cov {params.high_cov}")

        with profiling.stage(stats, "compute"):
            if engine == "oracle":
                from raft_tpu_torch.result import from_per_read_lists
                coverages, repeats, frags, cstats = compute_oracle(
                    store, table, params, strict=strict)
                res = from_per_read_lists(store.n_reads, coverages, repeats,
                                          frags, cstats)
                _write_coverage(res)
            else:
                stats.devices = _device_names(device, devices)
                res = compute_torch(
                    store, table, params, strict=strict,
                    on_cov_events=_write_coverage, grouped=grouped,
                    device=device, on_bucket=stats.bucket_hook(on_bucket),
                    devices=devices)

        stats.n_reads = store.n_reads
        stats.n_paf_rows = table.n_rows
        stats.symmetric = table.symmetric
        stats.total_coverage = res.total_coverage
        stats.total_windows = res.total_windows
        stats.total_repeat_length = res.total_repeat_length
        stats.total_read_length = res.total_read_length
        if verbose:
            _report(stats, params, auto_e)

        with profiling.stage(stats, "emit"):
            # the four writers touch disjoint files and release the GIL in
            # the native emitters
            with cf.ThreadPoolExecutor(max_workers=3) as ex:
                futs = [
                    cov_fut[0],
                    ex.submit(profiling.bind(emit.write_long_repeats,
                                             "emit.repeats"),
                              prefix + ".long_repeats.txt" + sfx, res, un,
                              gz=gz_out),
                    ex.submit(profiling.bind(emit.write_long_repeats_bed,
                                             "emit.bed"),
                              prefix + ".long_repeats.bed" + sfx, store,
                              res, un, gz=gz_out),
                    ex.submit(profiling.bind(emit.write_fragments_fasta,
                                             "emit.fasta"),
                              prefix + ".reads.fasta" + sfx, store, params,
                              res, un, gz=gz_out, reservation=reservation),
                ]
                for f in futs[:-1]:
                    f.result()
                stats.n_fragments = futs[-1].result()
    finally:
        side_pool.shutdown()
        if reservation is not None:
            reservation.release()
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    with profiling.span("free"):
        # the native stores and the result arrays go here, not unseen in
        # the return (tens of ms at 0.6 Gbp)
        del store, table, res, grouped
    return stats


# chunk-trace keys of the writer spans
_TRACE_EMIT = {"emit.fasta": "emit_fasta", "emit.repeats": "emit_lr",
               "emit.bed": "emit_bed", "emit.coverage": "emit_cov"}


def _chunk_trace(spans: list, chunks: list, stats: TorchRunStats,
                 chunk_reads: int, spill: bool) -> list:
    """The ``RAFT_CHUNK_TRACE`` records of a chunked run, from its spans:
    per chunk its reads, seconds (rounded to ms) and ``[start, end]``
    offsets from the start of the ``chunks`` span, then a summary."""
    loop = next(s for s in reversed(spans) if s["name"] == "chunks")
    T0 = loop["t0"]

    def sec(s):
        return round((s["t1"] - s["t0"]) / 1e9, 3)

    def at(s):
        return [round((s["t0"] - T0) / 1e9, 3), round((s["t1"] - T0) / 1e9, 3)]

    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    recs = [dict(ci=ci, lo=lo, hi=hi) for ci, (lo, hi) in enumerate(chunks)]
    for s in spans:
        name, a = s["name"], s["attrs"]
        if name == "chunk":
            r = recs[a["ci"]]
            r["n_events"] = a["n_events"]
            for c in kids.get(s["id"], []):
                if c["name"] == "chunk.wait_load":
                    r["wait_load_s"] = sec(c)
                elif c["name"] == "chunk.drain":
                    r["drain_s"] = sec(c)
                elif c["name"] == "compute":
                    r["compute_s"] = sec(c)
                    r["compute_span"] = at(c)
                    eng: dict = {}
                    for e in kids.get(c["id"], []):
                        if e["name"].startswith("engine."):
                            key = e["name"][len("engine."):]
                            eng[key] = eng.get(key, 0) + e["t1"] - e["t0"]
                    r["engine"] = {k: round(v / 1e9, 3)
                                   for k, v in eng.items()}
        elif name == "chunk.load":
            r = recs[a["ci"]]
            r["load_span"] = at(s)
            for c in kids.get(s["id"], []):
                if c["name"] == "chunk.load.read":
                    r["load_read_s"] = sec(c)
                elif c["name"] == "chunk.load.events":
                    r["load_events_s"] = sec(c)
        elif name in _TRACE_EMIT and "ci" in a:
            r = recs[a["ci"]]
            r[_TRACE_EMIT[name] + "_s"] = sec(s)
            r[_TRACE_EMIT[name] + "_span"] = at(s)
    return recs + [{"total_wall_s": sec(loop),
                    "stage_seconds": {k: round(v, 3) for k, v in
                                      stats.stage_seconds.items()},
                    "chunk_reads": chunk_reads, "n_chunks": len(chunks),
                    "spill_paf": spill}]


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
                          gz_out: bool = False,
                          auto_e: bool = False, device: str = "cuda",
                          on_bucket=None,
                          devices=None) -> TorchRunStats | None:
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
    seconds) and a summary line, all read from the run's spans
    (``_chunk_trace``); ``RAFT_CHUNK_PENDING`` (default 2) bounds the
    chunks whose emits may still be running.

    Spans: the prelude's stages, then ``chunks`` around the loop; per
    chunk ``chunk`` (``ci``, ``lo``, ``hi``, ``n_events``) holding
    ``chunk.wait_load`` (the ``load_reads`` stage), ``chunk.drain`` and
    ``compute``; ``chunk.load`` (``.read``, ``.events``) on the loader
    thread and the writers ``emit.<file>`` (``ci``) on the emit pools;
    then the ``emit`` stage, the wait on the last writers."""
    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = TorchRunStats(schedule="chunked", native_io=True,
                          devices=_device_names(device, devices))
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
        pre_fut = _pre_pool.submit(
            profiling.bind(native.preparse_paf, "parse.preparse_paf"),
            paf_path)
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
        with profiling.stage(stats, "index"):
            idx = native.index_reads(read_path)
        if idx is None or idx["n"] == 0:
            return None
        n = idx["n"]
        if verbose:
            print(f"Real Reads {int(idx['real_reads'])} ")

        bins = None
        table = None
        if spill_paf:
            with profiling.stage(stats, "load_paf"):
                bins = native.bin_paf_events(paf_path, idx, n, chunk_reads)
            if bins is not None and strict and bins.n_unknown:
                bins.close()
                raise ValueError(
                    f"PAF names {bins.n_unknown} read(s) absent from the "
                    "input FASTA (undefined behavior in reference RAFT); "
                    "pass strict=False to drop them")
        if bins is None:
            with profiling.stage(stats, "load_paf"):
                # the PAF interns against the index handle's name map
                shim = types.SimpleNamespace(_native_handle=idx["handle"])
                if pre_fut is not None:
                    fut, pre_fut = pre_fut, None
                    pre = fut.result()
                    if pre is not None:
                        with profiling.span("parse.resolve_paf"):
                            table = native.resolve_paf(pre, shim)
                if table is None:
                    table = native.load_paf(paf_path, shim)
                if table is None:
                    return None
    finally:
        _drain_preparse()

    symmetric = bins.symmetric if bins is not None else table.symmetric
    n_paf_rows = bins.n_rows if bins is not None else table.n_rows
    _count_parse(read_path, paf_path, n, n_paf_rows)
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
        with profiling.stage(stats, "group_events"):
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
        from raft_tpu_torch import auto_e as _auto_e
        with profiling.stage(stats, "auto_e"):
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

    def _load_chunk(ci, lo, hi):
        with profiling.span("chunk.load", ci=ci):
            with profiling.span("chunk.load.read"):
                store = native.load_reads_range(
                    idx["data_path"], int(rec_off[lo]), int(rec_off[hi]),
                    fastq=idx["fastq"])
            with profiling.span("chunk.load.events"):
                return store, _chunk_events(store, lo, hi)

    def _chunk_events(store, lo, hi):
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
            return _EventTable(er - lo, el, eh, symmetric)
        if g_off is not None:
            o = g_off[lo:hi + 1]
            return _GroupedEventTable(o - o[0],
                                      g_w0[int(o[0]):int(o[-1])],
                                      g_w1[int(o[0]):int(o[-1])],
                                      symmetric)
        a, b = np.searchsorted(ev_read, [lo, hi])
        return _EventTable(ev_read[a:b] - lo, ev_lo[a:b], ev_hi[a:b],
                           symmetric)

    def _submit(pool, ci, name, fn, *a, **k):
        return pool.submit(profiling.bind(fn, name, ci=ci), *a, **k)

    chunks = [(lo, min(lo + chunk_reads, n))
              for lo in range(0, n, chunk_reads)]
    stats.n_chunks = len(chunks)

    def _chunk_loop() -> int:
        # every emit future is drained here, so any I/O error surfaces
        # inside the teardown guard below
        next_fut = load_pool.submit(profiling.bind(_load_chunk), 0,
                                    *chunks[0])
        pending: deque = deque()
        frag_num = 1
        for ci, (lo, hi) in enumerate(chunks):
            app = ci > 0
            with profiling.span("chunk", ci=ci, lo=lo, hi=hi) as chunk_span:
                with profiling.stage(stats, "load_reads", "chunk.wait_load"):
                    store, sub_table = next_fut.result()
                if ci + 1 < len(chunks):
                    next_fut = load_pool.submit(profiling.bind(_load_chunk),
                                                ci + 1, *chunks[ci + 1])
                with profiling.span("chunk.drain"):
                    while len(pending) > max_pending:
                        for f in pending.popleft():
                            f.result()

                # coverage emission overlaps this chunk's device work (its
                # only input, the chunk's binned events, exists before it);
                # the FIFO cov pool keeps the append order across chunks
                cov_fut: list = []

                def _write_coverage(res, _ci=ci, _lo=lo, _app=app):
                    cov_fut.append(_submit(
                        cov_pool, _ci, "emit.coverage", emit.write_coverage,
                        prefix + ".coverage.txt" + sfx, params.reso, res,
                        first_read_index=_lo, append=_app, gz=gz_out))

                with profiling.stage(stats, "compute"):
                    res = compute_torch(
                        store, sub_table, params, strict=strict,
                        on_cov_events=_write_coverage, device=device,
                        on_bucket=bucket_hook, devices=devices)
                chunk_span.set(n_events=int(sub_table.n_rows))
                profiling.count("chunk.events", sub_table.n_rows)

                frag_base = frag_num
                frag_num += res.n_frags
                stats.total_coverage += res.total_coverage
                stats.total_windows += res.total_windows
                stats.total_repeat_length += res.total_repeat_length
                stats.total_read_length += res.total_read_length

                pending.append([
                    _submit(emit_pools[0], ci, "emit.fasta",
                            emit.write_fragments_fasta,
                            prefix + ".reads.fasta" + sfx, store, params,
                            res, first_read_num=frag_base, append=app,
                            gz=gz_out),
                    _submit(emit_pools[1], ci, "emit.repeats",
                            emit.write_long_repeats,
                            prefix + ".long_repeats.txt" + sfx, res,
                            first_read_index=lo, append=app, gz=gz_out),
                    _submit(emit_pools[2], ci, "emit.bed",
                            emit.write_long_repeats_bed,
                            prefix + ".long_repeats.bed" + sfx, store, res,
                            append=app, gz=gz_out),
                ] + cov_fut)

        with profiling.stage(stats, "emit"):
            while pending:
                for f in pending.popleft():
                    f.result()
        return frag_num

    try:
        with profiling.span("chunks"):
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

    rec = profiling.recording()
    if trace_path and rec is not None:
        with open(trace_path, "w") as tf:
            for line in _chunk_trace(rec.spans, chunks, stats, chunk_reads,
                                     bins is not None):
                tf.write(json.dumps(line) + "\n")

    stats.n_reads = n
    stats.n_paf_rows = n_paf_rows
    stats.symmetric = symmetric
    stats.n_fragments = frag_num - 1
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    for p in emit_pools + [cov_pool, load_pool]:
        p.shutdown()
    with profiling.span("free"):
        if bins is not None:
            bins.close()
        del idx, names, rec_off, table, g_off, g_w0, g_w1
    if verbose:
        _report(stats, params, auto_e)
    return stats
