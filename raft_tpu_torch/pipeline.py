"""Whole-file RAFT run on the torch engine: parse, compute, emit.

The counterpart of ``raft_tpu.pipeline.run_pipeline`` in whole-file mode.
Its framework-free helpers — run stats, stage timers, ``--auto-e``
folding, the ``-e`` advisory, input checks and the oracle engine — are
imported from ``raft_tpu.pipeline`` unchanged, as are the native I/O and
the emitters; ``raft_tpu.io.native`` builds its library at first use.
Two engines: ``torch`` (``engine_torch.compute_torch`` on ``device``)
and ``oracle`` (per-read numpy with reference-exact scalar semantics).
The chunked streaming schedule is not ported yet; its outputs are
byte-identical to whole-file ones, so every input runs here.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np

from raft_tpu import emit
from raft_tpu.io import native
from raft_tpu.io.fasta import ReadStore, load_reads
from raft_tpu.io.paf import OverlapTable, load_paf
from raft_tpu.params import AlgoParams
from raft_tpu.pipeline import (RunStats, _apply_auto_e, _est_cov_hint,
                               _sum_output_bytes, _Timer, _validate_inputs,
                               compute_oracle)
from raft_tpu_torch.engine_torch import compute_torch


@dataclasses.dataclass
class TorchRunStats(RunStats):
    """``RunStats`` plus what this pipeline knows of its own run: whether
    the native C++ I/O library was loaded for the parse (without it the
    Python parsers run, with the same results) and the ``(B, W, E)`` shape of every
    bucket the torch engine ran, in order."""
    native_io: bool = False
    buckets: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {**super().to_json(), "native_io": self.native_io,
                "buckets": [list(b) for b in self.buckets]}


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


def run_pipeline(read_path: str, paf_path: str, params: AlgoParams,
                 engine: str = "torch", strict: bool = True,
                 verbose: bool = True, use_native: bool | None = None,
                 gz_out: bool = False, auto_e: bool = False,
                 device: str = "cuda") -> TorchRunStats:
    """Full RAFT run: parse, compute, emit the four output files.

    ``gz_out`` writes the outputs BGZF-compressed (``.gz``); ``auto_e``
    estimates ``-e`` from the overlap events; ``device`` is where the
    torch engine runs (``cuda`` or ``cpu``)."""
    if engine not in ("torch", "oracle"):
        raise ValueError(f"unknown engine {engine!r}")
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
    # .coverage.txt depends only on the binned events: the engine hands
    # them over before any device work and the emitter runs beside it
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
                    store, table, params, strict=strict,
                    on_cov_events=_on_cov, grouped=grouped, device=device,
                    on_bucket=lambda cfg, *_: stats.buckets.append(
                        (cfg.B, cfg.W, cfg.E)))

        stats.n_reads = store.n_reads
        stats.n_paf_rows = table.n_rows
        stats.symmetric = table.symmetric
        stats.total_coverage = res.total_coverage
        stats.total_windows = res.total_windows
        stats.total_repeat_length = res.total_repeat_length
        stats.total_read_length = res.total_read_length

        if verbose:
            print(f"coverage per window is {stats.coverage_per_window:f} ")
            print("coverage per window/average coverage is "
                  f"{stats.coverage_per_window / params.est_cov:f} ")
            print(f"fraction_of_repeat_length {stats.fraction_repeat:f} ")
            if not auto_e:
                _est_cov_hint(stats, params)

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
