"""Mirrors raft_tpu/tools/bench_chunk.py: the chunked schedule's wall
decomposition at scale, on the port.

It runs the port's CLI on the given inputs with the per-chunk tracer
enabled (``RAFT_CHUNK_TRACE``, written by ``raft_tpu_torch.pipeline``),
optionally measures this machine's sequential disk bandwidth directly
(cold page cache), and prints a stage accounting that attributes the
wall to

* the serial prelude (FASTA index scan ∥ PAF preparse, then resolve),
* per-chunk loader-thread busy time (disk read + range parse),
* main-thread compute, split into whatever engine substages the trace
  holds (on the port: ``events``, ``cov_events``, ``bucket_prep``,
  ``h2d``, ``step`` and ``integrate``),
* emit-thread busy time per output file,
* main-thread blocked time (waiting for loads / draining emits),

plus the run's ``devices``, bucket count and kernel launches from its
``--stats-json``. One JSON document on stdout.

Usage::

    python -m raft_tpu_torch.tools.bench_chunk --reads F.fasta --paf O.paf \\
        --workdir D [--cold] [--disk-bw] [--chunk 32768] \\
        [--device {cuda,cpu}] [--expect PREFIX]

``--cold`` drops the page cache (root) before the pipeline run so disk
reads are real; ``--disk-bw`` measures sequential read/write bandwidth
first. ``--device`` (default cuda) is passed to the run; ``cuda`` without
a CUDA device exits 1. ``--expect PREFIX`` (the port's addition)
byte-compares the run's four outputs against ``PREFIX.*`` and reports
``all_equal``; the tool then exits 1 unless they are equal.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from raft_tpu_torch.bench import ARGS, cuda_missing
from raft_tpu_torch.tools.bench_scale import OUT_EXTS, cmp_outputs, run_facts


def drop_caches() -> bool:
    try:
        subprocess.run(["sync"], check=True)
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def measure_read_bw(path: str, max_bytes: int = 2 << 30) -> float:
    """Sequential cold read MB/s over the first ``max_bytes`` of path."""
    if not drop_caches():
        return float("nan")
    n = 0
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        while n < max_bytes:
            b = f.read(1 << 20)
            if not b:
                break
            n += len(b)
    dt = time.perf_counter() - t0
    return n / 1e6 / dt if dt > 0 else float("nan")


def measure_write_bw(workdir: str, n_bytes: int = 2 << 30) -> float:
    """Sequential write MB/s (fsync-inclusive) into workdir."""
    path = os.path.join(workdir, "_bw_probe.bin")
    buf = b"\0" * (1 << 20)
    t0 = time.perf_counter()
    try:
        with open(path, "wb", buffering=0) as f:
            for _ in range(n_bytes // len(buf)):
                f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        dt = time.perf_counter() - t0
        return n_bytes / 1e6 / dt if dt > 0 else float("nan")
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def run_traced(reads: str, paf: str, prefix: str, trace_path: str,
               extra: list[str]) -> tuple[float, dict]:
    stats_path = prefix + ".stats.json"
    env = dict(os.environ, RAFT_CHUNK_TRACE=trace_path)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.cli"] + ARGS
        + ["--stats-json", stats_path] + extra + ["-o", prefix, reads, paf],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env,
        timeout=14400)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"pipeline failed rc={res.returncode}: "
                           f"{res.stderr[-2000:].decode(errors='replace')}")
    with open(stats_path) as f:
        return wall, json.load(f)


def analyze(trace_path: str, wall: float, stats: dict) -> dict:
    if not os.path.exists(trace_path):
        raise SystemExit(
            "bench_chunk: no chunk trace was written — the run took the "
            "whole-file path (input under the auto-stream threshold?). "
            "Pass --chunk N to force the chunked schedule.")
    with open(trace_path) as f:
        recs = [json.loads(line) for line in f]
    tail = recs.pop()  # summary record
    sums: dict = {}
    eng: dict = {}
    for r in recs:
        for k in ("wait_load_s", "drain_s", "compute_s", "load_read_s",
                  "load_events_s", "emit_cov_s", "emit_fasta_s",
                  "emit_lr_s", "emit_bed_s"):
            sums[k] = round(sums.get(k, 0.0) + r.get(k, 0.0), 3)
        for k, v in r.get("engine", {}).items():
            eng[k] = round(eng.get(k, 0.0) + v, 3)
    stage = stats["stage_seconds"]
    compute = sums.get("compute_s", 0.0)
    eng_total = round(sum(eng.values()), 3)
    first_compute = min((r["compute_span"][0] for r in recs
                         if "compute_span" in r), default=0.0)
    last_end = max((max(r.get(k, [0, 0])[1] for k in
                        ("compute_span", "emit_fasta_span", "emit_cov_span",
                         "emit_lr_span", "emit_bed_span") if k in r)
                    for r in recs), default=0.0)
    return {
        "wall_s": round(wall, 2),
        "n_chunks": tail["n_chunks"],
        "chunk_reads": tail["chunk_reads"],
        "spill_paf": tail["spill_paf"],
        "stage_seconds": {k: round(v, 2) for k, v in stage.items()},
        # serial prelude: index scan (overlapped with PAF preparse) +
        # resolve remainder — everything before the chunk loop starts
        # (trace spans are relative to loop start, AFTER these stages)
        "prelude_s": round(stage.get("index", 0.0)
                           + stage.get("load_paf", 0.0), 2),
        "first_compute_delay_s": round(first_compute, 2),
        "chunk_loop_s": round(last_end - first_compute, 2),
        "main_thread": {
            "compute_s": compute,
            "engine_substages_s": eng,
            "engine_total_s": eng_total,
            "compute_unattributed_s": round(compute - eng_total, 3),
            "blocked_wait_load_s": sums.get("wait_load_s", 0.0),
            "blocked_drain_s": sums.get("drain_s", 0.0),
        },
        "loader_thread": {
            "read_s": sums.get("load_read_s", 0.0),
            "events_s": sums.get("load_events_s", 0.0),
        },
        "emit_threads": {
            "fasta_s": sums.get("emit_fasta_s", 0.0),
            "coverage_s": sums.get("emit_cov_s", 0.0),
            "long_repeats_s": sums.get("emit_lr_s", 0.0),
            "bed_s": sums.get("emit_bed_s", 0.0),
        },
        "peak_rss_mb": round(stats.get("peak_rss_mb", 0)),
        "n_fragments": stats.get("n_fragments"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", required=True)
    ap.add_argument("--paf", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunk size (0 = default auto-stream decision)")
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before the pipeline run")
    ap.add_argument("--disk-bw", action="store_true",
                    help="measure sequential disk read/write MB/s first")
    ap.add_argument("--label", default="run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--expect", metavar="PREFIX",
                    help="byte-compare the four outputs with PREFIX.*")
    a = ap.parse_args(argv)
    if cuda_missing(a.device, "bench_chunk"):
        return 1

    os.makedirs(a.workdir, exist_ok=True)
    out: dict = {
        "label": a.label,
        "fasta_bytes": os.path.getsize(a.reads),
        "paf_bytes": os.path.getsize(a.paf),
        "device": a.device,
    }
    if a.disk_bw:
        out["disk_read_mb_s"] = round(measure_read_bw(a.reads), 1)
        out["disk_write_mb_s"] = round(measure_write_bw(a.workdir), 1)
    if a.cold:
        out["cold_page_cache"] = drop_caches()

    prefix = os.path.join(a.workdir, f"decomp_{a.label}")
    trace = prefix + ".trace.jsonl"
    extra = ["--chunk-reads", str(a.chunk)] if a.chunk else []
    wall, stats = run_traced(a.reads, a.paf, prefix, trace,
                             extra + ["--device", a.device])
    out.update(analyze(trace, wall, stats))
    out.update(run_facts(stats))
    out["output_bytes"] = sum(
        os.path.getsize(prefix + e) for e in OUT_EXTS
        if os.path.exists(prefix + e))
    ok = True
    if a.expect:
        out["equals_expected"] = cmp_outputs(prefix, a.expect)
        ok = out["all_equal"] = all(out["equals_expected"].values())
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
