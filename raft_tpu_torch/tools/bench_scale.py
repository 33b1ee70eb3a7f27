"""Mirrors raft_tpu/tools/bench_scale.py: the beyond-toy-scale runner of
the port.

The reference's real operating point is tens-of-GB inputs (32x ONT
human, ~100 GB RAM); the streaming machinery (``--chunk-reads``,
``--spill-paf``, the >2 GiB PAF auto-spill) exists for that regime. This
runner generates a >=512k-read / ~12 GB FASTA / ~30 M-row PAF dataset
(PAF > 2 GiB so the auto-spill threshold is genuinely crossed), then:

1. runs the whole-file pipeline in a FRESH process (the honest
   production invocation) via the port's CLI with ``--stats-json``;
2. runs the streaming pipeline (``--chunk-reads --spill-paf``) the same
   way;
3. byte-compares all four outputs between the two paths;
4. optionally (``--with-reference``) runs the compiled reference binary
   on the same inputs and byte-compares against it too;

and prints ONE JSON line with wall seconds, reads/s, and peak RSS for
every path. Each subprocess reports its own peak RSS (ours via
``--stats-json``; the reference via a rusage wrapper) so one run's
footprint never masks another's. Each of the port's runs also carries,
from its ``--stats-json``, the ``devices`` it ran on, its number of
buckets (``n_buckets``) and each CUDA kernel's launches (``launches``,
one of each per bucket on the card), so a run that did not touch the
card shows.

Usage::

    python -m raft_tpu_torch.tools.bench_scale [--reads 524288]
        [--rows-per-read 60] [--mean-len 23600] [--dir D] [--chunk 32768]
        [--device {cuda,cpu}] [--with-reference] [--keep-outputs]

``--dir`` defaults to ``raft_bigbench`` under the temporary directory;
the dataset is cached there by its shape. ``--device`` (default cuda) is
passed to every run; ``cuda`` without a CUDA device exits 1 before
anything is generated. Runs are sequential.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from raft_tpu_torch.bench import ARGS, cuda_missing

OUT_EXTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
            ".long_repeats.bed"]


def run_facts(st: dict) -> dict:
    """What a port run's ``--stats-json`` says of where it ran."""
    return {"devices": st.get("devices"), "n_buckets": len(st["buckets"]),
            "n_chunks": st.get("n_chunks"), "launches": st.get("launches")}


def _run_ours(reads: str, paf: str, prefix: str, extra: list[str],
              stats_path: str) -> dict:
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.cli"] + ARGS
        + ["--stats-json", stats_path] + extra + ["-o", prefix, reads, paf],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, timeout=7200)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"pipeline run failed (rc={res.returncode}): "
            f"{res.stderr[-2000:].decode(errors='replace')}")
    with open(stats_path) as f:
        st = json.load(f)
    return {"wall_s": round(wall, 2), "peak_rss_mb": round(st["peak_rss_mb"]),
            "stage_seconds": {k: round(v, 2)
                              for k, v in st["stage_seconds"].items()},
            "n_fragments": st["n_fragments"],
            "emit_mb_per_s": st.get("emit_mb_per_s"), **run_facts(st)}


def _run_reference(ref_bin: str, reads: str, paf: str, prefix: str) -> dict:
    """Run the reference under a rusage wrapper subprocess so its peak
    RSS is measured without polluting this process's children max."""
    wrapper = (
        "import subprocess, resource, sys, json, time\n"
        "t0 = time.perf_counter()\n"
        "p = subprocess.run(sys.argv[1:], stdout=subprocess.DEVNULL)\n"
        "print(json.dumps({'wall_s': time.perf_counter() - t0,\n"
        "  'rc': p.returncode,\n"
        "  'peak_rss_mb': resource.getrusage(\n"
        "      resource.RUSAGE_CHILDREN).ru_maxrss / 1024}))\n")
    res = subprocess.run(
        [sys.executable, "-c", wrapper, ref_bin] + ARGS
        + ["-o", prefix, reads, paf],
        capture_output=True, timeout=14400, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"reference run failed: {res.stderr[-2000:]}")
    j = json.loads(res.stdout.strip().splitlines()[-1])
    if j["rc"] != 0:
        raise RuntimeError(f"reference exited rc={j['rc']}")
    return {"wall_s": round(j["wall_s"], 2),
            "peak_rss_mb": round(j["peak_rss_mb"])}


def cmp_outputs(a_prefix: str, b_prefix: str) -> dict:
    """Each of the four outputs: byte-equal (``cmp``)?"""
    out = {}
    for ext in OUT_EXTS:
        res = subprocess.run(["cmp", "-s", a_prefix + ext, b_prefix + ext])
        out[ext] = res.returncode == 0
    return out


def remove_outputs(prefix: str) -> None:
    for ext in OUT_EXTS:
        try:
            os.remove(prefix + ext)
        except OSError:
            pass


def build_reference(work: str) -> str | None:
    from raft_tpu_torch.tools.refbuild import build_reference as _build
    return _build(work)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=524288)
    ap.add_argument("--rows-per-read", type=int, default=60)
    ap.add_argument("--mean-len", type=int, default=23600,
                    help="mean read length (the many-small-reads axis: "
                         "e.g. --reads 4000000 --mean-len 2500)")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "raft_bigbench"))
    ap.add_argument("--chunk", type=int, default=32768)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--with-reference", action="store_true")
    ap.add_argument("--keep-outputs", action="store_true")
    args = ap.parse_args(argv)
    if cuda_missing(args.device, "bench_scale"):
        return 1
    dev = ["--device", args.device]

    os.makedirs(args.dir, exist_ok=True)
    from raft_tpu_torch.tools.benchgen import gen_dataset
    t0 = time.perf_counter()
    # the prefix encodes every shape knob: gen_dataset caches by
    # existence, so a changed length must not silently reuse stale data
    tag = f"scale{args.reads}" if args.mean_len == 23600 \
        else f"scale{args.reads}_len{args.mean_len}"
    reads, paf = gen_dataset(
        os.path.join(args.dir, tag), n_reads=args.reads,
        mean_len=args.mean_len,
        n_overlaps=args.reads * args.rows_per_read, est_cov=20)
    gen_s = time.perf_counter() - t0
    sizes = {"fasta_gb": round(os.path.getsize(reads) / 1e9, 2),
             "paf_gb": round(os.path.getsize(paf) / 1e9, 2)}
    print(f"dataset ready in {gen_s:.0f}s: {sizes}", file=sys.stderr)

    result = {"n_reads": args.reads,
              "n_paf_rows": args.reads * args.rows_per_read, **sizes,
              "device": args.device, "gen_s": round(gen_s, 1)}

    whole_prefix = os.path.join(args.dir, "out_whole")
    print("== whole-file run ==", file=sys.stderr)
    # --chunk-reads 0 pins the true whole-file schedule (inputs this big
    # would otherwise auto-stream; the A/B needs both paths)
    result["whole"] = _run_ours(reads, paf, whole_prefix,
                                ["--chunk-reads", "0", *dev],
                                os.path.join(args.dir, "whole_stats.json"))
    result["whole"]["reads_per_s"] = round(
        args.reads / result["whole"]["wall_s"], 1)
    print(json.dumps(result["whole"]), file=sys.stderr)

    chunk_prefix = os.path.join(args.dir, "out_chunk")
    print("== chunked+spill run ==", file=sys.stderr)
    result["chunked"] = _run_ours(
        reads, paf, chunk_prefix,
        ["--chunk-reads", str(args.chunk), "--spill-paf", *dev],
        os.path.join(args.dir, "chunk_stats.json"))
    result["chunked"]["reads_per_s"] = round(
        args.reads / result["chunked"]["wall_s"], 1)
    result["chunked"]["chunk_reads"] = args.chunk
    print(json.dumps(result["chunked"]), file=sys.stderr)

    result["whole_vs_chunked_equal"] = cmp_outputs(whole_prefix, chunk_prefix)
    print(f"whole vs chunked: {result['whole_vs_chunked_equal']}",
          file=sys.stderr)

    if args.with_reference:
        ref_bin = build_reference(args.dir)
        if ref_bin:
            ref_prefix = os.path.join(args.dir, "out_ref")
            print("== reference run ==", file=sys.stderr)
            result["reference"] = _run_reference(ref_bin, reads, paf,
                                                 ref_prefix)
            result["reference"]["reads_per_s"] = round(
                args.reads / result["reference"]["wall_s"], 1)
            result["whole_vs_reference_equal"] = cmp_outputs(whole_prefix,
                                                      ref_prefix)
            print(json.dumps(result["reference"]), file=sys.stderr)
            print(f"whole vs reference: "
                  f"{result['whole_vs_reference_equal']}", file=sys.stderr)
            if not args.keep_outputs:
                remove_outputs(ref_prefix)

    if not args.keep_outputs:
        for p in (whole_prefix, chunk_prefix):
            remove_outputs(p)

    ok = all(result["whole_vs_chunked_equal"].values()) and all(
        result.get("whole_vs_reference_equal", {"": True}).values())
    result["all_equal"] = ok
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
