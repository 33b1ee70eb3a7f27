"""Mirrors raft_tpu/tools/bench_gz_scale.py: the gz-input scale proof on
the port.

The reference's contract is gz-everywhere (``kseq.h`` over ``gzFile``)
and real HiFi inputs ship gzipped. This runner takes a pre-generated
plain dataset (``bench_scale``'s) and:

1. produces the compressed variants — plain-gz via the ``gzip`` CLI
   (the real-world artifact: one serial DEFLATE stream) and BGZF via
   the port's block-parallel ``io.native.bgzf_compress_file`` (bgzip
   wire-compatible);
2. measures the decompression floors in isolation (``gzip -dc`` wall =
   the serial inflate floor; BGZF index wall via ``io.native.index_reads``);
3. runs the port's default auto-streaming CLI on plain, gz, and BGZF
   inputs — fresh process each, cold page cache optional, per-stage
   ``RAFT_CHUNK_TRACE`` attribution — and byte-compares all four outputs
   of every variant against the plain run;
4. prints ONE JSON with walls, stage splits, floors, and parity flags;
   each run also carries its ``devices``, bucket count and kernel
   launches from its ``--stats-json``.

Usage::

    python -m raft_tpu_torch.tools.bench_gz_scale \\
        --reads D/scale524288.reads.fasta --paf D/scale524288.overlaps.paf \\
        --dir D/gzscale [--device {cuda,cpu}] [--cold] [--with-reference]

``--device`` (default cuda) is passed to every run; ``cuda`` without a
CUDA device exits 1 before anything is compressed. Runs are sequential.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from raft_tpu_torch.bench import ARGS, cuda_missing
from raft_tpu_torch.tools.bench_chunk import drop_caches
from raft_tpu_torch.tools.bench_scale import (cmp_outputs, remove_outputs,
                                              run_facts)


def _run_ours(reads: str, paf: str, prefix: str, stats: str,
              trace: str, device: str) -> dict:
    env = dict(os.environ, RAFT_CHUNK_TRACE=trace)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.cli", *ARGS,
         "--device", device, "--stats-json", stats, "-o", prefix, reads,
         paf],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, timeout=7200,
        env=env, text=True)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"run failed rc={res.returncode}: "
                           f"{res.stderr[-2000:]}")
    out = {"wall_s": round(wall, 1)}
    try:
        with open(stats) as f:
            st = json.load(f)
        out["stage_seconds"] = {k: round(v, 2)
                                for k, v in st["stage_seconds"].items()}
        out["peak_rss_mb"] = round(st.get("peak_rss_mb", 0))
        out.update(run_facts(st))
    except (OSError, ValueError, KeyError):
        pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", required=True)
    ap.add_argument("--paf", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before every timed pass")
    ap.add_argument("--with-reference", action="store_true")
    ap.add_argument("--keep-outputs", action="store_true")
    a = ap.parse_args(argv)
    if cuda_missing(a.device, "bench_gz_scale"):
        return 1
    os.makedirs(a.dir, exist_ok=True)
    result: dict = {"cold_page_cache": bool(a.cold),
                    "fasta_bytes": os.path.getsize(a.reads),
                    "paf_bytes": os.path.getsize(a.paf),
                    "device": a.device}

    # -- compressed variants (cached across invocations) ---------------
    gz_reads = os.path.join(a.dir, os.path.basename(a.reads) + ".gz")
    gz_paf = os.path.join(a.dir, os.path.basename(a.paf) + ".gz")
    bg_reads = os.path.join(a.dir,
                            os.path.basename(a.reads) + ".bgzf.gz")
    bg_paf = os.path.join(a.dir, os.path.basename(a.paf) + ".bgzf.gz")
    for src, dst in ((a.reads, gz_reads), (a.paf, gz_paf)):
        if not os.path.exists(dst):
            # write to a temp name + rename: a killed/failed gzip must
            # not leave a truncated artifact a later run silently reuses
            t0 = time.perf_counter()
            tmp = dst + ".tmp"
            with open(tmp, "wb") as f:
                subprocess.run(["gzip", "-c", "-5", src], stdout=f,
                               check=True)
            os.replace(tmp, dst)
            result[f"gzip_compress_s_{os.path.basename(src)}"] = round(
                time.perf_counter() - t0, 1)
    from raft_tpu_torch.io import native
    for src, dst in ((a.reads, bg_reads), (a.paf, bg_paf)):
        if not os.path.exists(dst):
            t0 = time.perf_counter()
            tmp = dst + ".tmp"
            if not native.bgzf_compress_file(src, tmp):
                raise RuntimeError(f"bgzf compress failed for {src}")
            os.replace(tmp, dst)
            result[f"bgzf_compress_s_{os.path.basename(src)}"] = round(
                time.perf_counter() - t0, 1)
    result["gz_fasta_bytes"] = os.path.getsize(gz_reads)
    result["bgzf_fasta_bytes"] = os.path.getsize(bg_reads)

    # -- decompression floors, measured in isolation -------------------
    if a.cold and not drop_caches():
        result["cold_page_cache"] = "requested_but_drop_failed"
    t0 = time.perf_counter()
    with open(os.devnull, "wb") as dn:
        subprocess.run(["gzip", "-dc", gz_reads], stdout=dn, check=True)
    result["floor_serial_inflate_s"] = round(time.perf_counter() - t0, 1)
    if a.cold and not drop_caches():
        result["cold_page_cache"] = "requested_but_drop_failed"
    t0 = time.perf_counter()
    idx = native.index_reads(bg_reads)
    result["floor_bgzf_index_s"] = round(time.perf_counter() - t0, 1)
    result["bgzf_index_n"] = int(idx["n"]) if idx else None
    del idx

    # -- the three pipeline runs ---------------------------------------
    runs = [("plain", a.reads, a.paf),
            ("gz", gz_reads, gz_paf),
            ("bgzf", bg_reads, bg_paf)]
    for name, r, p in runs:
        if a.cold and not drop_caches():
            result["cold_page_cache"] = "requested_but_drop_failed"
        print(f"== {name} run ==", file=sys.stderr)
        result[name] = _run_ours(
            r, p, os.path.join(a.dir, f"out_{name}"),
            os.path.join(a.dir, f"stats_{name}.json"),
            os.path.join(a.dir, f"trace_{name}.jsonl"), a.device)
        print(json.dumps(result[name]), file=sys.stderr)

    for name in ("gz", "bgzf"):
        result[f"{name}_equals_plain"] = cmp_outputs(
            os.path.join(a.dir, "out_plain"),
            os.path.join(a.dir, f"out_{name}"))
        if not a.keep_outputs:
            remove_outputs(os.path.join(a.dir, f"out_{name}"))

    if a.with_reference:
        from raft_tpu_torch.tools.refbuild import build_reference
        ref_bin = build_reference(a.dir)
        if ref_bin:
            if a.cold and not drop_caches():
                result["cold_page_cache"] = "requested_but_drop_failed"
            print("== reference gz run ==", file=sys.stderr)
            t0 = time.perf_counter()
            rp = os.path.join(a.dir, "out_refgz")
            res = subprocess.run(
                [ref_bin, *ARGS, "-o", rp, gz_reads, gz_paf],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=7200)
            result["reference_gz"] = {
                "wall_s": round(time.perf_counter() - t0, 1),
                "rc": res.returncode}
            result["reference_gz_equals_plain"] = cmp_outputs(
                os.path.join(a.dir, "out_plain"), rp)
            if not a.keep_outputs:
                remove_outputs(rp)

    ok = all(all(result[k].values())
             for k in result if k.endswith("_equals_plain"))
    result["all_equal"] = ok
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
