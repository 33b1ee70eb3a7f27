"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; one card
    python3 chip_smoke.py --multi-card  # two or more cards of one host
    python3 chip_smoke.py --ab DIR      # this kernel against DIR's; one card

The device step runs two hand-written kernels a bucket, each built from
``raft_tpu_torch/csrc``: the coverage pileup (``csrc/pileup.cu``), then
``scan_chop`` (``csrc/scan_chop.cu``: the repeat scan, markers and
fragments, the ``diff8`` diff and the packing); one more, the gather
(``csrc/gather.cu``), writes every bucket's device inputs from one copy
of the event table, once per ``compute_torch`` and device. Wherever a
step below holds "the kernel" against its plain twin on a bucket, it
holds both:
the pileup on the bucket's device inputs, then ``scan_chop`` on the
kernel's coverage and the bucket's lengths, every output exactly.

1. Prints the card (torch's name, and nvidia-smi's name, power limit and
   compute mode).
2. Builds the CUDA kernels from ``raft_tpu_torch/csrc`` with nvcc, into
   one library.
3. Holds the pileup kernel against its plain PyTorch twin on the card,
   exactly, on synthetic buckets: main-path shapes, a W=64 tail, two
   multi-stripe ultralong tiers, a width in each regime whose rows are not
   16-byte aligned (the int-store path), the wide buckets of the
   ultra-long ONT cell ((2048, 4096), (384, 8192), (32, 32768)), pack32
   and pairs, with empty
   rows, invalid events and padding; prints per shape the launch plan,
   both median times, the bound (the bytes the pileup must move over 3.35
   TB/s) and the kernel's share of it. Then (3b) ``scan_chop`` against its
   twin, exactly, in ``host`` and ``diff8`` mode, on ``SCAN_CHOP_CASES``:
   the pileup kernel's output at (4096, 512) and (8, 2^20) with the bench
   flags, crafted rows (alternating runs, no run, padding, int8
   overflow) over a parameter sweep, and few wide rows in the kernel's
   cluster regime (a run across every block boundary, a row high
   throughout, a read ending mid-block, rep_n > K, a wrapped flank, an
   int8 overflow at a block boundary; slots and survivors past shared
   memory), then those rows at the ultra-long ONT cell's three wide
   shapes with the bench flags; each with both median times and its bound
   (``scan_chop_bound``).
4. Checks the CLI's ``--device cuda`` output against the numpy oracle
   engine on a small dataset, then runs the whole-file CLI on the 32k-read
   bench dataset (``gen_dataset``, seed 7) with ``--device cuda`` and
   ``--device cpu``, compares the four output files byte for byte, and
   checks that the CUDA run launched each kernel once per bucket it
   reported (the gather once). Then holds both kernels against their
   plain twins, exactly, on every bucket of that dataset as the engine
   hands it to the device, and checks those are the buckets the CLI run
   reported; then the gather against its plain twin and ``host_inputs``
   of every bucket, pack32 and pairs, on that dataset's table and on a
   table of megabase reads whose widest steps have int32 event columns
   (``wide_table``), timed on the dataset against its bytes.
5. Compressed inputs on the 32k dataset with ``--device cuda``: a gzip
   copy (the ``gzip`` command, one DEFLATE stream) and a BGZF copy
   (``io.native.bgzf_compress_file``) of both files. These take the
   compressed read path: no early reservation of the fragment FASTA.
   The BGZF run also passes ``--cov-out diff8``, which the port accepts
   for ``raft_tpu`` command lines and renders on the host as every mode.
   Each run must give the ``host`` run's files byte for byte.
6. Read sharding and multi-process runs on the 32k dataset, each
   byte-equal to the unsharded ``--device cuda`` run:
   a. the CLI with ``--devices 1 --device cuda``;
   b. ``run_pipeline(devices=[cuda:0] * 4)``, four shards on one card,
      whole-file and ``--chunk-reads 8192``, each timed in turns with the
      unsharded run (unsharded, sharded, sharded, unsharded); every timed
      sharded run must have launched each kernel once per shard it
      records, and an untimed rerun holds every shard of every bucket
      against the plain twins, exactly;
   c. ``run_distributed`` in two processes (gloo over 127.0.0.1), both
      ranks on ``cuda:0`` when the card's compute mode is ``Default``
      (otherwise rank 1 runs on the CPU, and a line says so); rank 0's
      concatenated shards must equal the single run. Each rank holds every
      device step of its engine against the plain twins, exactly, at the
      rank's own bucket shapes, and prints its wall and its launch counts,
      which must be one of each kernel per step.
7. ``--trace DIR`` on the small dataset with ``--device cuda`` (the
   process's first profiler session): the Chrome trace must name both
   kernels, once per launch. Then ``--pallas`` and ``--no-pallas`` on it:
   each launches each kernel once per bucket and writes the step 4 run's
   files. Then (7b) one ``compute_torch`` pass over the 32k dataset in
   ``host`` mode under torch.profiler, after a warm-up pass in the same
   session: the card runs the two kernels once per bucket each, the
   gather once, and copies, nothing else.
8. Streaming at real size: a 100k-read dataset (``gen_dataset``, seed 7,
   about 2.4 GB of FASTA, over the 2 GB auto-chunk gate) run by the
   default CLI with ``--device cuda`` must auto-stream in 4 chunks (with
   ``RAFT_CHUNK_TRACE``, printed per chunk); then ``--chunk-reads 0``
   (whole-file) and ``--spill-paf --chunk-reads 8192`` on the same data.
   After each timed run, an untimed rerun of the same path through
   ``run_pipeline`` holds the kernel against its plain twin, exactly, on
   every bucket of every chunk as the engine hands it over, and checks
   those are the timed run's buckets. Last, ``--chunk-reads 0 --device
   cpu``. The four files of all seven runs must be equal: each run's
   outputs are hashed (SHA-256) and deleted, so the disk holds the inputs
   plus one run's outputs (about 6 GB); the dataset and the last run's
   outputs go before step 9.
9. The ground-truth evaluation (``raft_tpu_torch.tools.eval_repeats``)
   on the card, every point counting its own pileup launches (reset just
   before, read just after: one per bucket of the product run and of the
   ``compute_torch`` pass) and printing its wall, simulation, product-run
   and ``compute_torch`` seconds:
   a. ``run_sweep`` at 2 and 10 Mbp, seeds 11 and 23, ``run_noise_sweep``
      at 2 Mbp and the two noisy ``--auto-e`` points: each of the 44 rows
      must equal its recorded row (``EVAL_RECORDS``) field for field;
   b. the 2 and 10 Mbp seed-11 1x points again with ``--device cpu``,
      for contrast: the same rows;
   c. the 10 Mbp seed-11 1x point's product run again through
      ``run_pipeline``, every bucket held against the plain twin (the
      launches to compare and time do not count); the point launched the
      kernel twice per bucket held, and the outputs are SHA-256-equal;
   d. ``asm_proxy`` on the 1x points' fragments and on the header tiling
      of the reads must give EVAL.md's contiguity table
      (``ASM_PROXY_TABLE``);
   e. one point at genome scale (``EVAL_BIG``: ~156k reads, ~3.0 GB of
      FASTA, so the product run streams; ``EVAL_BIG_FAMS`` repeat
      families keep the repeat density of the 2 Mbp points): at least 2
      chunks and the quality thresholds of ``tests/test_eval_quality.py``;
      the product run again, streamed and then ``--chunk-reads 0`` (the
      ``compute_torch`` pass's buckets), every bucket held against the
      plain twin and the outputs SHA-256-equal; and the point again with
      ``--device cpu``: the same row and outputs (about 8 GB of disk).
10. Checks that neither jax nor any ``raft_tpu`` module was imported,
   prints the kernel table (``pileup``, ``scan_chop`` and ``gather``) as
   one JSON line, then ``{"ok": true, "device": {...}}`` as the last
   line.

Every CLI run on the card (steps 4-8) counts its own launches of each
kernel (reset just before, read just after) and must have launched the
pileup and ``scan_chop`` once per bucket it reports and the gather once
per chunk and card; it prints its wall, reads/s, stage seconds
and peak ``torch.cuda.max_memory_allocated``.

Only ``raft_tpu_torch`` is imported; its native I/O builds with fixed
flags, whatever the environment's ``CXX``, ``CXXFLAGS`` and ``LDFLAGS``.
The environment's ``RAFT_AUTO_CHUNK_BYTES``, ``RAFT_CHUNK_TRACE`` and
``RAFT_SPANS`` are dropped, so every run takes the defaults; from step 4
on, ``RAFT_SPANS=1`` records the runs' spans, whose seconds the main-path
lines print.

``--multi-card`` runs steps 1-2 and then only what needs several cards,
on the 32k dataset: the CLI with ``--devices N`` over all N cards,
whole-file and ``--chunk-reads 8192``, each timed in turns with the
unsharded run on cuda:0 and rerun untimed with every shard held against
the plain twin on its own card; then ``run_distributed`` in N processes,
one card each (``CUDA_VISIBLE_DEVICES``), every launch held as in step
6c. All byte-equal to the unsharded run; the same two closing lines.

``--ab DIR`` runs steps 1-2, builds the kernels of another tree (DIR
holds its ``raft_tpu_torch/``, e.g. a ``git archive`` of the parent
commit) with that tree's own wrappers, and times each pair in turns
(DIR's, this, this, DIR's), each held exactly against the plain twin:
the pileup on step 3's shapes and on the 32k main path's buckets,
``scan_chop`` on step 3b's inputs (``host`` and ``diff8``) and on the
32k buckets' coverage.

Any failed check exits nonzero before the last line. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import filecmp
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_READS = 32000          # the main-path dataset (gen_dataset, seed 7)
N_BIG = 100_000          # streaming dataset: ~2.4 GB FASTA, over the gate
N_BIG_OVERLAPS = 3_000_000
BIG_CHUNKS = 4           # ceil(100000 / DEFAULT_CHUNK_READS = 32768)
SPILL_CHUNK = 8192
N_SHARDS = 4             # shards on one card (step 6b)
SHARD_CHUNK = 8192
# run-time overrides the run must not inherit
RAFT_ENV = ("RAFT_AUTO_CHUNK_BYTES", "RAFT_CHUNK_TRACE", "RAFT_SPANS")
# The H100 SXM's peaks at 700 W: HBM bytes/s (NVIDIA's data sheet), and
# int32 adds/s for the pileup's adds. The data sheet's 67 TFLOP/s float32
# is 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz; an SM has 64 int32
# lanes, so 132 x 64 x 1.98 GHz.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
BENCH_ARGS = ["-e", "20", "-m", "1.5", "-p", "10000", "-l", "20000",
              "-f", "1000", "-v", "500"]
OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
# (B, W, events per row, wire format): synthetic buckets at the 32k bench
# dataset's main shapes, a tail, two ultralong tiers of few rows, one
# width per regime with W % 4 != 0 (rows leave by int stores, not TMA),
# and the wide buckets of the ultra-long ONT cell (ontul30x.whole:
# regime 2 at every one, events a row as its reads get them)
KERNEL_CASES = [
    (4096, 512, 60, "pack32"), (1536, 1024, 120, "pack32"),
    (384, 256, 30, "pack32"), (384, 256, 30, "pairs"), (8, 64, 10, "pack32"),
    (8, 1 << 16, 3000, "pairs"), (8, 1 << 20, 20000, "pairs"),
    (33, 7, 5, "pack32"), (2, 65538, 3000, "pairs"),
    (2048, 4096, 160, "pack32"), (384, 8192, 250, "pack32"),
    (32, 32768, 480, "pack32")]
# Step 3b, scan_chop on the card: (label, B, W, AlgoParams fields or None
# for the bench flags, coverage source, K or None for derive_cfg's). The
# two bench shapes on the pileup kernel's output, then crafted rows over a
# sweep: a small -p (M in the thousands at W=4096), repeat_length = reso
# (K = W/2 + 1; at W=8192 too many slots for the rows regime), -f 0
# with div 1 and -v 0, a flank larger than a read, a flank whose products
# wrap int32 (repeat slots out of order: the kernel's linear scan). Then
# few wide rows (``wide_rows``), the cluster regime: the bench flags at
# 2^20 and at a width that is neither a multiple of the tile nor of 4,
# more runs than K slots, a wrapped flank and repeat_length = reso (more
# slots than a block copies to shared memory), a small -p (survivors in
# the global scratch). Last, the wide buckets of the ultra-long ONT cell
# with the bench flags: rows at (2048, 4096), the cluster regime at
# (384, 8192) and (32, 32768).
BENCH_FIELDS = dict(repeat_length=10000, interval_length=10000,
                    read_length=20000, flanking_length=1000,
                    overlap_length=500)
SCAN_CHOP_CASES = [
    ("bench", 4096, 512, None, "pileup", None),
    ("bench", 8, 1 << 20, None, "pileup", None),
    ("small -p", 64, 4096, dict(repeat_length=100, interval_length=100,
                                read_length=200, flanking_length=1000,
                                overlap_length=50), "crafted", None),
    ("repeat_length = reso", 256, 1024, dict(
        repeat_length=50, interval_length=1000, read_length=2000,
        flanking_length=100, overlap_length=100), "crafted", None),
    ("repeat_length = reso, W 8192", 64, 8192, dict(
        repeat_length=50, interval_length=1000, read_length=2000,
        flanking_length=100, overlap_length=100), "crafted", None),
    ("-f 0, div 1, -v 0", 1024, 512, dict(
        repeat_length=1000, interval_length=2000, read_length=2000,
        flanking_length=0, overlap_length=0), "crafted", None),
    ("flank > read", 1024, 512, dict(
        repeat_length=1000, interval_length=2000, read_length=5000,
        flanking_length=100_000, overlap_length=500), "crafted", None),
    ("flank wraps int32", 256, 512, dict(
        repeat_length=300, interval_length=1000, read_length=2000,
        flanking_length=2**31 - 1 - 10_000, overlap_length=200),
     "crafted", None),
    ("wide bench", 8, 1 << 20, BENCH_FIELDS, "wide", None),
    ("wide bench, W % 4 != 0", 8, 100_001, BENCH_FIELDS, "wide", None),
    ("wide rep_n > K", 8, 1 << 20, BENCH_FIELDS, "wide", 3),
    ("wide flank wraps int32", 8, 1 << 16, dict(
        repeat_length=300, interval_length=1000, read_length=2000,
        flanking_length=2**31 - 1 - 10_000, overlap_length=200), "wide",
     None),
    ("wide repeat_length = reso", 8, 1 << 16, dict(
        repeat_length=50, interval_length=1000, read_length=2000,
        flanking_length=100, overlap_length=100), "wide", None),
    ("wide small -p", 8, 1 << 17, dict(
        repeat_length=10000, interval_length=50, read_length=100,
        flanking_length=1000, overlap_length=20), "wide", None),
    ("ont_ul bench", 2048, 4096, BENCH_FIELDS, "wide", None),
    ("ont_ul bench", 384, 8192, BENCH_FIELDS, "wide", None),
    ("ont_ul bench", 32, 32768, BENCH_FIELDS, "wide", None),
]
# Step 9, the evaluation path: the recorded rows of the ground-truth
# evaluation (both sweeps at 30x, 3 repeat families x 4 copies x 15 kb)
EVAL_RECORDS = ("EVAL_sweep_r05.jsonl", "EVAL_noise_r05.jsonl")
EVAL_SIZES = (2_000_000, 10_000_000)
EVAL_SEEDS = (11, 23)
EVAL_HELD = (10_000_000, 11)     # the 1x point rerun with every bucket held
EVAL_BIG = 100_000_000           # the genome-scale point: ~3.0 GB of FASTA
# ... with the 2 Mbp points' repeat density (3 families of 4 x 15 kb per
# 2 Mbp). With the default 3 families its truth stays 180 kb while the
# prediction outside it grows with the genome: its flank-tolerant
# precision is 0.8207 on the card and with --device cpu alike (the same
# row), under the 0.95 the thresholds assume.
EVAL_BIG_FAMS = 3 * EVAL_BIG // 2_000_000
EVAL_NOISY = dict(drop_rate=0.2, spurious_rate=0.1, jitter_sd=100.0)
# EVAL.md:211-214, exactly (the table rounds them): (genome, seed) ->
# RAFT's (NG50, contigs, ambiguous breaks), the position-blind tiling's
ASM_PROXY_TABLE = {
    (2_000_000, 11): ((593_307, 5, 4), (258_450, 11, 9)),
    (2_000_000, 23): ((1_299_061, 3, 2), (460_227, 7, 6)),
    (10_000_000, 11): ((9_997_413, 1, 0), (1_723_428, 11, 10)),
    (10_000_000, 23): ((5_765_326, 5, 4), (1_567_837, 9, 8))}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def zero_launches() -> None:
    """Every kernel's launch count to 0, just before the run to count."""
    from raft_tpu_torch.ops import _lib
    _lib.zero_launches()


def launch_counts() -> dict:
    """Each kernel's launches since ``zero_launches``."""
    from raft_tpu_torch.ops import _lib
    return _lib.launch_counts()


def once_each(counts: dict, n: int, label: str, computes: int) -> None:
    """Fails unless the pileup and ``scan_chop`` launched ``n`` > 0 times
    each and the gather ``computes`` times: once per ``compute_torch``
    and device."""
    check(n > 0 and counts == {"pileup": n, "scan_chop": n,
                               "gather": computes},
          f"{label}: launches {counts}, not {n} of the pileup and "
          f"scan_chop and {computes} of the gather")


def computes_of(st: dict) -> int:
    """A run's gather launches, from its stats: one per chunk (one
    ``compute_torch`` each) and distinct device."""
    return st["n_chunks"] * len(set(st["devices"]))


def device_ms(torch, fn, launches=20, rounds=5) -> float:
    """Median device milliseconds per call of ``fn``: a sleep kernel keeps
    the GPU busy while the host enqueues ``launches`` calls, so the events
    bracket device execution only, not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / launches)
    return statistics.median(per)


def make_case(np, et, params, B, W, per_row, wire, rng):
    """One bucket's device inputs from a seed: Poisson slabs with ~10%
    empty rows, ~5% invalid events, span clamping at the row end, and a
    padded tail after ev_off[B]."""
    counts = rng.poisson(per_row, B)
    counts[rng.random(B) < 0.1] = 0
    tot = int(counts.sum())
    E = tot + max(64, tot // 8)
    ev_off = np.zeros(B + 1, dtype=np.int32)
    ev_off[1:] = np.cumsum(counts)
    w0 = rng.integers(0, W, E)
    w1 = np.where(rng.random(E) < 0.05, -1,
                  w0 + rng.integers(0, min(W, 800), E))
    cfg = et.derive_cfg(B, W, E, params)
    if wire == "pairs":
        cfg = dataclasses.replace(cfg, ev_pack=0)
    pk = et.pack_events(w0, w1, cfg)
    if pk.dtype == np.uint32:
        pk = pk.view(np.int32)
    return cfg, ev_off, pk


def bound(cfg, off_d):
    """The least milliseconds the card could take for one pileup, and what
    bounds it: the bytes (the B+1 offsets and the events the rows
    reference read once, the coverage written once) over HBM_BYTES_S, or
    the adds (two per referenced event, one per window) over INT32_OPS_S."""
    off = off_d.cpu()
    n_ev = max(0, min(int(off[-1]), cfg.E) - max(int(off[0]), 0))
    nbytes = (4 * (cfg.B + 1) + (4 if cfg.ev_pack == 32 else 8) * n_ev
              + 4 * cfg.B * cfg.W)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = (2 * n_ev + cfg.B * cfg.W) / INT32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def plan_text(plan) -> str:
    return (f"regime {plan.regime} grid {plan.grid[0]}x{plan.grid[1]} "
            f"block {plan.block} stripe {plan.stripe} smem {plan.smem} "
            f"{'tma' if plan.tma_store else 'int'}")


def scan_chop_bound(np, cfg, packed):
    """The least milliseconds the card could take for one ``scan_chop``,
    and what bounds it: the bytes (the coverage and lengths read once,
    the packed rows written once, the int8 diff written in ``diff8``
    mode; the kernel's own marker scratch is not the function's) over
    HBM_BYTES_S, or
    the operations over INT32_OPS_S: four a window in each of the two
    scans, per marker candidate a binary search over the row's filled
    repeat slots (this run's ``rep_n``), six a fragment column."""
    B, W, M, K, F = cfg.B, cfg.W, cfg.M, cfg.K, cfg.F
    nbytes = (4 * B * W + 4 * B + 4 * B * (2 * K + 2 * F + 5)
              + (B * W if cfg.cov_out == "diff8" else 0))
    slots = np.minimum(packed[:, 2 * K + 2 * F].astype(np.int64), K)
    ops = (8 * B * W + int((M * (2 + np.ceil(np.log2(slots + 1)))).sum())
           + 6 * B * F)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / INT32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def hold_scan_chop(torch, np, cfg, cov, lens_d, label, times=None):
    """``scan_chop``'s kernel against its plain twin on one bucket's
    coverage and lengths, exactly (every output); both median times and
    the bound. With a ``times`` dict, a (B, W, M, K, F, mode) shape
    already in it on the same device is compared but not timed again.
    Returns the row's ``sc_*`` fields."""
    from raft_tpu_torch.ops import scan_chop_cuda
    dev = cov.device
    got = scan_chop_cuda.scan_chop(cov, lens_d, cfg)
    want = scan_chop_cuda.scan_chop_torch(cov, lens_d, cfg)
    torch.cuda.synchronize()
    err = max(int((got[k].long() - want[k].long()).abs().max().item())
              for k in want)
    check(set(got) == set(want) and err == 0
          and all(torch.equal(got[k], want[k]) for k in want),
          f"{label}: scan_chop kernel != plain at B={cfg.B} W={cfg.W} "
          f"{cfg.cov_out} on {dev} (max |err| {err})")
    packed = got["packed"].cpu().numpy()
    bms, by = scan_chop_bound(np, cfg, packed)
    key = ("scan_chop", cfg.B, cfg.W, cfg.M, cfg.K, cfg.F, cfg.cov_out,
           str(dev))
    if times is not None and key in times:
        ms, plain = times[key]
    else:
        ms = device_ms(torch,
                       lambda: scan_chop_cuda.scan_chop(cov, lens_d, cfg))
        plain = device_ms(
            torch, lambda: scan_chop_cuda.scan_chop_torch(cov, lens_d, cfg),
            launches=5, rounds=3)
        if times is not None:
            times[key] = ms, plain
        plan = scan_chop_cuda.launch_plan(
            cfg.B, cfg.W, cfg.M, cfg.K, cfg.F,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"{label} scan_chop B={cfg.B:5d} W={cfg.W:8d} M={cfg.M} "
              f"K={cfg.K} F={cfg.F} {cfg.cov_out} {dev} regime "
              f"{plan.regime} cluster {plan.cluster} block {plan.block} "
              f"exact, rep_n "
              f"{int(packed[:, 2 * cfg.K + 2 * cfg.F].sum())}  kernel "
              f"{ms:.4f} ms  plain {plain:.4f} ms  bound {bms:.5f} ms "
              f"({by})  share {bms / ms:.1%}")
    return dict(sc_max_abs_err=err, sc_ms=ms, sc_plain_ms=plain,
                sc_bound_ms=bms, sc_bound_by=by)


def hold(torch, pileup_cuda, cfg, off_d, pk_d, label, times=None,
         lens_d=None):
    """Kernel against plain on one bucket's device inputs, exactly; both
    median times, the launch plan and the bound. With ``lens_d``, the
    bucket's lengths, ``scan_chop`` is held on the kernel's coverage too
    (``hold_scan_chop``). With a ``times`` dict, a (B, W, E, wire) shape
    already in it on the same device is compared but not timed again,
    and prints nothing. Returns the table row."""
    import numpy as np
    wire = "pairs" if cfg.ev_pack == 0 else "pack32"
    dev = off_d.device
    with torch.cuda.device(dev):  # synchronize and time on the tensors' card
        got = pileup_cuda.pileup(off_d, pk_d, cfg)
        want = pileup_cuda.pileup_torch(off_d, pk_d, cfg)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        check(torch.equal(got, want) and err == 0,
              f"{label}: kernel != plain at B={cfg.B} W={cfg.W} {wire} on "
              f"{dev} (max |err| {err})")
        key = (cfg.B, cfg.W, cfg.E, wire, str(dev))
        bms, by = bound(cfg, off_d)
        if times is not None and key in times:
            ms, plain = times[key]
        else:
            ms = device_ms(torch,
                           lambda: pileup_cuda.pileup(off_d, pk_d, cfg))
            plain = device_ms(
                torch, lambda: pileup_cuda.pileup_torch(off_d, pk_d, cfg))
            if times is not None:
                times[key] = ms, plain
            plan = pileup_cuda.launch_plan(
                cfg.B, cfg.W, torch.cuda.get_device_properties(
                    dev).multi_processor_count)
            print(f"{label} B={cfg.B:5d} W={cfg.W:8d} E={cfg.E:8d} "
                  f"{wire:6s} {dev} exact  {plan_text(plan)}  kernel "
                  f"{ms:.4f} ms  plain {plain:.4f} ms  bound {bms:.5f} ms "
                  f"({by})  share {bms / ms:.1%}")
        row = dict(B=cfg.B, W=cfg.W, E=cfg.E, wire=wire, max_abs_err=err,
                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        if lens_d is not None:
            row.update(hold_scan_chop(torch, np, cfg, got, lens_d, label,
                                      times))
    return row


def kernel_phase(torch, np, et, pileup_cuda, params):
    rng = np.random.default_rng(7)
    rows = []
    for B, W, per_row, wire in KERNEL_CASES:
        cfg, ev_off, pk = make_case(np, et, params, B, W, per_row, wire, rng)
        off_d = torch.from_numpy(ev_off).cuda()
        pk_d = torch.from_numpy(np.ascontiguousarray(pk)).cuda()
        rows.append(hold(torch, pileup_cuda, cfg, off_d, pk_d, "synthetic"))
        check(int(pileup_cuda.pileup(off_d, pk_d, cfg).sum().item()) > 0,
              f"empty coverage at B={B} W={W}")
    return rows


def crafted_rows(np, rng, B, W, cfg):
    """Coverage and lengths of a bucket with every kind of row ``scan_chop``
    must get right, five in turn: random coverage with long high runs
    (some past the read's last window, every tenth row a whole read with
    one run that qualifies), alternating one-window runs, no run at all,
    padding (length 0), a jump that overflows int8 in the diff."""
    reso, hc = cfg.reso, cfg.high_cov
    lens = rng.integers(1, W * reso + 1, B).astype(np.int32)
    cov = rng.integers(0, 2 * hc + 1, (B, W)).astype(np.int32)
    for b in range(B):
        kind = b % 5
        if kind == 0:
            for _ in range(int(rng.integers(1, 5))):
                a = int(rng.integers(0, W))
                cov[b, a:a + int(rng.integers(1, W))] = hc + int(
                    rng.integers(0, 40))
            if b % 10 == 0:
                lens[b] = W * reso
                n = min(W, -(-cfg.repeat_length // reso) + 2)
                a = int(rng.integers(0, W - n + 1))
                cov[b, a:a + n] = hc
        elif kind == 1:
            cov[b] = np.where(np.arange(W) % 2 == 0, hc, hc - 1)
            lens[b] = W * reso
        elif kind == 2:
            cov[b] = rng.integers(0, hc, W)
        elif kind == 3:
            lens[b] = 0
        else:
            cov[b, int(rng.integers(0, W))] = 200
    return cov, lens


def wide_rows(np, rng, B, W, cfg):
    """``crafted_rows``, then the rows of a cluster regime's corners (B >=
    6): a run that crosses every block boundary of the row, a row high
    throughout, a read whose last window lies mid-block, padding, a jump
    of +-200 at the first window of the second and third blocks (int8
    overflow of the diff at a block boundary), and runs of the qualifying
    length one window apart (rep_n up to K)."""
    from raft_tpu_torch.ops import scan_chop_cuda
    cov, lens = crafted_rows(np, rng, B, W, cfg)
    hc, reso = cfg.high_cov, cfg.reso
    plan = scan_chop_cuda.launch_plan(B, W, cfg.M, cfg.K, cfg.F)
    span = (plan.seg * plan.block // 32 if plan.regime == 2 else W)
    full = W * reso
    cov[:6] = rng.integers(0, hc, (6, W))
    lens[:6] = full
    cov[0, span // 2:W - span // 2] = hc
    cov[1] = hc + 5
    n_win = min(W - 1, span * max(1, plan.cluster // 2) + span // 2 + 3)
    lens[2] = (n_win - 1) * reso + 1
    cov[2, n_win - 10:] = hc + 1
    lens[3] = 0
    cov[4, span:2 * span] = 200
    run = max(1, -(-cfg.repeat_length // reso))
    cov[5] = np.where(np.arange(W) % (run + 1) < run, hc, hc - 1)
    return cov, lens


def scan_chop_inputs(torch, np, et, pileup_cuda, params):
    """Step 3b's inputs, one per ``SCAN_CHOP_CASES`` entry: (label, cfg,
    coverage on the card, lengths on the card). Source ``pileup``: the
    pileup kernel's output on events as ``KERNEL_CASES`` has these shapes,
    reads of half to all the bucket's width, the last sixteenth padding;
    ``crafted``: ``crafted_rows``; ``wide``: ``wide_rows``."""
    from raft_tpu_torch.params import AlgoParams
    rng = np.random.default_rng(8)
    for label, B, W, fields, source, K in SCAN_CHOP_CASES:
        p = params if fields is None else AlgoParams(
            est_cov=params.est_cov, cov_mul=params.cov_mul, **fields)
        if source == "pileup":
            cfg, ev_off, pk = make_case(np, et, p, B, W, 60 if W < 4096
                                        else 20000, "pack32" if W < 4096
                                        else "pairs", rng)
            cov = pileup_cuda.pileup(
                torch.from_numpy(ev_off).cuda(),
                torch.from_numpy(np.ascontiguousarray(pk)).cuda(), cfg)
            lens = rng.integers(W * cfg.reso // 2, W * cfg.reso + 1,
                                B).astype(np.int32)
            lens[B - max(1, B // 16):] = 0
        else:
            cfg = et.derive_cfg(B, W, 64, p)
            if K is not None:
                cfg = dataclasses.replace(cfg, K=K)
            build = crafted_rows if source == "crafted" else wide_rows
            cov_h, lens = build(np, rng, B, W, cfg)
            cov = torch.from_numpy(cov_h).cuda()
        yield label, cfg, cov, torch.from_numpy(lens).cuda()


def scan_chop_phase(torch, np, et, pileup_cuda, params):
    """``scan_chop`` against its plain twin on the card, exactly, in
    ``host`` and ``diff8`` mode, on step 3b's inputs
    (``scan_chop_inputs``). Returns the rows, each with its times and
    bound."""
    rows = []
    for label, cfg, cov, lens_d in scan_chop_inputs(torch, np, et,
                                                    pileup_cuda, params):
        for mode in ("host", "diff8"):
            c = dataclasses.replace(cfg, cov_out=mode)
            rows.append(dict(B=cfg.B, W=cfg.W, label=label, **hold_scan_chop(
                torch, np, c, cov, lens_d, f"scan_chop case {label}")))
    return rows


def profile_step(torch, et, pipeline, params, reads, paf, n_buckets):
    """One 32k ``compute_torch`` pass (``host`` mode, its one coverage
    path) under torch.profiler, the active step of a schedule whose warm-up step is
    the same pass (events at a session's start are not reliable): the
    card must run only the two kernels, once per bucket each, and copies
    (memcpy, memset). Prints each device name's count and microseconds."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from raft_tpu_torch.ops import gather_cuda, pileup_cuda, scan_chop_cuda
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    on_card = {}

    def ready(prof):
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = on_card.get(e.name, (0, 0.0))
                on_card[e.name] = n + 1, us + e.time_range.elapsed_us()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            et.compute_torch(store, table, params, device="cuda")
            torch.cuda.synchronize()
            prof.step()
    kinds = {"pileup": pileup_cuda.KERNEL_NAMES,
             "scan_chop": scan_chop_cuda.KERNEL_NAMES,
             "gather": gather_cuda.KERNEL_NAMES}
    count = {k: sum(n for name, (n, _) in on_card.items()
                    if any(kn in name for kn in names))
             for k, names in kinds.items()}
    # the schedule's step annotation spans the pass on the device timeline
    span_us = sum(us for name, (_, us) in on_card.items()
                  if name.startswith("ProfilerStep"))
    work = {name: v for name, v in on_card.items()
            if not name.startswith("ProfilerStep")}
    other = [name for name in work
             if not any(kn in name for names in kinds.values()
                        for kn in names)
             and not name.lower().startswith(("memcpy", "memset"))]
    for name, (n, us) in sorted(work.items()):
        print(f"profiled 32k step (host mode): {n:4d} x {name[:90]} "
              f"{us:.1f} us")
    check(not other and count["pileup"] == count["scan_chop"] == n_buckets
          and count["gather"] == 1,
          f"profiled 32k step: kernels {count}, other device work {other} "
          f"for {n_buckets} buckets")
    busy = sum(us for _, us in work.values())
    print(f"profiled 32k step: only pileup and scan_chop ({n_buckets} "
          f"each), one gather and copies on the card; device busy "
          f"{busy:.1f} us of the "
          f"pass's {span_us:.1f} us (idle "
          f"{1 - busy / span_us if span_us else float('nan'):.1%})")


def main_path_buckets(torch, et, pipeline, params, reads, paf):
    """Every bucket's device inputs of the dataset, as ``compute_torch``
    hands them to the device: (cfg, lens, ev_off, ev_pk) on cuda:0."""
    out = []
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    et.compute_torch(store, table, params, device="cuda",
                     on_bucket=lambda cfg, lens, off, pk: out.append(
                         (cfg, lens.clone(), off.clone(), pk.clone())))
    return out


def load_base(root):
    """The kernel wrappers of another tree, under their own module names,
    so that they build and load that tree's kernel library from that tree:
    where the tree has a library loader of its own (``ops/_lib.py``), the
    wrappers are loaded with that one in place of this tree's. Returns
    (the pileup wrapper, the ``scan_chop`` wrapper or None where the tree
    has none, the function that builds its library)."""
    import raft_tpu_torch.ops as ops
    ops_dir = os.path.join(root, "raft_tpu_torch", "ops")

    def load(name, fname):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ops_dir, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    if not os.path.exists(os.path.join(ops_dir, "_lib.py")):
        mod = load("base_pileup_cuda", "pileup_cuda.py")
        return mod, None, mod.build_kernels
    lib = load("base_kernel_lib", "_lib.py")
    ours = ops._lib
    ops._lib = lib  # what the wrappers' `from raft_tpu_torch.ops import
    try:            # _lib` binds
        mod = load("base_pileup_cuda", "pileup_cuda.py")
        sc = (load("base_scan_chop_cuda", "scan_chop_cuda.py")
              if os.path.exists(os.path.join(ops_dir, "scan_chop_cuda.py"))
              else None)
    finally:
        ops._lib = ours
    return mod, sc, lib.build_kernels


def ab_phase(torch, np, et, pileup_cuda, pipeline, params, base, base_sc,
             work, gen_dataset):
    """``--ab``: the base tree's kernels against this tree's, in turns
    (base, this, this, base), each exact against the plain twin: the
    pileup on the synthetic shapes and the 32k main path's buckets;
    ``scan_chop`` (where the base tree has it) on step 3b's inputs in
    ``host`` and ``diff8`` mode and on the 32k buckets' coverage in
    ``host`` mode (the main path's)."""
    from raft_tpu_torch.ops import scan_chop_cuda
    rng = np.random.default_rng(7)
    cases = []
    for B, W, per_row, wire in KERNEL_CASES:
        cfg, ev_off, pk = make_case(np, et, params, B, W, per_row, wire, rng)
        cases.append(("synthetic", cfg, torch.from_numpy(ev_off).cuda(),
                      torch.from_numpy(np.ascontiguousarray(pk)).cuda()))
    reads, paf = gen_dataset(os.path.join(work, "bench"), n_reads=N_READS,
                             n_overlaps=N_READS * 30, est_cov=20, seed=7)
    buckets = main_path_buckets(torch, et, pipeline, params, reads, paf)
    cases += [("32k bucket", cfg, off, pk) for cfg, _, off, pk in buckets]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    print(f"launch floor (one 4-byte fill kernel, the same timing): "
          f"{device_ms(torch, one.zero_):.4f} ms")
    tot = {"base": 0.0, "this": 0.0, "bound": 0.0}
    for label, cfg, off, pk in cases:
        want = pileup_cuda.pileup_torch(off, pk, cfg)
        for name, mod in (("base", base), ("this", pileup_cuda)):
            check(torch.equal(mod.pileup(off, pk, cfg), want),
                  f"--ab {name}: kernel != plain at B={cfg.B} W={cfg.W}")
        t = [device_ms(torch, lambda m=m: m.pileup(off, pk, cfg))
             for m in (base, pileup_cuda, pileup_cuda, base)]
        bms, by = bound(cfg, off)
        plan = pileup_cuda.launch_plan(cfg.B, cfg.W, sms)
        print(f"ab {label} B={cfg.B} W={cfg.W} E={cfg.E} "
              f"{'pairs' if cfg.ev_pack == 0 else 'pack32'} "
              f"{plan_text(plan)}: base {t[0]:.4f} / {t[3]:.4f} ms, this "
              f"{t[1]:.4f} / {t[2]:.4f} ms, bound {bms:.5f} ms ({by}), "
              f"share base {bms / min(t[0], t[3]):.1%} this "
              f"{bms / min(t[1], t[2]):.1%}")
        if label == "32k bucket":
            tot["base"] += statistics.median([t[0], t[3]])
            tot["this"] += statistics.median([t[1], t[2]])
            tot["bound"] += bms
    print(f"ab the 32k main path's {len(buckets)} buckets, summed medians: "
          f"base {tot['base']:.4f} ms, this {tot['this']:.4f} ms, bound "
          f"{tot['bound']:.4f} ms, share base "
          f"{tot['bound'] / tot['base']:.1%} this "
          f"{tot['bound'] / tot['this']:.1%}")
    if base_sc is None:
        print("ab scan_chop: the base tree has no scan_chop kernel")
        return

    def turns(label, cfg, cov, lens_d):
        """Both trees' scan_chop exact against the twin, then timed in
        turns; returns (base median, this median, bound)."""
        want = scan_chop_cuda.scan_chop_torch(cov, lens_d, cfg)
        for name, mod in (("base", base_sc), ("this", scan_chop_cuda)):
            got = mod.scan_chop(cov, lens_d, cfg)
            check(set(got) == set(want)
                  and all(torch.equal(got[k], want[k]) for k in want),
                  f"--ab {name}: scan_chop != plain, {label} B={cfg.B} "
                  f"W={cfg.W} {cfg.cov_out}")
        t = [device_ms(torch, lambda m=m: m.scan_chop(cov, lens_d, cfg))
             for m in (base_sc, scan_chop_cuda, scan_chop_cuda, base_sc)]
        bms, by = scan_chop_bound(np, cfg, want["packed"].cpu().numpy())
        plan = scan_chop_cuda.launch_plan(cfg.B, cfg.W, cfg.M, cfg.K, cfg.F,
                                          sms)
        b, h = statistics.median([t[0], t[3]]), statistics.median(t[1:3])
        print(f"ab scan_chop {label} B={cfg.B} W={cfg.W} M={cfg.M} "
              f"K={cfg.K} {cfg.cov_out} regime {plan.regime} cluster "
              f"{plan.cluster} block {plan.block}: base {t[0]:.4f} / "
              f"{t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms, bound "
              f"{bms:.5f} ms ({by}), share base {bms / b:.1%} this "
              f"{bms / h:.1%}, {b / h:.1f}x")
        return b, h, bms

    for label, cfg, cov, lens_d in scan_chop_inputs(torch, np, et,
                                                    pileup_cuda, params):
        for mode in ("host", "diff8"):
            turns(label, dataclasses.replace(cfg, cov_out=mode), cov,
                  lens_d)
    tot = [0.0, 0.0, 0.0]
    for cfg, lens, off, pk in buckets:
        c = dataclasses.replace(cfg, cov_out="host")
        for i, v in enumerate(turns("32k bucket", c,
                                    pileup_cuda.pileup(off, pk, c), lens)):
            tot[i] += v
    print(f"ab scan_chop over the 32k main path's {len(buckets)} buckets, "
          f"summed medians: base {tot[0]:.4f} ms, this {tot[1]:.4f} ms, "
          f"bound {tot[2]:.4f} ms, share base {tot[2] / tot[0]:.1%} this "
          f"{tot[2] / tot[1]:.1%}, {tot[0] / tot[1]:.1f}x")


def real_bucket_phase(torch, et, pileup_cuda, pipeline, params, reads, paf):
    """Both kernels against plain on every bucket of the dataset, as
    ``compute_torch`` hands it to the device; one row per bucket."""
    return [hold(torch, pileup_cuda, cfg, off, pk, "bucket", lens_d=lens)
            for cfg, lens, off, pk in main_path_buckets(torch, et, pipeline,
                                                        params, reads, paf)]


def gather_bound_bytes(plan, grouped) -> int:
    """The least bytes the gather moves for ``plan``: every step's rows'
    read ids (8 B), offsets (16 B) and lengths (4 B), and their events'
    two window columns (8 B each) read once; the arena's arrays written
    once."""
    off = grouped[0]
    n = sum(len(st.read_ids) for st in plan.steps)
    ev = sum(int((off[st.read_ids + 1] - off[st.read_ids]).sum())
             for st in plan.steps)
    return 28 * n + 8 * ev + sum(plan.out_bytes(i)
                                 for i in range(len(plan.steps)))


def wide_table(np, reso: int, seed: int = 7, n: int = 768):
    """A read-grouped table of reads of 20 kb to 1.6 Mbp (the UL cell's
    longest reach 0.9 Mbp), windows inside their reads as a strict pass
    bins them: buckets of up to 32,768 windows, the widest with int32
    event columns."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(2e4), np.log(1.6e6), n)).astype(
        np.int32)
    counts = rng.integers(0, 400, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    nw = np.repeat(-(-lens.astype(np.int64) // reso), counts)
    w0 = (rng.random(int(off[-1])) * nw).astype(np.int64)
    w1 = np.minimum(w0 + rng.integers(0, 400, len(w0)), nw - 1)
    return lens, (off, w0.astype(np.int32), w1.astype(np.int32))


def hold_gather(torch, np, et, params, lens, grouped, label):
    """The gather on one table, planned as the engine plans it
    (``plan_steps``): the kernel equals its plain twin and ``host_inputs``
    of every ``iter_buckets`` bucket, exactly, in both wire formats.
    Returns the pack32 plan, the table and the plan's metadata on the
    card, and the largest |kernel - twin| over both formats."""
    from raft_tpu_torch import bucketing
    from raft_tpu_torch.ops import gather_cuda
    bks = list(bucketing.iter_buckets(lens, None, None, None, params.reso,
                                      presorted=True, prebinned=grouped))
    tab, _ = gather_cuda.upload_table(*grouped, lens, "cuda")
    err = 0
    for wire in ("pairs", "pack32"):
        planned = list(et.plan_steps(lens, np.diff(grouped[0]), params))
        if wire == "pairs":
            planned = [(sh, dataclasses.replace(cfg, ev_pack=0),
                        [st._replace(pairs=True) for st in steps])
                       for sh, cfg, steps in planned]
        plan = gather_cuda.GatherPlan([st for _, _, steps in planned
                                       for st in steps])
        got = gather_cuda.gather(tab, plan)
        meta = torch.from_numpy(plan.meta).cuda()
        want = gather_cuda.gather_torch(tab, meta, plan)
        torch.cuda.synchronize()
        check(len(bks) == len(plan.steps),
              f"gather {wire}, {label}: {len(plan.steps)} steps, "
              f"{len(bks)} buckets")
        for i, (bk, (_, cfg, _)) in enumerate(zip(bks, planned)):
            host = et.host_inputs(bk, cfg)
            for g, w, h in zip(gather_cuda.views(got, plan, i),
                               gather_cuda.views(want, plan, i), host):
                if g.numel():
                    err = max(err, int((g.long() - w.long()).abs().max()))
                check(torch.equal(g, w) and np.array_equal(
                    g.cpu().numpy(), h),
                      f"gather {wire}, {label}: step {i} (B={cfg.B} "
                      f"W={cfg.W}) differs from the plain twin or "
                      "host_inputs")
    return plan, tab, meta, err


def gather_phase(torch, np, et, pipeline, params, reads, paf):
    """The gather held exactly against its plain twin and ``host_inputs``
    (``hold_gather``) on the dataset's table and on a table of megabase
    reads (``wide_table``), whose widest steps have int32 event columns;
    pack32 on the dataset timed, kernel and twin, against its bytes over
    3.35 TB/s. Returns the kernel table's row."""
    from raft_tpu_torch.ops import gather_cuda
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    lens = store.lens.astype(np.int32)
    grouped = table.events_grouped(store.n_reads, lens, params.reso)
    plan, tab, meta, err = hold_gather(torch, np, et, params, lens, grouped,
                                       "32k table")
    check(all(st.trunc16 for st in plan.steps),
          "gather, 32k table: a step without int16 columns")
    wplan, _, _, werr = hold_gather(torch, np, et, params,
                                    *wide_table(np, params.reso),
                                    "wide table")
    wide = [st.W for st in wplan.steps if not st.trunc16]
    check(len(wide) > 0, "gather, wide table: no step with int32 columns")
    ms = device_ms(torch, lambda: gather_cuda.gather(tab, plan))
    plain = device_ms(torch, lambda: gather_cuda.gather_torch(
        tab, meta, plan), launches=3, rounds=3)
    bms = gather_bound_bytes(plan, grouped) / 3.35e12 * 1e3
    print(f"gather over the {len(plan.steps)} buckets of the main path "
          f"({len(grouped[1])} events, {plan.n_blocks} blocks): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms, share "
          f"{bms / ms:.1%}; exact against the twin and host_inputs, pack32 "
          f"and pairs, there and on the wide table ({len(wplan.steps)} "
          f"steps, {len(wide)} with int32 columns at W {sorted(set(wide))}"
          f"); max |kernel - twin| {max(err, werr)}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms,
                max_abs_err=max(err, werr))


def run_cli(cli, args, label):
    t0 = time.perf_counter()
    rc = cli.main(args)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{label}: CLI exit code {rc}")
    return wall


def same_outputs(a: str, b: str) -> bool:
    return all(filecmp.cmp(a + ext, b + ext, shallow=False) for ext in OUTS)


def digest(prefix: str) -> dict:
    """SHA-256 of each of the four outputs, streamed."""
    out = {}
    for ext in OUTS:
        h = hashlib.sha256()
        with open(prefix + ext, "rb") as f:
            for blk in iter(lambda: f.read(1 << 24), b""):
                h.update(blk)
        out[ext] = h.hexdigest()
    return out


def digest_and_remove(prefix: str) -> dict:
    """``digest``; then the files go."""
    out = digest(prefix)
    for ext in OUTS:
        os.remove(prefix + ext)
    return out


def compressed_copy(kind: str, inputs) -> tuple:
    """A gzip (``gzip -5``, one DEFLATE stream) or BGZF (the port's
    block-parallel ``bgzf_compress_file``) copy of each input, beside it
    with ``.gz``/``.bgzf.gz`` appended; prints the seconds it took."""
    from raft_tpu_torch.io import native
    t0 = time.perf_counter()
    out = []
    for src in inputs:
        dst = src + (".gz" if kind == "gz" else ".bgzf.gz")
        if kind == "gz":
            with open(dst, "wb") as f:
                subprocess.run(["gzip", "-c", "-5", src], stdout=f,
                               check=True)
        else:
            check(native.bgzf_compress_file(src, dst),
                  f"BGZF compression of {src} failed")
        out.append(dst)
    print(f"{kind} copies of the inputs: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(os.path.getsize(f) for f in out) / 2**20:.1f} MiB")
    return tuple(out)


def drive(torch, cli, pileup_cuda, opts, inputs, prefix, label, n_reads):
    """One CLI run with ``--device cuda``: its own launch counts (reset
    just before, read just after) and peak device memory. Fails unless
    each kernel launched once per bucket the run reports, and the run's
    ``launches`` are those counts. Returns the run's stats JSON."""
    sj = prefix + ".stats.json"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    wall = run_cli(cli, [*opts, "-o", prefix, "--stats-json", sj,
                         "--device", "cuda", *inputs], label)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    with open(sj) as f:
        st = json.load(f)
    os.remove(sj)
    once_each(counts, len(st["buckets"]), label, computes_of(st))
    check(st["launches"] == counts,
          f"{label}: the run reports launches {st['launches']}, {counts} "
          "counted")
    check(st["n_reads"] == n_reads and st["native_io"],
          f"{label}: {st['n_reads']} reads, native I/O {st['native_io']}")
    print(f"{label}: {st['schedule']} x{st['n_chunks']}, wall {wall:.3f} s, "
          f"{n_reads / wall:.1f} reads/s, {len(st['buckets'])} launches "
          f"of each kernel (= buckets), peak device memory {peak:.1f} MiB, "
          "stages " + json.dumps({k: round(v, 3)
                                  for k, v in st["stage_seconds"].items()}))
    return st


def held_run(torch, cli, pipeline, pileup_cuda, opts, inputs, prefix, label,
             st, times):
    """Untimed rerun of a path that ``drive`` timed, through
    ``run_pipeline`` with the same flags (``--devices N`` too): every
    bucket's device inputs, in every chunk and on every card, are held
    against the plain twin, exactly, as the engine hands them to the
    kernel. Fails unless those buckets are the
    timed run's, in order. Returns the rows and the outputs' SHA-256."""
    from raft_tpu_torch.parallel import make_devices
    params, _, _, extras = cli.parse_args([*opts, "-o", prefix, *inputs])
    rows = []
    pipeline.run_pipeline(
        *inputs, params, verbose=False, device="cuda",
        chunk_reads=extras["chunk_reads"], spill_paf=extras["spill_paf"],
        cov_out=extras["cov_out"],
        devices=(make_devices(extras["devices"], "cuda")
                 if extras["devices"] else None),
        on_bucket=lambda cfg, lens, off, pk: rows.append(
            hold(torch, pileup_cuda, cfg, off, pk, label, times, lens)))
    check([[r["B"], r["W"], r["E"]] for r in rows] == st["buckets"],
          f"{label}: the buckets held against plain are not the timed "
          "run's")
    shapes = sorted({(r["B"], r["W"]) for r in rows})
    print(f"{label}: kernel == plain on all {len(rows)} buckets, "
          f"(B, W) {shapes}")
    return rows, digest_and_remove(prefix)


def sharded_phase(torch, cli, pipeline, pileup_cuda, inputs, prefix, want,
                  times):
    """Step 6b: four shards on one card, whole-file and chunked, each
    timed in turns with the unsharded run, then rerun untimed with every
    shard held against the plain twin. Returns (launches by path, held
    rows)."""
    four = [torch.device("cuda", 0)] * N_SHARDS
    by_path, rows = {}, []
    for sched, chunk in (("whole-file", 0),
                         (f"--chunk-reads {SHARD_CHUNK}", SHARD_CHUNK)):
        params = cli.parse_args([*BENCH_ARGS, "-o", prefix, *inputs])[0]
        walls = {"unsharded": [], "sharded": []}
        for devs in (None, four, four, None):
            kind = "sharded" if devs else "unsharded"
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            st = pipeline.run_pipeline(*inputs, params, verbose=False,
                                       device="cuda", chunk_reads=chunk,
                                       devices=devs)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            counts = launch_counts()
            once_each(counts, len(st.buckets), f"{kind} {sched}",
                      st.n_chunks)
            check(digest_and_remove(prefix) == want,
                  f"{kind} {sched}: outputs differ from the unsharded "
                  "--device cuda run's")
            if devs:
                shards = st.buckets
                check(st.devices == ["cuda:0"] * N_SHARDS
                      and len(shards) % N_SHARDS == 0,
                      f"sharded {sched}: devices {st.devices}, "
                      f"{len(shards)} shards")
                by_path[f"32k {N_SHARDS} shards on cuda:0, {sched}"] = counts
            else:
                n_buckets = len(st.buckets)
        check(len(shards) == N_SHARDS * n_buckets,
              f"{sched}: {len(shards)} shards for {n_buckets} buckets")
        label = f"32k {N_SHARDS} shards {sched}, held"
        held = []
        pipeline.run_pipeline(
            *inputs, params, verbose=False, device="cuda", chunk_reads=chunk,
            devices=four, on_bucket=lambda cfg, lens, off, pk: held.append(
                hold(torch, pileup_cuda, cfg, off, pk, label, times, lens)))
        check([[r["B"], r["W"], r["E"]] for r in held]
              == [list(b) for b in shards],
              f"{label}: the shards held against plain are not the timed "
              "run's")
        check(digest_and_remove(prefix) == want,
              f"{label}: outputs differ from the unsharded run's")
        rows += held
        print(f"32k {sched}: {n_buckets} buckets, {len(shards)} shards on "
              f"cuda:0; kernel == plain on every shard; walls (s) unsharded "
              + " / ".join(f"{w:.3f}" for w in walls["unsharded"])
              + ", sharded " + " / ".join(f"{w:.3f}" for w in
                                          walls["sharded"])
              + "; outputs == unsharded (4 files)")
    return by_path, rows


# One rank of step 6c (and of --multi-card) as one JSON line: its wall,
# each kernel's launch count, the jax and raft_tpu modules it
# imported (none may be), and a row per pileup call of the engine: that
# call's (B, W, E), held against the plain twin on the same device
# inputs, and ``scan_chop`` held against its twin on the kernel's
# coverage. The launch counts rise only in the real wrappers.
RANK_CODE = """\
import json, sys, time
import torch
from raft_tpu_torch import engine_torch
from raft_tpu_torch.cli import parse_args
from raft_tpu_torch.ops import _lib, pileup_cuda, scan_chop_cuda
from raft_tpu_torch.parallel import run_distributed
held = []
def err(got, want):
    return int((got.long() - want.long()).abs().max().item())
def held_pileup(ev_off, ev_pk, cfg):
    got = pileup_cuda.pileup(ev_off, ev_pk, cfg)
    want = pileup_cuda.pileup_torch(ev_off, ev_pk, cfg)
    held.append(dict(B=cfg.B, W=cfg.W, E=cfg.E, equal=torch.equal(got, want),
                     max_abs_err=err(got, want)))
    return got
def held_scan_chop(cov, lens, cfg):
    got = scan_chop_cuda.scan_chop(cov, lens, cfg)
    want = scan_chop_cuda.scan_chop_torch(cov, lens, cfg)
    held[-1].update(
        sc_equal=set(got) == set(want)
        and all(torch.equal(got[k], want[k]) for k in want),
        sc_max_abs_err=max(err(got[k], want[k]) for k in want))
    return got
engine_torch.pileup = held_pileup
engine_torch.scan_chop = held_scan_chop
params = parse_args({args!r})[0]
_lib.zero_launches()
t0 = time.perf_counter()
run_distributed({reads!r}, {paf!r}, params, coordinator={coord!r},
                num_processes={n}, process_id={rank}, device={device!r})
if {device!r} == "cuda":
    torch.cuda.synchronize()
print(json.dumps({{"rank": {rank}, "device": {device!r},
                  "wall": time.perf_counter() - t0,
                  "launches": _lib.launch_counts(), "held": held,
                  "foreign": sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "raft_tpu"))}}))
"""


def multi_process_phase(inputs, prefix, want, devs, visible=None):
    """``run_distributed`` in ``len(devs)`` processes over gloo on
    127.0.0.1, rank r on ``devs[r]`` (``cuda`` or ``cpu``), with
    ``CUDA_VISIBLE_DEVICES`` set to ``visible[r]`` when given. Every
    device step of every rank holds both kernels against their plain
    twins, exactly, and a rank on the card must have launched each kernel
    once per step.
    Rank 0's concatenated shards must equal the single run. Returns (the
    launches by path, the held rows)."""
    import socket
    n = len(devs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    args = [*BENCH_ARGS, "-o", prefix, *inputs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE.format(
            args=args, reads=inputs[0], paf=inputs[1], coord=coord, n=n,
            rank=rank, device=dev)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env if visible is None
        else {**env, "CUDA_VISIBLE_DEVICES": visible[rank]})
        for rank, dev in enumerate(devs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    by_path, rows = {}, []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        where = r_dev = devs[rank]
        if visible is not None:
            where = f"{r_dev} (CUDA_VISIBLE_DEVICES={visible[rank]})"
        label = f"{n}-process rank {rank} on {where}"
        check(p.returncode == 0, f"{label}: exit {p.returncode}\n"
              f"{err[-3000:]}")
        r = json.loads(out.splitlines()[-1])
        check(not r["foreign"], f"{label} imported {r['foreign']}")
        held = r["held"]
        steps = len(held) if r_dev == "cuda" else 0
        check(len(held) > 0 and r["launches"] == {
            "pileup": steps, "scan_chop": steps,
            "gather": int(r_dev == "cuda")},
              f"{label}: launches {r['launches']} for {len(held)} device "
              "steps and one compute")
        bad = [h for h in held if not (h["equal"] and h.get("sc_equal"))
               or h["max_abs_err"] or h["sc_max_abs_err"]]
        check(not bad, f"{label}: kernel != plain on {bad}")
        by_path[f"32k {label}"] = r["launches"]
        rows += held
        shapes = sorted({(h["B"], h["W"]) for h in held})
        print(f"{label}: wall {r['wall']:.3f} s in run_distributed, "
              f"{r['launches']['pileup']} launches of each kernel, each "
              "held == "
              f"plain, (B, W) {shapes}")
    check(digest_and_remove(prefix) == want,
          f"{n}-process: concatenated shards differ from the single run's")
    print(f"{n}-process: {wall:.3f} s for all processes, start-up "
          "included; concatenated shards == single run (4 files)")
    return by_path, rows


def multi_card(torch, cli, pipeline, pileup_cuda, gen_dataset, work):
    """``--multi-card``: the 32k dataset sharded over every card, through
    the CLI (``--devices N``, whole-file and chunked, timed in turns with
    the unsharded run on cuda:0, then held shard by shard against the
    plain twin on each card), and ``run_distributed`` with one card per
    rank. Returns (launches by path, held rows of the whole-file run,
    its path label, every held row)."""
    n = torch.cuda.device_count()
    check(n >= 2, f"--multi-card needs two or more cards, found {n}")
    reads, paf = gen_dataset(os.path.join(work, "bench"), n_reads=N_READS,
                             n_overlaps=N_READS * 30, est_cov=20, seed=7)
    inputs = (reads, paf)
    prefix = os.path.join(work, "out")
    drive(torch, cli, pileup_cuda, BENCH_ARGS, inputs, prefix,
          "32k unsharded on cuda:0, warm-up", N_READS)
    want = digest_and_remove(prefix)
    by_path, rows, all_rows, times = {}, [], [], {}
    cards = [f"cuda:{i}" for i in range(n)]
    for extra in ([], ["--chunk-reads", str(SHARD_CHUNK)]):
        sharded = ["--devices", str(n), *extra]
        for opts in (extra, sharded, sharded, extra):
            label = "32k " + (" ".join(opts) or "unsharded on cuda:0")
            st = drive(torch, cli, pileup_cuda, BENCH_ARGS + opts, inputs,
                       prefix, label, N_READS)
            check(digest_and_remove(prefix) == want,
                  f"{label}: outputs differ from the unsharded run's")
            if opts is sharded:
                check(st["devices"] == cards
                      and len(st["buckets"]) % n == 0,
                      f"{label}: devices {st['devices']}, "
                      f"{len(st['buckets'])} shards")
                by_path[label] = st["launches"]
                sharded_label, sharded_st = label, st
        held, dig = held_run(torch, cli, pipeline, pileup_cuda,
                             BENCH_ARGS + sharded, inputs, prefix,
                             sharded_label + ", held", sharded_st, times)
        check(dig == want, f"{sharded_label}, held: outputs differ")
        rows = rows or held
        all_rows += held
    rank_paths, rank_rows = multi_process_phase(
        inputs, os.path.join(work, "dist"), want, ["cuda"] * n,
        visible=[str(i) for i in range(n)])
    by_path.update(rank_paths)
    return by_path, rows, f"32k --devices {n}", all_rows + rank_rows


def row_key(row: dict) -> tuple:
    """What matches an evaluation row to its recorded row."""
    return (row.get("genome_size"), row["seed"], row["est_cov_scale"],
            row["auto_e"], json.dumps(row.get("noise"), sort_keys=True))


def recorded_rows() -> dict:
    """The recorded evaluation rows (``EVAL_RECORDS``), by ``row_key``."""
    root = os.path.dirname(os.path.abspath(__file__))
    rows = {}
    for name in EVAL_RECORDS:
        with open(os.path.join(root, name)) as f:
            for line in f:
                r = json.loads(line)
                rows[row_key(r)] = r
    return rows


def instrument_eval(torch, ev, pileup_cuda, after_point):
    """Wraps the module-level names the evaluation tool's entry functions call
    (``write_simulation``, ``run_pipeline``, ``compute_torch``,
    ``_eval_point``). Each point resets the pileup launch count just
    before it and reads it just after, and records its wall, the seconds
    of the simulation just before it (if any), of the product run and of
    ``compute_torch``, the product run's stats and the buckets of the
    ``compute_torch`` pass; ``after_point(rec)`` sees the record while
    the point's outputs are on disk. Returns the list of records, in point
    order; a record's ``row`` is the dict the entry function returns."""
    real = {n: getattr(ev, n) for n in ("write_simulation", "run_pipeline",
                                        "compute_torch", "_eval_point")}
    log, cur = [], {}

    def timed(name):
        def call(*args, **kw):
            if name == "compute_torch":
                kw["on_bucket"] = lambda cfg, *_: cur["buckets"].append(
                    (cfg.B, cfg.W, cfg.E))
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            cur[name] = time.perf_counter() - t0
            if name == "run_pipeline":
                cur["stats"] = out
            return out
        return call

    def point(workdir, prefix, info, genome_size, engine, est_cov_scale,
              loaded=None, auto_e=False, device="cuda"):
        sim_s = cur.get("write_simulation")
        cur.clear()
        cur["buckets"] = []
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        row = real["_eval_point"](workdir, prefix, info, genome_size,
                                  engine, est_cov_scale, loaded=loaded,
                                  auto_e=auto_e, device=device)
        torch.cuda.synchronize()
        rec = dict(row=row, workdir=workdir, prefix=prefix, info=info,
                   genome_size=genome_size, device=device,
                   wall=time.perf_counter() - t0,
                   launches=launch_counts(), sim_s=sim_s,
                   run_s=cur["run_pipeline"],
                   compute_s=cur["compute_torch"], stats=cur["stats"],
                   compute_buckets=cur["buckets"])
        log.append(rec)
        after_point(rec)
        return row

    for name in real:
        setattr(ev, name, point if name == "_eval_point" else timed(name))
    return log


def point_label(rec: dict) -> str:
    row = rec["row"]
    noise = {k: v for k, v in (row.get("noise") or {}).items() if v}
    return (f"eval {rec['genome_size'] / 1e6:g} Mbp seed {row['seed']} "
            + ("--auto-e" if row["auto_e"]
               else f"-e x{row['est_cov_scale']:g}")
            + "".join(f" {k} {v:g}" for k, v in noise.items())
            + ("" if rec["device"] == "cuda" else " --device cpu"))


def check_point(rec: dict, want_row: dict | None) -> str:
    """One point of step 9: its row equals its record field for field (in
    order), and the kernel launched once per bucket of the product run
    and of the ``compute_torch`` pass (none on the CPU); whole-file, both
    passes saw the same buckets. Prints the point; returns its label."""
    label = point_label(rec)
    row, st = rec["row"], rec["stats"]
    if want_row is not None:
        check(list(row.items()) == list(want_row.items()),
              f"{label}: the row differs from its record\n  got  "
              f"{json.dumps(row)}\n  want {json.dumps(want_row)}")
    run_b, cmp_b = [tuple(b) for b in st.buckets], rec["compute_buckets"]
    on_card = rec["device"] == "cuda"
    n = len(run_b) + len(cmp_b) if on_card else 0
    computes = st.n_chunks + 1 if on_card else 0
    check(rec["launches"] == {"pileup": n, "scan_chop": n,
                              "gather": computes}
          and (n > 0 or not on_card),
          f"{label}: launches {rec['launches']} for {len(run_b)} + "
          f"{len(cmp_b)} buckets and {computes} computes")
    check(st.schedule != "whole" or run_b == cmp_b,
          f"{label}: the product run's buckets are not compute_torch's")
    sim = "" if rec["sim_s"] is None else f"simulation {rec['sim_s']:.3f} s, "
    print(f"{label}: wall {rec['wall']:.3f} s ({sim}product run "
          f"{rec['run_s']:.3f} s {st.schedule} x{st.n_chunks}, "
          f"compute_torch {rec['compute_s']:.3f} s), {n} "
          f"launches of each kernel ({'=' if on_card else 'on the CPU:'} "
          f"{len(run_b)} + {len(cmp_b)} buckets)"
          + (", row == record" if want_row is not None else ""))
    return label


def header_tiling(np, ev, reads_fasta: str, sub_len: int):
    """The position-blind tiling of ``tests/test_eval_quality.py``:
    non-overlapping ``sub_len``-bp tiles of every read, in genome
    coordinates from the simulated headers."""
    iv = []
    for a, b, fwd in zip(*(x.tolist()
                           for x in ev.fragment_positions(reads_fasta))):
        cuts = list(range(0, b - a, sub_len)) + [b - a]
        for lo, hi in zip(cuts, cuts[1:]):
            iv.append((a + lo, a + hi) if fwd else (b - hi, b - lo))
    return np.asarray(iv, dtype=np.int64)


def asm_proxy_rows(np, ev, asm_proxy, rec: dict, sub_len: int):
    """RAFT's (NG50, contigs, ambiguous breaks) under ``asm_proxy`` from
    the point's fragments, and the header tiling's."""
    bed = rec["prefix"] + ".truth_repeats.bed"
    raft = asm_proxy.evaluate(os.path.join(rec["workdir"], "out.reads.fasta"),
                              bed)
    tiles = header_tiling(np, ev, rec["prefix"] + ".reads.fasta", sub_len)
    contigs, amb, _ = asm_proxy.assemble(
        tiles, ev.merge_intervals(asm_proxy.read_bed(bed)), 500)
    span = int(tiles[:, 1].max() - tiles[:, 0].min())
    return ((raft["ng50"], raft["n_contigs"],
             raft["ambiguous_junction_breaks"]),
            (asm_proxy.ng50(contigs, span), len(contigs), amb))


def held_point_run(torch, pipeline, pileup_cuda, rec, label, times,
                   want_buckets, want_digest, chunk_reads=None):
    """A rerun of an evaluation point's product run on the card, every
    bucket held against the plain twin (``hold``) as the engine hands it
    to the kernel. Only the engine's launches count: ``hold``'s own, to
    compare and time, are taken back off the count. Fails unless the
    buckets are ``want_buckets`` and the four outputs' SHA-256 are
    ``want_digest``. Returns (the rows, the launches, the run's stats)."""
    from raft_tpu_torch import AlgoParams
    from raft_tpu_torch.ops import _lib
    rows = []

    def on_bucket(cfg, lens, off, pk):
        n = launch_counts()
        rows.append(hold(torch, pileup_cuda, cfg, off, pk, label, times,
                         lens))
        _lib.launches.update(n)

    params = AlgoParams(est_cov=rec["row"]["est_cov_used"],
                        outputfilename=os.path.join(rec["workdir"], "held"))
    torch.cuda.synchronize()
    zero_launches()
    st = pipeline.run_pipeline(
        rec["prefix"] + ".reads.fasta", rec["prefix"] + ".overlaps.paf",
        params, verbose=False, device="cuda", chunk_reads=chunk_reads,
        on_bucket=on_bucket)
    torch.cuda.synchronize()
    counts = launch_counts()
    check([(r["B"], r["W"], r["E"]) for r in rows]
          == [tuple(b) for b in st.buckets]
          == [tuple(b) for b in want_buckets],
          f"{label}: {len(rows)} buckets held, {len(want_buckets)} wanted, "
          "or not the same buckets")
    once_each(counts, len(rows), label, st.n_chunks)
    check(digest_and_remove(params.outputfilename) == want_digest,
          f"{label}: outputs differ from the point's")
    print(f"{label}: {st.schedule} x{st.n_chunks}, both kernels == plain "
          f"on all {len(rows)} buckets, {len(rows)} launches of each (= "
          "buckets); outputs == the point's (4 files, SHA-256)")
    return rows, counts, st


def eval_phase(torch, np, pipeline, pileup_cuda, work, times):
    """Step 9: the ground-truth evaluation on the card. Returns (launches
    by path, the held rows)."""
    from raft_tpu_torch import AlgoParams
    from raft_tpu_torch.tools import asm_proxy
    from raft_tpu_torch.tools import eval_repeats as ev

    t_phase = time.perf_counter()
    records = recorded_rows()
    matched = set()
    sub_len = AlgoParams().read_length
    by_path, held = {}, []

    def after_point(rec):
        # the 1x points of the sweeps: asm_proxy and the outputs' digest
        # while this point's outputs are on disk
        if (rec["row"]["est_cov_scale"] == 1.0 and not rec["row"]["auto_e"]
                and os.path.basename(rec["workdir"]).startswith("seed")
                and rec["device"] == "cuda"):
            rec["proxy"] = asm_proxy_rows(np, ev, asm_proxy, rec, sub_len)
            rec["digest"] = digest(os.path.join(rec["workdir"], "out"))

    log = instrument_eval(torch, ev, pileup_cuda, after_point)

    def score(path, n0):
        recs = log[n0:]
        for rec in recs:
            key = row_key(rec["row"])
            check(key in records and key not in matched,
                  f"{point_label(rec)}: no record, or matched twice")
            matched.add(key)
            check_point(rec, records[key])
        by_path[path] = {k: sum(r["launches"][k] for r in recs)
                         for k in recs[0]["launches"]}
        return recs

    # a. the recorded rows: both sweeps, then the noisy --auto-e points
    sweep = {}
    for g in EVAL_SIZES:
        wd = os.path.join(work, f"eval{g // 10 ** 6}")
        n0 = len(log)
        ev.run_sweep(wd, g, 30.0, seeds=EVAL_SEEDS, verbose=False,
                     device="cuda")
        for rec in score(f"eval {g / 1e6:g} Mbp sweep, seeds 11 and 23",
                         n0):
            if "proxy" in rec:
                sweep[(g, rec["row"]["seed"])] = rec
        # d. the contiguity proxy of the 1x points
        for s in EVAL_SEEDS:
            got, want = sweep[(g, s)]["proxy"], ASM_PROXY_TABLE[(g, s)]
            print(f"asm_proxy {g / 1e6:g} Mbp seed {s}: RAFT NG50 {got[0][0]}"
                  f", {got[0][1]} contigs, {got[0][2]} ambiguous breaks; "
                  f"tiling NG50 {got[1][0]}, {got[1][1]} contigs, "
                  f"{got[1][2]} breaks (EVAL.md: {want})")
            check(got == want, f"asm_proxy {g} seed {s}: {got} != {want}")
        if g == EVAL_HELD[0]:
            # c. every bucket of the 1x point held; the outputs equal
            rec = sweep[EVAL_HELD]
            label = f"{point_label(rec)}, held"
            rows, _, _ = held_point_run(torch, pipeline, pileup_cuda, rec,
                                        label, times, rec["stats"].buckets,
                                        rec["digest"])
            check(rec["launches"] == {
                "pileup": 2 * len(rows), "scan_chop": 2 * len(rows),
                "gather": rec["stats"].n_chunks + 1},
                  f"{label}: the point launched {rec['launches']} for "
                  f"{len(rows)} buckets held")
            held += rows
            print(f"{label}: the point launched each kernel "
                  f"{2 * len(rows)} times (= 2 x {len(rows)})")
        # the same 1x points on the CPU, for contrast
        rec = sweep[(g, EVAL_SEEDS[0])]
        store = ev.load_reads(rec["prefix"] + ".reads.fasta")
        loaded = (store, ev.load_paf(rec["prefix"] + ".overlaps.paf", store))
        n0 = len(log)
        row = ev._eval_point(wd, rec["prefix"], rec["info"], g, "torch", 1.0,
                             loaded=loaded, device="cpu")
        row.update(seed=EVAL_SEEDS[0], genome_size=g)
        check_point(log[n0], rec["row"])
        print(f"{point_label(rec)}: wall {rec['wall']:.3f} s on the card, "
              f"{log[n0]['wall']:.3f} s with --device cpu; rows equal")
        shutil.rmtree(wd)

    n0 = len(log)
    ev.run_noise_sweep(os.path.join(work, "noise"), 2_000_000, 30.0,
                       seeds=EVAL_SEEDS, verbose=False, device="cuda")
    score("eval 2 Mbp noise sweep, seeds 11 and 23", n0)
    shutil.rmtree(os.path.join(work, "noise"))
    n0 = len(log)
    for s in EVAL_SEEDS:
        row = ev.run_eval(os.path.join(work, f"noisy_auto{s}"), 2_000_000,
                          30.0, seed=s, verbose=False, auto_e=True,
                          device="cuda", **EVAL_NOISY)
        row["seed"] = s
        shutil.rmtree(os.path.join(work, f"noisy_auto{s}"))
    score("eval 2 Mbp noisy --auto-e, seeds 11 and 23", n0)
    check(matched == set(records),
          f"{len(set(records) - matched)} recorded rows were not reproduced")
    print(f"eval: all {len(matched)} recorded rows equal on the card, field "
          "for field")

    # e. a point at genome scale: it streams; whole-file gives the same
    wd = os.path.join(work, "eval_big")
    print(f"eval {EVAL_BIG / 1e6:g} Mbp: "
          f"{shutil.disk_usage(work).free / 1e9:.1f} GB free under {work}")
    n0 = len(log)
    ev.run_eval(wd, EVAL_BIG, 30.0, repeat_fams=EVAL_BIG_FAMS, seed=11,
                verbose=False, device="cuda")
    rec = log[n0]
    row, st = rec["row"], rec["stats"]
    rec["row"]["seed"] = 11
    label = check_point(rec, None) + f", {EVAL_BIG_FAMS} repeat families"
    sizes = [os.path.getsize(rec["prefix"] + e)
             for e in (".reads.fasta", ".overlaps.paf")]
    print(f"{label}: {row['n_reads']} reads, {row['n_paf_rows']} PAF rows, "
          f"{sizes[0]} B FASTA, {sizes[1]} B PAF; row {json.dumps(row)}")
    check(st.schedule == "chunked" and st.n_chunks >= 2,
          f"{label}: {st.schedule} x{st.n_chunks}, not streamed")
    check(row["bed_recall"] >= 0.95
          and row["bed_precision_flank_tolerant"] >= 0.95
          and row["genome_fraction_covered_by_fragments"] >= 0.99
          and row["cut_in_repeat_rate"] <= 0.06
          and row["cut_in_repeat_rate"]
          <= 0.6 * row["naive_cut_in_repeat_rate"]
          and row["n_fragments"] > row["n_reads"],
          f"{label}: under the quality thresholds")
    by_path[label] = rec["launches"]
    want = digest_and_remove(os.path.join(wd, "out"))
    # every bucket held: the product run streamed again, then whole-file,
    # whose buckets are the compute_torch pass's
    held += held_point_run(torch, pipeline, pileup_cuda, rec,
                           f"{label}, held", times, st.buckets, want)[0]
    rows, counts, wst = held_point_run(
        torch, pipeline, pileup_cuda, rec, f"{label}, --chunk-reads 0, held",
        times, rec["compute_buckets"], want, chunk_reads=0)
    check(wst.schedule == "whole", f"{label}, --chunk-reads 0: streamed")
    held += rows
    by_path[f"{label}, --chunk-reads 0"] = counts
    # the same point with --device cpu: the same row and outputs
    n0 = len(log)
    ev._eval_point(wd, rec["prefix"], rec["info"], EVAL_BIG, "torch", 1.0,
                   device="cpu").update(noise=row["noise"], seed=11)
    check_point(log[n0], row)
    check(digest_and_remove(os.path.join(wd, "out")) == want,
          f"{label}, --device cpu: outputs differ from the card's")
    print(f"{label}: wall {rec['wall']:.3f} s on the card, "
          f"{log[n0]['wall']:.3f} s with --device cpu; rows and outputs equal")
    shutil.rmtree(wd)
    print(f"eval: phase wall {time.perf_counter() - t_phase:.1f} s")
    return by_path, held


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (argv in ([], ["--multi-card"])
            or (len(argv) == 2 and argv[0] == "--ab")):
        print("usage: python3 chip_smoke.py [--multi-card | --ab DIR]",
              file=sys.stderr)
        return 2
    import numpy as np

    for k in RAFT_ENV:
        os.environ.pop(k, None)
    from raft_tpu_torch import cli, gen_dataset, pipeline, profiling
    from raft_tpu_torch import engine_torch as et
    from raft_tpu_torch.ops import _lib, gather_cuda, pileup_cuda
    from raft_tpu_torch.ops import scan_chop_cuda

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; device_count {torch.cuda.device_count()}")
    print("nvidia-smi --query-gpu=name,power.limit:")
    print(smi.strip())
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines()[0].strip()
    print(f"nvidia-smi --query-gpu=compute_mode: {compute_mode}")

    # 2. build
    t0 = time.perf_counter()
    so, log = _lib.build_kernels(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so}")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line or "error" in line.lower():
            print(f"  {line.strip()}")

    params = cli.parse_args(BENCH_ARGS + ["reads", "paf"])[0]
    if argv and argv[0] == "--ab":
        base, base_sc, build_base = load_base(argv[1])
        so, log = build_base(force=True)
        print(f"base build -> {so}")
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line or "error" in line.lower():
                print(f"  {line.strip()}")
        with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
            ab_phase(torch, np, et, pileup_cuda, pipeline, params, base,
                     base_sc, work, gen_dataset)
        return report(torch, name, None, {}, [], [])
    if argv:
        with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
            by_path, rows, label, all_rows = multi_card(
                torch, cli, pipeline, pileup_cuda, gen_dataset, work)
        return report(torch, name, label, by_path, rows, all_rows)

    # 3. kernel vs plain on the card, synthetic buckets
    kcases = kernel_phase(torch, np, et, pileup_cuda, params)
    sc_cases = scan_chop_phase(torch, np, et, pileup_cuda, params)

    os.environ["RAFT_SPANS"] = "1"  # the runs' --stats-json carry spans
    with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
        # 4a. small input: --device cuda against the oracle engine
        small = gen_dataset(os.path.join(work, "small"), n_reads=400,
                            n_overlaps=12000, est_cov=20, seed=7)
        orc, cud = os.path.join(work, "orc"), os.path.join(work, "cud")
        run_cli(cli, BENCH_ARGS + ["-o", orc, "--engine", "oracle",
                                   "--device", "cpu", *small], "oracle")
        run_cli(cli, BENCH_ARGS + ["-o", cud, "--device", "cuda", *small],
                "small cuda")
        check(same_outputs(orc, cud), "cuda outputs differ from the oracle "
              "engine's on the 400-read input")
        print("small input: --device cuda == --engine oracle (4 files)")

        # 4b. the 32k-read main path, cuda then cpu
        t0 = time.perf_counter()
        reads, paf = gen_dataset(os.path.join(work, "bench"),
                                 n_reads=N_READS, n_overlaps=N_READS * 30,
                                 est_cov=20, seed=7)
        print(f"dataset: {N_READS} reads, {N_READS * 30} overlap rows "
              f"(+ repeats), generated in {time.perf_counter() - t0:.1f} s")

        pre = {d: os.path.join(work, d) for d in ("cuda", "cpu")}
        stats = {}
        walls = {}
        for dev in ("cuda", "cpu"):
            sj = pre[dev] + ".stats.json"
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launches()
            walls[dev] = run_cli(cli, BENCH_ARGS + [
                "-o", pre[dev], "--stats-json", sj, "--device", dev,
                reads, paf], f"bench {dev}")
            if dev == "cuda":
                counts = launch_counts()
                peak = torch.cuda.max_memory_allocated()
            with open(sj) as f:
                stats[dev] = json.load(f)
        shapes = [tuple(b) for b in stats["cuda"]["buckets"]]
        print(f"buckets (B, W, E) of the cuda run: {len(shapes)} {shapes}")
        once_each(counts, len(shapes), "32k cuda run", 1)
        check(same_outputs(pre["cuda"], pre["cpu"]),
              "--device cuda and --device cpu outputs differ")
        check(stats["cuda"]["n_reads"] == N_READS
              and stats["cuda"]["n_fragments"] >= N_READS,
              "unexpected read or fragment count")
        for dev in ("cuda", "cpu"):
            st = stats[dev]
            print(f"main path --device {dev}: wall {walls[dev]:.3f} s, "
                  f"{N_READS / walls[dev]:.1f} reads/s, fragments "
                  f"{st['n_fragments']}, native I/O "
                  f"{'yes' if st['native_io'] else 'NO'}, stages "
                  + json.dumps({k: round(v, 3)
                                for k, v in st["stage_seconds"].items()})
                  + ", spans " + json.dumps(
                      {k: round(v, 4)
                       for k, (v, _) in st["span_seconds"].items()}))
        print(f"launches in the cuda run: {counts} (= {len(shapes)} "
              f"buckets each); peak device memory "
              f"{peak / 2**20:.1f} MiB; outputs byte-equal cuda vs cpu")

        # 4c. kernel vs plain on the main path's own buckets
        real = real_bucket_phase(torch, et, pileup_cuda, pipeline, params,
                                 reads, paf)
        check([(r["B"], r["W"], r["E"]) for r in real] == shapes,
              "the buckets held against plain are not the cuda run's")
        kms = sum(r["ms"] for r in real)
        pms = sum(r["plain_ms"] for r in real)
        bms = sum(r["bound_ms"] for r in real)
        print(f"pileup over the {len(real)} buckets of the main path: "
              f"kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} "
              f"ms, share {bms / kms:.1%}, exact on all")
        kms, pms, bms = (sum(r[k] for r in real)
                         for k in ("sc_ms", "sc_plain_ms", "sc_bound_ms"))
        print(f"scan_chop over the {len(real)} buckets of the main path: "
              f"kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} "
              f"ms, share {bms / kms:.1%}, exact on all")
        gather_row = gather_phase(torch, np, et, pipeline, params, reads,
                                  paf)
        by_path = {"32k whole-file": counts}

        # 5. gzip and BGZF copies of the inputs (--cov-out diff8 on the
        # BGZF one): byte-equal to the plain host run
        want = digest_and_remove(pre["cuda"])
        for dev in ("cuda", "cpu"):
            os.remove(pre[dev] + ".stats.json")
        digest_and_remove(pre["cpu"])
        for kind, extra in (("gz", []), ("bgzf", ["--cov-out", "diff8"])):
            packed = compressed_copy(kind, (reads, paf))
            label = " ".join([f"32k {kind}", *extra])
            st = drive(torch, cli, pileup_cuda, BENCH_ARGS + extra, packed,
                       os.path.join(work, kind), label, N_READS)
            check(digest_and_remove(os.path.join(work, kind)) == want,
                  f"{label} outputs differ from the plain host run's")
            by_path[label] = st["launches"]
            for f in packed:
                os.remove(f)
            print(f"{label} == plain host run (4 files)")

        # 6a. --devices 1 through the CLI
        label = "32k --devices 1"
        st = drive(torch, cli, pileup_cuda, BENCH_ARGS + ["--devices", "1"],
                   (reads, paf), os.path.join(work, "dev1"), label, N_READS)
        check(st["devices"] == ["cuda:0"]
              and digest_and_remove(os.path.join(work, "dev1")) == want,
              f"{label}: devices {st['devices']} or outputs differ from "
              "the unsharded run's")
        by_path[label] = st["launches"]
        print(f"{label}: outputs == unsharded (4 files)")
        # 6b. four shards on one card
        shard_paths, shard_rows = sharded_phase(
            torch, cli, pipeline, pileup_cuda, (reads, paf),
            os.path.join(work, "shard"), want, {})
        by_path.update(shard_paths)
        # 6c. two processes on the one card
        devs = ["cuda", "cuda" if compute_mode == "Default" else "cpu"]
        if devs[1] == "cpu":
            print(f"two-process: compute mode {compute_mode!r} admits one "
                  "process per card: rank 1 runs --device cpu")
        rank_paths, rank_rows = multi_process_phase(
            (reads, paf), os.path.join(work, "dist"), want, devs)
        by_path.update(rank_paths)

        # 7. --trace on the small input names both kernels (the first
        # profiler session of this process, as a user's run would be)
        tdir = os.path.join(work, "trace")
        st = drive(torch, cli, pileup_cuda, BENCH_ARGS + ["--trace", tdir],
                   small, os.path.join(work, "tr"), "small --trace", 400)
        by_path["small --trace"] = st["launches"]
        with open(os.path.join(tdir, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        for kern, names in (("pileup", pileup_cuda.KERNEL_NAMES),
                            ("scan_chop", scan_chop_cuda.KERNEL_NAMES),
                            ("gather", gather_cuda.KERNEL_NAMES)):
            kev = [e for e in events
                   if any(k in e.get("name", "") for k in names)]
            check(len(kev) >= st["launches"][kern],
                  f"--trace: {len(kev)} {names} kernel events for "
                  f"{st['launches'][kern]} launches")
            print(f"--trace: {len(events)} events, {len(kev)} name the "
                  f"kernel ({kev[0]['name']}), "
                  f"{sum(e.get('dur', 0) for e in kev):.1f} us in all")
        # --pallas and --no-pallas run the one CUDA pileup, once a bucket
        for flag in ("--pallas", "--no-pallas"):
            pf = os.path.join(work, "pf")
            st = drive(torch, cli, pileup_cuda, BENCH_ARGS + [flag], small,
                       pf, f"small {flag}", 400)
            check(same_outputs(pf, cud), f"{flag}: outputs differ")
            digest_and_remove(pf)
            by_path[f"small {flag}"] = st["launches"]
        print("small --pallas and --no-pallas == small cuda run (4 files)")
        # 7b. one profiled 32k compute_torch pass: the two kernels only
        profile_step(torch, et, pipeline, params, reads, paf, len(shapes))
        for f in (reads, paf):
            os.remove(f)

        # 8. streaming at real size: auto-stream, whole-file, spill
        t0 = time.perf_counter()
        big = gen_dataset(os.path.join(work, "big"), n_reads=N_BIG,
                          n_overlaps=N_BIG_OVERLAPS, est_cov=20, seed=7)
        sizes = [os.path.getsize(f) for f in big]
        print(f"dataset: {N_BIG} reads, {N_BIG_OVERLAPS} overlap rows "
              f"(+ repeats), {sizes[0]} B FASTA, {sizes[1]} B PAF, "
              f"generated in {time.perf_counter() - t0:.1f} s")
        check(max(sizes) > 2e9, "the streaming dataset is under the gate")
        ctrace = os.path.join(work, "chunks.jsonl")
        digests = {}
        big_times: dict = {}
        big_rows = []
        for label, extra in (
                ("100k default (auto-stream)", []),
                ("100k --chunk-reads 0", ["--chunk-reads", "0"]),
                (f"100k --spill-paf --chunk-reads {SPILL_CHUNK}",
                 ["--spill-paf", "--chunk-reads", str(SPILL_CHUNK)])):
            if not extra:
                os.environ["RAFT_CHUNK_TRACE"] = ctrace
            st = drive(torch, cli, pileup_cuda, BENCH_ARGS + extra, big,
                       os.path.join(work, "big_out"), label, N_BIG)
            os.environ.pop("RAFT_CHUNK_TRACE", None)
            by_path[label] = st["launches"]
            digests[label] = digest_and_remove(os.path.join(work, "big_out"))
            rows, digests[label + ", held"] = held_run(
                torch, cli, pipeline, pileup_cuda, BENCH_ARGS + extra, big,
                os.path.join(work, "big_held"), label + ", held", st,
                big_times)
            big_rows += rows
            if not extra:
                check(st["schedule"] == "chunked"
                      and st["n_chunks"] == BIG_CHUNKS,
                      f"default run: {st['schedule']} x{st['n_chunks']}, "
                      f"not chunked x{BIG_CHUNKS}")
                with open(ctrace) as f:
                    recs = [json.loads(line) for line in f]
                for r in recs[:-1]:
                    print(f"  chunk {r['ci']} reads [{r['lo']}, {r['hi']}): "
                          f"wait_load_s {r['wait_load_s']} compute_s "
                          f"{r['compute_s']} drain_s {r['drain_s']} "
                          f"engine {json.dumps(r['engine'])}")
                print(f"  total_wall_s {recs[-1]['total_wall_s']} "
                      "stage_seconds "
                      + json.dumps(recs[-1]["stage_seconds"]))
            elif extra[0] == "--chunk-reads":
                check(st["schedule"] == "whole", "--chunk-reads 0 streamed")
            else:
                check(st["n_chunks"] == -(-N_BIG // SPILL_CHUNK),
                      f"spill run: {st['n_chunks']} chunks")
        label = "100k --chunk-reads 0 --device cpu"
        t0 = time.perf_counter()
        cpre = os.path.join(work, "big_cpu")
        wall = run_cli(cli, BENCH_ARGS + ["--chunk-reads", "0", "-o", cpre,
                                          "--stats-json", cpre + ".json",
                                          "--device", "cpu", *big], label)
        with open(cpre + ".json") as f:
            st = json.load(f)
        os.remove(cpre + ".json")
        check(st["schedule"] == "whole" and st["n_reads"] == N_BIG,
              f"{label}: {st['schedule']}, {st['n_reads']} reads")
        digests[label] = digest(cpre)
        print(f"{label}: wall {wall:.3f} s, {N_BIG / wall:.1f} reads/s, "
              "stages " + json.dumps({k: round(v, 3) for k, v
                                      in st["stage_seconds"].items()}))
        first = next(iter(digests.values()))
        check(all(d == first for d in digests.values()),
              "100k outputs differ between runs: " + json.dumps(digests))
        print(f"100k: auto-stream == whole-file == spill on cuda, timed and "
              f"held, == whole-file on cpu ({len(digests)} runs, 4 files, "
              f"SHA-256 {first['.reads.fasta'][:16]}...)")

        for f in [*big, *(cpre + ext for ext in OUTS)]:
            os.remove(f)

        # 9. the ground-truth evaluation on the card
        eval_paths, eval_rows = eval_phase(torch, np, pipeline, pileup_cuda,
                                           work, big_times)
        by_path.update(eval_paths)

    return report(torch, name, "32k whole-file", by_path, real,
                  kcases + real + big_rows + shard_rows + rank_rows
                  + eval_rows, sc_cases, gather_row)


def report(torch, name, main_label, by_path, main_rows, all_rows,
           sc_cases=(), gather_row=None) -> int:
    """The closing lines: the kernel table, then the result. For each
    kernel: the launches of the main path's run and of every path
    (``by_path``: each path's launches by kernel), the largest
    error of every comparison (``sc_cases`` are step 3b's), the kernel,
    plain and bound
    milliseconds summed over the main path's buckets; no single PyTorch
    call computes windowed interval coverage, or the repeat scan and
    fragment spans, so ``library_ms`` is null. ``--ab`` has no main path
    run and prints no kernel table. ``gather_row``, where given, is the
    gather's row (``gather_phase``); it replaces no TPU kernel."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "raft_tpu"))
    check(not foreign, f"imported {foreign}")
    if main_label is not None:
        print(json.dumps({"kernels": [{
            "name": "pileup", "route": "cuda",
            "source": "raft_tpu_torch/csrc/pileup.cu",
            "replaces": "raft_tpu/ops/pileup_pallas.py:39",
            "launches": by_path[main_label]["pileup"],
            "launches_by_path": {k: v["pileup"] for k, v in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in main_rows)
                         else "operations"),
            "library_ms": None}, {
            "name": "scan_chop", "route": "cuda",
            "source": "raft_tpu_torch/csrc/scan_chop.cu",
            "replaces": "raft_tpu/engine_jax.py:277-316,323-374,432-437,"
                        "446-451",
            "launches": by_path[main_label]["scan_chop"],
            "launches_by_path": {k: v["scan_chop"]
                                 for k, v in by_path.items()},
            "max_abs_err": max(r["sc_max_abs_err"] for r in
                               [*sc_cases, *all_rows]
                               if "sc_max_abs_err" in r),
            "ms": sum(r["sc_ms"] for r in main_rows),
            "plain_ms": sum(r["sc_plain_ms"] for r in main_rows),
            "bound_ms": sum(r["sc_bound_ms"] for r in main_rows),
            "bound_by": ("bytes" if all(r["sc_bound_by"] == "bytes"
                                        for r in main_rows)
                         else "operations"),
            "library_ms": None}] + ([{
            "name": "gather", "route": "cuda",
            "source": "raft_tpu_torch/csrc/gather.cu", "replaces": None,
            "launches": by_path[main_label]["gather"],
            "launches_by_path": {k: v["gather"] for k, v in by_path.items()
                                 if "gather" in v},
            **gather_row, "bound_by": "bytes", "library_ms": None}]
            if gather_row else [])}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
