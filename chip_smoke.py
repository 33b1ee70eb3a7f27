"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; one card
    python3 chip_smoke.py --multi-card  # two or more cards of one host
    python3 chip_smoke.py --ab DIR      # this kernel against DIR's; one card

1. Prints the card (torch's name, and nvidia-smi's name, power limit and
   compute mode).
2. Builds the CUDA pileup kernel from ``raft_tpu_torch/csrc`` with nvcc.
3. Holds the kernel against its plain PyTorch twin on the card, exactly,
   on synthetic buckets: main-path shapes, a W=64 tail, two multi-stripe
   ultralong tiers, a width in each regime whose rows are not 16-byte
   aligned (the int-store path), pack32 and pairs, with empty rows,
   invalid events and padding; prints per shape the launch plan, both median times, the
   bound (the bytes the pileup must move over 3.35 TB/s) and the kernel's
   share of it.
4. Checks the CLI's ``--device cuda`` output against the numpy oracle
   engine on a small dataset, then runs the whole-file CLI on the 32k-read
   bench dataset (``gen_dataset``, seed 7) with ``--device cuda`` and
   ``--device cpu``, compares the four output files byte for byte, and
   checks that the CUDA run launched the pileup kernel once per bucket it
   reported. Then holds the kernel against its plain twin, exactly, on
   every bucket of that dataset as the engine hands it to the device, and
   checks those are the buckets the CLI run reported.
5. Coverage return modes on the 32k dataset: ``--cov-out diff8`` and
   ``--cov-out cov`` with ``--device cuda`` must equal the ``host`` run
   byte for byte; then each mode's engine stage seconds (the ``step``
   timer holds its D2H) and D2H bytes, alternating modes.
6. Read sharding and multi-process runs on the 32k dataset, each
   byte-equal to the unsharded ``--device cuda`` run:
   a. the CLI with ``--devices 1 --device cuda``;
   b. ``run_pipeline(devices=[cuda:0] * 4)``, four shards on one card,
      whole-file and ``--chunk-reads 8192``, each timed in turns with the
      unsharded run (unsharded, sharded, sharded, unsharded); every timed
      sharded run must have launched the kernel once per shard it
      records, and an untimed rerun holds every shard of every bucket
      against the plain twin, exactly;
   c. ``run_distributed`` in two processes (gloo over 127.0.0.1), both
      ranks on ``cuda:0`` when the card's compute mode is ``Default``
      (otherwise rank 1 runs on the CPU, and a line says so); rank 0's
      concatenated shards must equal the single run. Each rank holds every
      pileup call of its engine against the plain twin, exactly, at the
      rank's own bucket shapes, and prints its wall and its pileup launch
      count, which must be one per call.
7. ``--trace DIR`` on the small dataset with ``--device cuda``: the
   Chrome trace must name the pileup kernel. Then ``--pallas`` and
   ``--no-pallas`` on it: each launches the kernel once per bucket and
   writes the step 4 run's files.
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
   plus one run's outputs (about 6 GB). The dataset is deleted after.
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
   prints the kernel table as one JSON line, then ``{"ok": true,
   "device": {...}}`` as the last line.

Every CLI run on the card (steps 4-8) counts its own pileup launches
(reset just before, read just after) and must have launched the kernel
once per bucket it reports; it prints its wall, reads/s, stage seconds
and peak ``torch.cuda.max_memory_allocated``.

Only ``raft_tpu_torch`` is imported; its native I/O builds with fixed
flags, whatever the environment's ``CXX``, ``CXXFLAGS`` and ``LDFLAGS``.
The environment's ``RAFT_AUTO_CHUNK_BYTES``, ``RAFT_COV_OUT`` and
``RAFT_CHUNK_TRACE`` are dropped, so every run takes the defaults.

``--multi-card`` runs steps 1-2 and then only what needs several cards,
on the 32k dataset: the CLI with ``--devices N`` over all N cards,
whole-file and ``--chunk-reads 8192``, each timed in turns with the
unsharded run on cuda:0 and rerun untimed with every shard held against
the plain twin on its own card; then ``run_distributed`` in N processes,
one card each (``CUDA_VISIBLE_DEVICES``), every launch held as in step
6c. All byte-equal to the unsharded run; the same two closing lines.

``--ab DIR`` runs steps 1-2, builds the pileup kernel of another tree
(DIR holds its ``raft_tpu_torch/``, e.g. a ``git archive`` of the parent
commit) with that tree's own wrapper, and times the two in turns (DIR's,
this, this, DIR's) on step 3's shapes and on the 32k main path's buckets,
each held exactly against the plain twin.

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

N_READS = 32000          # bench.py's headline dataset
N_BIG = 100_000          # streaming dataset: ~2.4 GB FASTA, over the gate
N_BIG_OVERLAPS = 3_000_000
BIG_CHUNKS = 4           # ceil(100000 / DEFAULT_CHUNK_READS = 32768)
SPILL_CHUNK = 8192
N_SHARDS = 4             # shards on one card (step 6b)
SHARD_CHUNK = 8192
# run-time overrides the run must not inherit
RAFT_ENV = ("RAFT_AUTO_CHUNK_BYTES", "RAFT_COV_OUT", "RAFT_CHUNK_TRACE")
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
# dataset's main shapes, a tail, two ultralong tiers of few rows, and one
# width per regime with W % 4 != 0 (rows leave by int stores, not TMA)
KERNEL_CASES = [
    (4096, 512, 60, "pack32"), (1536, 1024, 120, "pack32"),
    (384, 256, 30, "pack32"), (384, 256, 30, "pairs"), (8, 64, 10, "pack32"),
    (8, 1 << 16, 3000, "pairs"), (8, 1 << 20, 20000, "pairs"),
    (33, 7, 5, "pack32"), (2, 65538, 3000, "pairs")]
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


def hold(torch, pileup_cuda, cfg, off_d, pk_d, label, times=None):
    """Kernel against plain on one bucket's device inputs, exactly; both
    median times, the launch plan and the bound. With a ``times`` dict, a
    (B, W, E, wire) shape already in it on the same device is compared
    but not timed again, and prints nothing. Returns the table row."""
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
    return dict(B=cfg.B, W=cfg.W, E=cfg.E, wire=wire, max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


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


def main_path_buckets(torch, et, pipeline, params, reads, paf):
    """Every bucket's device inputs of the dataset, as ``compute_torch``
    hands them to the device: (cfg, ev_off, ev_pk) on cuda:0."""
    out = []
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    et.compute_torch(store, table, params, device="cuda",
                     on_bucket=lambda cfg, lens, off, pk: out.append(
                         (cfg, off.clone(), pk.clone())))
    return out


def load_base(root):
    """The pileup wrapper of another tree, under its own module name, so
    that it builds and loads that tree's kernel library from that tree."""
    path = os.path.join(root, "raft_tpu_torch", "ops", "pileup_cuda.py")
    spec = importlib.util.spec_from_file_location("base_pileup_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ab_phase(torch, np, et, pileup_cuda, pipeline, params, base, work,
             gen_dataset):
    """``--ab``: the base tree's kernel against this one, in turns (base,
    this, this, base), on the synthetic shapes and the 32k main path's
    buckets, each exact against the plain twin."""
    rng = np.random.default_rng(7)
    cases = []
    for B, W, per_row, wire in KERNEL_CASES:
        cfg, ev_off, pk = make_case(np, et, params, B, W, per_row, wire, rng)
        cases.append(("synthetic", cfg, torch.from_numpy(ev_off).cuda(),
                      torch.from_numpy(np.ascontiguousarray(pk)).cuda()))
    reads, paf = gen_dataset(os.path.join(work, "bench"), n_reads=N_READS,
                             n_overlaps=N_READS * 30, est_cov=20, seed=7)
    cases += [("32k bucket", *c) for c in main_path_buckets(
        torch, et, pipeline, params, reads, paf)]
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
    print(f"ab the 32k main path's {len(cases) - len(KERNEL_CASES)} "
          f"buckets, summed medians: base {tot['base']:.4f} ms, this "
          f"{tot['this']:.4f} ms, bound {tot['bound']:.4f} ms, share base "
          f"{tot['bound'] / tot['base']:.1%} this "
          f"{tot['bound'] / tot['this']:.1%}")


def real_bucket_phase(torch, et, pileup_cuda, pipeline, params, reads, paf):
    """Kernel against plain on every bucket of the dataset, as
    ``compute_torch`` hands it to the device; one row per bucket."""
    return [hold(torch, pileup_cuda, cfg, off, pk, "bucket")
            for cfg, off, pk in main_path_buckets(torch, et, pipeline,
                                                  params, reads, paf)]


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


def drive(torch, cli, pileup_cuda, opts, inputs, prefix, label, n_reads):
    """One CLI run with ``--device cuda``: its own pileup launch count
    (reset just before, read just after) and peak device memory. Fails
    unless the kernel launched once per bucket the run reports. Returns
    the run's stats JSON with ``launches`` added."""
    sj = prefix + ".stats.json"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pileup_cuda.launches = 0
    wall = run_cli(cli, [*opts, "-o", prefix, "--stats-json", sj,
                         "--device", "cuda", *inputs], label)
    torch.cuda.synchronize()
    launches = pileup_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    with open(sj) as f:
        st = json.load(f)
    os.remove(sj)
    check(launches == len(st["buckets"]) > 0,
          f"{label}: pileup launches {launches} != buckets "
          f"{len(st['buckets'])}")
    check(st["n_reads"] == n_reads and st["native_io"],
          f"{label}: {st['n_reads']} reads, native I/O {st['native_io']}")
    print(f"{label}: {st['schedule']} x{st['n_chunks']}, wall {wall:.3f} s, "
          f"{n_reads / wall:.1f} reads/s, {launches} pileup launches "
          f"(= buckets), peak device memory {peak:.1f} MiB, stages "
          + json.dumps({k: round(v, 3)
                        for k, v in st["stage_seconds"].items()}))
    return {**st, "launches": launches}


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
            hold(torch, pileup_cuda, cfg, off, pk, label, times)))
    check([[r["B"], r["W"], r["E"]] for r in rows] == st["buckets"],
          f"{label}: the buckets held against plain are not the timed "
          "run's")
    shapes = sorted({(r["B"], r["W"]) for r in rows})
    print(f"{label}: kernel == plain on all {len(rows)} buckets, "
          f"(B, W) {shapes}")
    return rows, digest_and_remove(prefix)


def cov_mode_timing(torch, et, pipeline, params, reads, paf):
    """``compute_torch`` on the card in each coverage return mode, in
    turns (host, diff8, cov, cov, diff8, host) on one parse of the input:
    prints the engine's stage seconds and the D2H bytes of each mode."""
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    for mode in ("host", "diff8", "cov", "cov", "diff8", "host"):
        timers: dict = {}
        shapes: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        et.compute_torch(store, table, params, device="cuda", cov_out=mode,
                         timers_out=timers,
                         on_bucket=lambda cfg, *_: shapes.append(cfg))
        timers["compute"] = time.perf_counter() - t0
        per_cell = {"host": 0, "diff8": 1, "cov": 4}[mode]
        d2h = sum(c.B * (et.packed_width(c) * 4 + c.W * per_cell)
                  for c in shapes)
        print(f"cov_out {mode:5s}: D2H {d2h / 2**20:.1f} MiB, "
              + ", ".join(f"{k} {v:.4f} s" for k, v in timers.items()))


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
            pileup_cuda.launches = 0
            t0 = time.perf_counter()
            st = pipeline.run_pipeline(*inputs, params, verbose=False,
                                       device="cuda", chunk_reads=chunk,
                                       devices=devs)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            launches = pileup_cuda.launches
            check(launches == len(st.buckets) > 0,
                  f"{kind} {sched}: pileup launches {launches} != "
                  f"recorded shards {len(st.buckets)}")
            check(digest_and_remove(prefix) == want,
                  f"{kind} {sched}: outputs differ from the unsharded "
                  "--device cuda run's")
            if devs:
                shards = st.buckets
                check(st.devices == ["cuda:0"] * N_SHARDS
                      and len(shards) % N_SHARDS == 0,
                      f"sharded {sched}: devices {st.devices}, "
                      f"{len(shards)} shards")
                by_path[f"32k {N_SHARDS} shards on cuda:0, {sched}"] = (
                    launches)
            else:
                n_buckets = len(st.buckets)
        check(len(shards) == N_SHARDS * n_buckets,
              f"{sched}: {len(shards)} shards for {n_buckets} buckets")
        label = f"32k {N_SHARDS} shards {sched}, held"
        held = []
        pipeline.run_pipeline(
            *inputs, params, verbose=False, device="cuda", chunk_reads=chunk,
            devices=four, on_bucket=lambda cfg, lens, off, pk: held.append(
                hold(torch, pileup_cuda, cfg, off, pk, label, times)))
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
# its pileup launch count, the jax and raft_tpu modules it imported (none
# may be), and a row per pileup
# call of the engine: that call's (B, W, E), held against the plain twin on
# the same device inputs. The launch count rises only in the real wrapper.
RANK_CODE = """\
import json, sys, time
import torch
from raft_tpu_torch import engine_torch
from raft_tpu_torch.cli import parse_args
from raft_tpu_torch.ops import pileup_cuda
from raft_tpu_torch.parallel import run_distributed
held = []
def held_pileup(ev_off, ev_pk, cfg):
    got = pileup_cuda.pileup(ev_off, ev_pk, cfg)
    want = pileup_cuda.pileup_torch(ev_off, ev_pk, cfg)
    held.append(dict(
        B=cfg.B, W=cfg.W, E=cfg.E, equal=torch.equal(got, want),
        max_abs_err=int((got.long() - want.long()).abs().max().item())))
    return got
engine_torch.pileup = held_pileup
params = parse_args({args!r})[0]
pileup_cuda.launches = 0
t0 = time.perf_counter()
run_distributed({reads!r}, {paf!r}, params, coordinator={coord!r},
                num_processes={n}, process_id={rank}, device={device!r})
if {device!r} == "cuda":
    torch.cuda.synchronize()
print(json.dumps({{"rank": {rank}, "device": {device!r},
                  "wall": time.perf_counter() - t0,
                  "launches": pileup_cuda.launches, "held": held,
                  "foreign": sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "raft_tpu"))}}))
"""


def multi_process_phase(inputs, prefix, want, devs, visible=None):
    """``run_distributed`` in ``len(devs)`` processes over gloo on
    127.0.0.1, rank r on ``devs[r]`` (``cuda`` or ``cpu``), with
    ``CUDA_VISIBLE_DEVICES`` set to ``visible[r]`` when given. Every
    pileup call of every rank is held against the plain twin, exactly,
    and a rank on the card must have launched the kernel once per call.
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
        check(len(held) > 0
              and r["launches"] == (len(held) if r_dev == "cuda" else 0),
              f"{label}: {r['launches']} pileup launches for {len(held)} "
              "pileup calls")
        bad = [h for h in held if not h["equal"] or h["max_abs_err"]]
        check(not bad, f"{label}: kernel != plain on {bad}")
        by_path[f"32k {label}"] = r["launches"]
        rows += held
        shapes = sorted({(h["B"], h["W"]) for h in held})
        print(f"{label}: wall {r['wall']:.3f} s in run_distributed, "
              f"{r['launches']} pileup launches, each held == plain, "
              f"(B, W) {shapes}")
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
        pileup_cuda.launches = 0
        t0 = time.perf_counter()
        row = real["_eval_point"](workdir, prefix, info, genome_size,
                                  engine, est_cov_scale, loaded=loaded,
                                  auto_e=auto_e, device=device)
        torch.cuda.synchronize()
        rec = dict(row=row, workdir=workdir, prefix=prefix, info=info,
                   genome_size=genome_size, device=device,
                   wall=time.perf_counter() - t0,
                   launches=pileup_cuda.launches, sim_s=sim_s,
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
    check(rec["launches"] == (len(run_b) + len(cmp_b) if on_card else 0)
          and (rec["launches"] > 0 or not on_card),
          f"{label}: {rec['launches']} pileup launches for {len(run_b)} + "
          f"{len(cmp_b)} buckets")
    check(st.schedule != "whole" or run_b == cmp_b,
          f"{label}: the product run's buckets are not compute_torch's")
    sim = "" if rec["sim_s"] is None else f"simulation {rec['sim_s']:.3f} s, "
    print(f"{label}: wall {rec['wall']:.3f} s ({sim}product run "
          f"{rec['run_s']:.3f} s {st.schedule} x{st.n_chunks}, "
          f"compute_torch {rec['compute_s']:.3f} s), {rec['launches']} "
          f"pileup launches ({'=' if on_card else 'on the CPU:'} "
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
    rows = []

    def on_bucket(cfg, lens, off, pk):
        n = pileup_cuda.launches
        rows.append(hold(torch, pileup_cuda, cfg, off, pk, label, times))
        pileup_cuda.launches = n

    params = AlgoParams(est_cov=rec["row"]["est_cov_used"],
                        outputfilename=os.path.join(rec["workdir"], "held"))
    torch.cuda.synchronize()
    pileup_cuda.launches = 0
    st = pipeline.run_pipeline(
        rec["prefix"] + ".reads.fasta", rec["prefix"] + ".overlaps.paf",
        params, verbose=False, device="cuda", chunk_reads=chunk_reads,
        on_bucket=on_bucket)
    torch.cuda.synchronize()
    launches = pileup_cuda.launches
    check([(r["B"], r["W"], r["E"]) for r in rows]
          == [tuple(b) for b in st.buckets]
          == [tuple(b) for b in want_buckets]
          and launches == len(rows) > 0,
          f"{label}: {launches} launches, {len(rows)} buckets held, "
          f"{len(want_buckets)} wanted, or not the same buckets")
    check(digest_and_remove(params.outputfilename) == want_digest,
          f"{label}: outputs differ from the point's")
    print(f"{label}: {st.schedule} x{st.n_chunks}, kernel == plain on all "
          f"{len(rows)} buckets, {launches} launches (= buckets); outputs "
          "== the point's (4 files, SHA-256)")
    return rows, launches, st


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
        by_path[path] = sum(r["launches"] for r in recs)
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
            check(rec["launches"] == 2 * len(rows),
                  f"{label}: the point launched {rec['launches']} times for "
                  f"{len(rows)} buckets held")
            held += rows
            print(f"{label}: the point launched {rec['launches']} (= 2 x "
                  f"{len(rows)})")
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
    rows, launches, wst = held_point_run(
        torch, pipeline, pileup_cuda, rec, f"{label}, --chunk-reads 0, held",
        times, rec["compute_buckets"], want, chunk_reads=0)
    check(wst.schedule == "whole", f"{label}, --chunk-reads 0: streamed")
    held += rows
    by_path[f"{label}, --chunk-reads 0"] = launches
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
    from raft_tpu_torch.ops import pileup_cuda

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
    so, log = pileup_cuda.build_kernels(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so}")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line or "error" in line.lower():
            print(f"  {line.strip()}")

    params = cli.parse_args(BENCH_ARGS + ["reads", "paf"])[0]
    if argv and argv[0] == "--ab":
        base = load_base(argv[1])
        so, log = base.build_kernels(force=True)
        print(f"base build -> {so}")
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line or "error" in line.lower():
                print(f"  {line.strip()}")
        with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
            ab_phase(torch, np, et, pileup_cuda, pipeline, params, base,
                     work, gen_dataset)
        return report(torch, name, None, {}, [], [])
    if argv:
        with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
            by_path, rows, label, all_rows = multi_card(
                torch, cli, pipeline, pileup_cuda, gen_dataset, work)
        return report(torch, name, label, by_path, rows, all_rows)

    # 3. kernel vs plain on the card, synthetic buckets
    kcases = kernel_phase(torch, np, et, pileup_cuda, params)

    os.environ["RAFT_TIMERS"] = "1"
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
                pileup_cuda.launches = 0
            walls[dev] = run_cli(cli, BENCH_ARGS + [
                "-o", pre[dev], "--stats-json", sj, "--device", dev,
                reads, paf], f"bench {dev}")
            if dev == "cuda":
                launches = pileup_cuda.launches
                peak = torch.cuda.max_memory_allocated()
            with open(sj) as f:
                stats[dev] = json.load(f)
        shapes = [tuple(b) for b in stats["cuda"]["buckets"]]
        print(f"buckets (B, W, E) of the cuda run: {len(shapes)} {shapes}")
        check(launches == len(shapes) > 0,
              f"pileup launches {launches} != buckets {len(shapes)}")
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
                                for k, v in st["stage_seconds"].items()}))
        print(f"pileup launches in the cuda run: {launches} "
              f"(= {len(shapes)} buckets); peak device memory "
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
        by_path = {"32k whole-file": launches}

        # 5. coverage return modes: byte-equal to the host run
        want = digest_and_remove(pre["cuda"])
        for dev in ("cuda", "cpu"):
            os.remove(pre[dev] + ".stats.json")
        digest_and_remove(pre["cpu"])
        for mode in ("diff8", "cov"):
            label = f"32k --cov-out {mode}"
            st = drive(torch, cli, pileup_cuda,
                       BENCH_ARGS + ["--cov-out", mode], (reads, paf),
                       os.path.join(work, mode), label, N_READS)
            check(digest_and_remove(os.path.join(work, mode)) == want,
                  f"{label} outputs differ from the host run's")
            by_path[label] = st["launches"]
        print("32k --cov-out diff8 and cov == host (4 files)")
        cov_mode_timing(torch, et, pipeline, params, reads, paf)

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
        for f in (reads, paf):
            os.remove(f)

        # 7. --trace on the small input names the pileup kernel
        tdir = os.path.join(work, "trace")
        st = drive(torch, cli, pileup_cuda, BENCH_ARGS + ["--trace", tdir],
                   small, os.path.join(work, "tr"), "small --trace", 400)
        by_path["small --trace"] = st["launches"]
        with open(os.path.join(tdir, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        kev = [e for e in events
               if any(k in e.get("name", "")
                      for k in pileup_cuda.KERNEL_NAMES)]
        check(len(kev) >= st["launches"],
              f"--trace: {len(kev)} pileup kernel events for "
              f"{st['launches']} launches")
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
        digests[label] = digest_and_remove(cpre)
        print(f"{label}: wall {wall:.3f} s, {N_BIG / wall:.1f} reads/s, "
              "stages " + json.dumps({k: round(v, 3) for k, v
                                      in st["stage_seconds"].items()}))
        first = next(iter(digests.values()))
        check(all(d == first for d in digests.values()),
              "100k outputs differ between runs: " + json.dumps(digests))
        print(f"100k: auto-stream == whole-file == spill on cuda, timed and "
              f"held, == whole-file on cpu ({len(digests)} runs, 4 files, "
              f"SHA-256 {first['.reads.fasta'][:16]}...)")
        for f in big:
            os.remove(f)

        # 9. the ground-truth evaluation on the card
        eval_paths, eval_rows = eval_phase(torch, np, pipeline, pileup_cuda,
                                           work, big_times)
        by_path.update(eval_paths)

    return report(torch, name, "32k whole-file", by_path, real,
                  kcases + real + big_rows + shard_rows + rank_rows
                  + eval_rows)


def report(torch, name, main_label, by_path, main_rows, all_rows) -> int:
    """The closing lines: the kernel table (launches of the main path's
    run and of every path, the largest error of every comparison, the
    kernel, plain and bound milliseconds summed over the main path's
    buckets; no single PyTorch call computes windowed interval coverage,
    so ``library_ms`` is null), then the result. ``--ab`` has no main
    path run and prints no kernel table."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "raft_tpu"))
    check(not foreign, f"imported {foreign}")
    if main_label is not None:
        print(json.dumps({"kernels": [{
            "name": "pileup", "route": "cuda",
            "source": "raft_tpu_torch/csrc/pileup.cu",
            "replaces": "raft_tpu/ops/pileup_pallas.py:39",
            "launches": by_path[main_label], "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in main_rows)
                         else "operations"),
            "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
