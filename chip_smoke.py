"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; one card
    python3 chip_smoke.py --multi-card  # two or more cards of one host

1. Prints the card (torch's name, and nvidia-smi's name, power limit and
   compute mode).
2. Builds the CUDA pileup kernel from ``raft_tpu_torch/csrc`` with nvcc.
3. Holds the kernel against its plain PyTorch twin on the card, exactly,
   on synthetic buckets: main-path shapes, a W=64 tail, two multi-stripe
   ultralong tiers, pack32 and pairs, with empty rows, invalid events and
   padding; prints both median times per shape.
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
   Chrome trace must name the pileup kernel.
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
   plus one run's outputs (about 6 GB).
9. Checks that jax was never imported, prints the kernel table as one
   JSON line, then ``{"ok": true, "device": {...}}`` as the last line.

Every CLI run on the card (steps 4-8) counts its own pileup launches
(reset just before, read just after) and must have launched the kernel
once per bucket it reports; it prints its wall, reads/s, stage seconds
and peak ``torch.cuda.max_memory_allocated``.

Only ``raft_tpu_torch`` is imported. raft_tpu's native I/O Makefile takes
``CXX``, ``CXXFLAGS`` and ``LDFLAGS`` from the environment; the run drops
them, so the library is built with the Makefile's own toolchain. The
environment's ``RAFT_AUTO_CHUNK_BYTES``, ``RAFT_COV_OUT`` and
``RAFT_CHUNK_TRACE`` are dropped too, so every run takes the defaults.

``--multi-card`` runs steps 1-2 and then only what needs several cards,
on the 32k dataset: the CLI with ``--devices N`` over all N cards,
whole-file and ``--chunk-reads 8192``, each timed in turns with the
unsharded run on cuda:0 and rerun untimed with every shard held against
the plain twin on its own card; then ``run_distributed`` in N processes,
one card each (``CUDA_VISIBLE_DEVICES``), every launch held as in step
6c. All byte-equal to the unsharded run; the same two closing lines.

Any failed check exits nonzero before the last line. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import filecmp
import hashlib
import json
import os
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
# native I/O build settings the run leaves to raft_tpu's Makefile, and
# run-time overrides the run must not inherit
MAKE_ENV = ("CXX", "CXXFLAGS", "LDFLAGS")
RAFT_ENV = ("RAFT_AUTO_CHUNK_BYTES", "RAFT_COV_OUT", "RAFT_CHUNK_TRACE")
BENCH_ARGS = ["-e", "20", "-m", "1.5", "-p", "10000", "-l", "20000",
              "-f", "1000", "-v", "500"]
OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
# (B, W, events per row, wire format): synthetic buckets at the 32k bench
# dataset's main shapes, a tail, and ultralong tiers of 8 and 128 stripes
KERNEL_CASES = [
    (4096, 512, 60, "pack32"), (1536, 1024, 120, "pack32"),
    (384, 256, 30, "pack32"), (384, 256, 30, "pairs"), (8, 64, 10, "pack32"),
    (8, 1 << 16, 3000, "pairs"), (8, 1 << 20, 20000, "pairs")]


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


def hold(torch, pileup_cuda, cfg, off_d, pk_d, label, times=None):
    """Kernel against plain on one bucket's device inputs, exactly; both
    median times. With a ``times`` dict, a (B, W, E, wire) shape already
    in it on the same device is compared but not timed again, and prints
    nothing. Returns the table row."""
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
        if times is not None and key in times:
            ms, plain = times[key]
        else:
            ms = device_ms(torch,
                           lambda: pileup_cuda.pileup(off_d, pk_d, cfg))
            plain = device_ms(
                torch, lambda: pileup_cuda.pileup_torch(off_d, pk_d, cfg))
            if times is not None:
                times[key] = ms, plain
            print(f"{label} B={cfg.B:5d} W={cfg.W:8d} E={cfg.E:8d} "
                  f"{wire:6s} {dev} exact  kernel {ms:.4f} ms  plain "
                  f"{plain:.4f} ms  ratio {plain / ms:.2f}x")
    return dict(B=cfg.B, W=cfg.W, E=cfg.E, wire=wire, max_abs_err=err,
                ms=ms, plain_ms=plain)


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


def real_bucket_phase(torch, et, pileup_cuda, pipeline, params, reads, paf):
    """Kernel against plain on every bucket of the dataset, as
    ``compute_torch`` hands it to the device; one row per bucket."""
    rows = []
    stats = pipeline.TorchRunStats()
    store, table = pipeline.load_inputs(reads, paf, stats)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    et.compute_torch(store, table, params, device="cuda",
                     on_bucket=lambda cfg, lens, off, pk: rows.append(
                         hold(torch, pileup_cuda, cfg, off, pk, "bucket")))
    return rows


def run_cli(cli, args, label):
    t0 = time.perf_counter()
    rc = cli.main(args)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{label}: CLI exit code {rc}")
    return wall


def same_outputs(a: str, b: str) -> bool:
    return all(filecmp.cmp(a + ext, b + ext, shallow=False) for ext in OUTS)


def digest_and_remove(prefix: str) -> dict:
    """SHA-256 of each of the four outputs, streamed; then the files go."""
    out = {}
    for ext in OUTS:
        h = hashlib.sha256()
        with open(prefix + ext, "rb") as f:
            for blk in iter(lambda: f.read(1 << 24), b""):
                h.update(blk)
        out[ext] = h.hexdigest()
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
# its pileup launch count, whether jax was imported, and a row per pileup
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
                  "jax": "jax" in sys.modules}}))
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
        check(not r["jax"], f"{label} imported jax")
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


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if argv not in ([], ["--multi-card"]):
        print("usage: python3 chip_smoke.py [--multi-card]", file=sys.stderr)
        return 2
    import numpy as np

    for k in MAKE_ENV + RAFT_ENV:
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
        if "ptxas" in line or "error" in line.lower():
            print(f"  {line.strip()}")

    if argv:
        with tempfile.TemporaryDirectory(prefix="raft_smoke_") as work:
            by_path, rows, label, all_rows = multi_card(
                torch, cli, pipeline, pileup_cuda, gen_dataset, work)
        return report(torch, name, label, by_path, rows, all_rows)

    # 3. kernel vs plain on the card, synthetic buckets
    params = cli.parse_args(BENCH_ARGS + ["reads", "paf"])[0]
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
        print(f"pileup over the {len(real)} buckets of the main path: "
              f"kernel {kms:.4f} ms, plain {pms:.4f} ms, exact on all")
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
        kev = [e for e in events if "pileup_kernel" in e.get("name", "")]
        check(len(kev) >= st["launches"],
              f"--trace: {len(kev)} pileup_kernel events for "
              f"{st['launches']} launches")
        print(f"--trace: {len(events)} events, {len(kev)} name the "
              f"kernel ({kev[0]['name']}), "
              f"{sum(e.get('dur', 0) for e in kev):.1f} us in all")

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

    return report(torch, name, "32k whole-file", by_path, real,
                  kcases + real + big_rows + shard_rows + rank_rows)


def report(torch, name, main_label, by_path, main_rows, all_rows) -> int:
    """The closing lines: the kernel table (launches of the main path's
    run and of every path, the largest error of every comparison, the
    kernel and plain milliseconds summed over the main path's buckets),
    then the result."""
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "pileup", "route": "cuda",
        "source": "raft_tpu_torch/csrc/pileup.cu",
        "replaces": "raft_tpu/ops/pileup_pallas.py:39",
        "launches": by_path[main_label], "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in all_rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
