"""Mirrors bench.py at the repository root: the port's headline benchmark
on one NVIDIA GPU.

Runs the full end-to-end pipeline (parse → device compute → emit) on the
synthetic workload of the root ``bench.py`` (``gen_dataset`` with N reads,
~23.6 kb mean, 30 PAF rows per read; seed 7, so the files are byte-equal
to ``chip_smoke.py``'s 32k dataset) with ``--device cuda``, and compares
reads/s against the reference binary run live on the same machine
(falling back to the surveyed 2,600 reads/s single-thread figure when
the reference cannot be built).

Noise control, as in the original: reference and port timings are
INTERLEAVED over several rounds (min of each), and the JSON carries the
per-round arrays, the round count, the warm-up wall and the workdir kind.

What differs from the original: there is no shape pre-warm (the CUDA
engine compiles nothing per shape); ``pileup_ok`` holds the CUDA pileup
kernel exactly against its plain twin ``pileup_torch`` on the largest
bucket (the original's ``pallas_ok``; there is no routing policy, so no
``pallas_gate``); ``gpu_vs_cpu_backend`` is the original's
``tpu_vs_cpu_backend`` (the CPU ablation is ``tools/bench_cpu`` in a
subprocess); the line names the card (``device_name``, ``nvidia_smi``).

Usage::

    python -m raft_tpu_torch.bench [--device {cuda,cpu}]

``--device cuda`` (the default) without a CUDA device exits 1 and prints
no JSON line. ``--device cpu`` runs the same harness on the CPU for the
tests: ``pileup_ok`` is then null and the CPU ablation is skipped (it
would be the same run). Environment: ``RAFT_BENCH_DIR`` (work directory,
default ``raft_bench`` under the temporary directory),
``RAFT_BENCH_READS`` (32000), ``RAFT_BENCH_ROUNDS`` (6),
``RAFT_BENCH_BUDGET_S`` (180: no new round after this many seconds),
``RAFT_BENCH_HARD_S`` (1200: past it, print the best so far and exit 0),
and ``RAFT_BENCH_PILEUP_CHECK``, ``RAFT_BENCH_CPU_ABLATION``,
``RAFT_BENCH_PARALLEL_REF`` (``0`` skips that part).

Prints ONE JSON line on stdout:
  {"metric": "reads_per_s", "value": N, "unit": "reads/s", "vs_baseline": R, ...}
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

BASELINE_READS_PER_S = 2600.0  # measured: reference, 1 thread, BASELINE.md
ARGS = ["-e", "20", "-m", "1.5", "-p", "10000", "-l", "20000",
        "-f", "1000", "-v", "500"]
DEVICES = ("cuda", "cpu")


@dataclasses.dataclass
class Bench:
    """One benchmark run: its settings and the best timings so far (what
    the hard-deadline line reports)."""
    work: str
    n_reads: int
    rounds: int
    device: str
    ours: float = float("inf")
    ref: float = float("inf")
    ref_par: float = float("nan")
    pileup_ok: bool | None = None
    cpu_backend: float = float("nan")
    # per-round wall arrays (drift forensics): warm-up excluded from
    # ours_rounds
    warmup_s: float = float("nan")
    ours_rounds: list = dataclasses.field(default_factory=list)
    ref_rounds: list = dataclasses.field(default_factory=list)
    ref_par_rounds: list = dataclasses.field(default_factory=list)
    device_name: str | None = None
    nvidia_smi: str | None = None

    @classmethod
    def from_env(cls, device: str) -> "Bench":
        return cls(work=work_dir(), n_reads=env_reads(),
                   rounds=int(os.environ.get("RAFT_BENCH_ROUNDS", "6")),
                   device=device)


def work_dir() -> str:
    """``RAFT_BENCH_DIR``, default ``raft_bench`` under the temporary
    directory: where the benchmark tools keep their datasets."""
    return os.environ.get("RAFT_BENCH_DIR",
                          os.path.join(tempfile.gettempdir(), "raft_bench"))


def env_reads() -> int:
    return int(os.environ.get("RAFT_BENCH_READS", "32000"))


def headline_dataset(work: str, n_reads: int) -> tuple[str, str]:
    """The headline workload (``bench.py:293-295``): ``gen_dataset`` with
    ``n_reads`` reads and 30 PAF rows a read, cached under ``work``."""
    from raft_tpu_torch.tools.benchgen import gen_dataset
    os.makedirs(work, exist_ok=True)
    return gen_dataset(os.path.join(work, f"data{n_reads}"),
                       n_reads=n_reads, n_overlaps=n_reads * 30, est_cov=20)


def headline_table(reads: str, paf: str):
    """The dataset's read-grouped events as ``compute_torch`` groups them
    (``est_cov`` 20): (params, int32 read lengths, the grouped triple),
    or None without the native grouped events."""
    import numpy as np
    from raft_tpu_torch.io.fasta import load_reads
    from raft_tpu_torch.io.paf import load_paf
    from raft_tpu_torch.params import AlgoParams
    store = load_reads(reads)
    table = load_paf(paf, store)
    params = AlgoParams(est_cov=20)
    lens = store.lens.astype(np.int32)
    g = table.events_grouped(store.n_reads, lens, params.reso)
    return None if g is None else (params, lens, g)


def headline_buckets(reads: str, paf: str):
    """The dataset's buckets as ``raft_tpu``'s engine makes them
    (``bucketing.iter_buckets`` over ``headline_table``'s events):
    (params, list of buckets), or None without the native grouped
    events."""
    from raft_tpu_torch import bucketing
    got = headline_table(reads, paf)
    if got is None:
        return None
    params, lens, g = got
    return params, list(bucketing.iter_buckets(lens, None, None, None,
                                               params.reso, prebinned=g))


def cuda_missing(device: str, tool: str) -> bool:
    """True (and a line on stderr) when ``device`` is cuda and there is
    no CUDA device: the tools check before they generate or run
    anything."""
    if device != "cuda":
        return False
    import torch
    if torch.cuda.is_available():
        return False
    print(f"{tool}: --device cuda: no CUDA device is available (pass "
          "--device cpu to run on the CPU)", file=sys.stderr)
    return True


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def card_names() -> tuple[str, str | None]:
    """``torch.cuda.get_device_name(0)`` and nvidia-smi's ``name, power
    limit`` of the first card (None when nvidia-smi cannot say)."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return name, smi


def build_reference(work: str) -> str | None:
    from raft_tpu_torch.tools.refbuild import build_reference as _build
    return _build(work)


def run_reference_once(b: Bench, ref_bin: str, reads: str,
                       paf: str) -> float:
    t0 = time.perf_counter()
    res = subprocess.run(
        [ref_bin] + ARGS + ["-o", os.path.join(b.work, "refout"), reads, paf],
        capture_output=True, timeout=3600)
    dt = time.perf_counter() - t0
    return dt if res.returncode == 0 else float("nan")


def run_reference_parallel(b: Bench, ref_bin: str, reads: str,
                           paf: str) -> float:
    """Thread-scaled reference baseline (BASELINE.md:17-21 'record both'):
    nproc reference processes on pre-sharded input, wall time for ALL.
    Sharding splits reads into nproc contiguous id ranges and gives each
    process only the PAF rows touching its range (the same per-host split
    run_distributed uses) — the honest way to parallelize a
    single-threaded tool."""
    n_proc = os.cpu_count() or 1
    if n_proc <= 1:
        return float("nan")
    shard_dir = os.path.join(b.work, "refpar")
    marker = os.path.join(shard_dir, f"ready{b.n_reads}_{n_proc}_v2")
    if not os.path.exists(marker):
        if not write_reference_shards(reads, paf, shard_dir, n_proc):
            return float("nan")  # parser skipped rows; mapping unsafe
        open(marker, "w").close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [ref_bin] + ARGS + ["-o", os.path.join(shard_dir, f"out{h}"),
                            os.path.join(shard_dir, f"reads{h}.fa"),
                            os.path.join(shard_dir, f"ovl{h}.paf")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for h in range(n_proc)]
    ok = all(p.wait(timeout=3600) == 0 for p in procs)
    dt = time.perf_counter() - t0
    return dt if ok else float("nan")


def write_reference_shards(reads: str, paf: str, shard_dir: str,
                           n_proc: int) -> bool:
    """The parallel reference's inputs: for each of ``n_proc`` contiguous
    read-id ranges, ``ovl{h}.paf`` (every PAF row touching the range) and
    ``reads{h}.fa`` (the range's reads plus the HALO reads, each row's
    other endpoint). The reference writes out of bounds on names absent
    from its read store (chop.hpp:162-168 overrun), so a faithful parallel
    run must carry the partner reads and redo cross-shard rows. That
    duplicated work is the honest cost of parallelizing the unmodified
    single-threaded tool. False when the parser skipped PAF rows, so that
    rows cannot be mapped to lines."""
    import numpy as np
    from raft_tpu_torch.io.fasta import load_reads
    from raft_tpu_torch.io.paf import load_paf
    from raft_tpu_torch.parallel.distributed import bin_ranges
    os.makedirs(shard_dir, exist_ok=True)
    store = load_reads(reads)
    table = load_paf(paf, store)
    n = store.n_reads
    _, ranges = bin_ranges(n, n_proc)
    a = np.asarray(table.a_id, dtype=np.int64)
    b = np.asarray(table.b_id, dtype=np.int64)
    with open(paf, "rb") as f:
        lines = f.readlines()
    if len(lines) != table.n_rows:
        return False
    for h, (lo, hi) in enumerate(ranges):
        mask = ((a >= lo) & (a < hi)) | ((b >= lo) & (b < hi))
        idx = np.nonzero(mask)[0]
        with open(os.path.join(shard_dir, f"ovl{h}.paf"), "wb") as f:
            f.writelines([lines[i] for i in idx])
        ids = np.unique(np.concatenate(
            [np.arange(lo, hi, dtype=np.int64), a[idx], b[idx]]))
        ids = ids[(ids >= 0) & (ids < n)]
        with open(os.path.join(shard_dir, f"reads{h}.fa"), "wb") as f:
            for i in ids:
                s = store.seq(int(i))
                s = s if isinstance(s, bytes) else bytes(s)
                f.write(b">" + store.names[int(i)].encode() + b"\n"
                        + s + b"\n")
    return True


def check_pileup_parity(reads: str, paf: str, device: str) -> bool | None:
    """The CUDA pileup kernel against its plain twin ``pileup_torch``,
    exactly, on the same card tensors of the dataset's largest bucket
    (B x W), as ``compute_torch`` would hand it to the device: a kernel
    or toolchain regression shows in every benchmark line. One kernel
    launch. None off the card (``--device cpu``) or without the native
    grouped events."""
    if device != "cuda":
        return None
    import torch
    from raft_tpu_torch.engine_torch import bucket_to_device, derive_cfg
    from raft_tpu_torch.ops import pileup_cuda

    got = headline_buckets(reads, paf)
    if got is None:
        return None  # native lib unavailable: check skipped, not failed
    params, buckets = got
    bk = max(buckets, key=lambda k: k.B * k.W)
    cfg = derive_cfg(bk.B, bk.W, bk.E, params)
    _, ev_off, ev_pk = bucket_to_device(bk, cfg, device)
    got = pileup_cuda.pileup(ev_off, ev_pk, cfg)
    want = pileup_cuda.pileup_torch(ev_off, ev_pk, cfg)
    return bool(torch.equal(got, want))


def run_cpu_backend(b: Bench, reads: str, paf: str) -> float:
    """Card-against-own-host ablation: the identical pipeline with
    ``--device cpu``, in a subprocess so that process holds nothing of
    this one's CUDA context. Returns min wall seconds (NaN on failure)."""
    try:
        res = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.tools.bench_cpu",
             reads, paf, os.path.join(b.work, "ours_cpu"), "2"],
            capture_output=True, timeout=900, text=True)
        if res.returncode == 0:
            return float(res.stdout.strip().splitlines()[-1])
        print(f"bench: cpu ablation failed: {res.stderr[-500:]}",
              file=sys.stderr)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        print(f"bench: cpu ablation failed: {e}", file=sys.stderr)
    return float("nan")


def emit_json(b: Bench, ours_best: float, ref_reads_per_s: float,
              deadline: bool = False) -> dict:
    """Print the result line (and return it)."""
    n = b.n_reads
    reads_per_s = n / ours_best if ours_best > 0 else 0.0
    out = {
        "metric": "reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        # headline ratio: vs the live 1-thread reference (the reference
        # IS single-threaded; see vs_parallel_ref for the thread-scaled
        # comparison BASELINE.md asks to record alongside it)
        "vs_baseline": round(reads_per_s / ref_reads_per_s, 3),
    }
    rp = b.ref_par
    if rp == rp and rp > 0:  # not NaN
        out["parallel_ref_reads_per_s"] = round(n / rp, 1)
        if n / rp > ref_reads_per_s:
            out["vs_parallel_ref"] = round(reads_per_s / (n / rp), 3)
        else:
            # sharding the unmodified reference LOST to one thread on
            # this run (halo duplication and/or machine noise) — the
            # meaningful scaled baseline is then the ideal bound below
            out["parallel_ref_slower_than_1t"] = True
    # the most conservative scaled baseline: PERFECT linear core scaling
    # of the single-thread figure (real sharding does worse)
    n_proc = os.cpu_count() or 1
    out["vs_ideal_scaled_ref"] = round(
        reads_per_s / (ref_reads_per_s * n_proc), 3)
    out["pileup_ok"] = b.pileup_ok
    cpu_s = b.cpu_backend
    if cpu_s == cpu_s and cpu_s > 0:  # not NaN
        out["cpu_backend_reads_per_s"] = round(n / cpu_s, 1)
        if ours_best > 0:
            out["gpu_vs_cpu_backend"] = round(cpu_s / ours_best, 3)
    if deadline:
        out["deadline"] = True  # warm-up-only timing
    out["rounds"] = len(b.ours_rounds)
    out["ours_rounds_s"] = [round(t, 3) for t in b.ours_rounds]
    out["ref_rounds_s"] = [round(t, 3) for t in b.ref_rounds]
    if b.ref_par_rounds:
        out["ref_par_rounds_s"] = [round(t, 3) for t in b.ref_par_rounds]
    if b.warmup_s == b.warmup_s:
        out["warmup_s"] = round(b.warmup_s, 3)
    out["workdir"] = "tmpfs" if b.work.startswith("/dev/shm") else "disk"
    out["n_reads"] = n
    out["device"] = b.device
    out["device_name"] = b.device_name
    out["nvidia_smi"] = b.nvidia_smi
    print(json.dumps(out), flush=True)
    return out


def _flag_on(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    device = ap.parse_args(argv).device
    if cuda_missing(device, "bench"):
        return 1
    b = Bench.from_env(device)
    if device == "cuda":
        b.device_name, b.nvidia_smi = card_names()

    def alarm(signum, frame):
        """Hard deadline: report the best end-to-end timing observed so
        far — the warm-up run counts, pessimistically — so the caller
        always gets its JSON line."""
        ref_rps = (b.n_reads / b.ref) if b.ref == b.ref \
            and b.ref != float("inf") else BASELINE_READS_PER_S
        print(f"bench: HARD DEADLINE hit; reporting best-so-far "
              f"(ours {b.ours:.1f}s)", file=sys.stderr)
        emit_json(b, b.ours if b.ours != float("inf") else 0.0, ref_rps,
                  deadline=True)
        os._exit(0)

    old = signal.signal(signal.SIGALRM, alarm)
    signal.alarm(int(os.environ.get("RAFT_BENCH_HARD_S", "1200")))
    try:
        return _run(b)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _run(b: Bench) -> int:
    reads, paf = headline_dataset(b.work, b.n_reads)

    from raft_tpu_torch.params import AlgoParams
    from raft_tpu_torch.pipeline import run_pipeline

    params = AlgoParams(est_cov=20,
                        outputfilename=os.path.join(b.work, "ours"))

    def timed_run():
        _sync(b.device)
        t0 = time.perf_counter()
        st = run_pipeline(reads, paf, params, verbose=False,
                          device=b.device)
        _sync(b.device)
        return time.perf_counter() - t0, st

    # warm-up: absorbs the kernel build or load and the first CUDA
    # allocations; timed so a hard deadline still has an honest
    # (pessimistic) end-to-end number
    b.ours, st = timed_run()
    b.warmup_s = b.ours

    ref_bin = build_reference(b.work)
    ref_best = float("inf")
    ours_best = float("inf")
    best_stages = dict(st.stage_seconds)
    budget = float(os.environ.get("RAFT_BENCH_BUDGET_S", "180"))
    t_rounds = time.perf_counter()
    for _ in range(b.rounds):
        if ref_bin:
            ref_dt = run_reference_once(b, ref_bin, reads, paf)
            if ref_dt == ref_dt:
                b.ref_rounds.append(ref_dt)
            ref_best = min(ref_best, ref_dt)
            b.ref = ref_best
        dt, st = timed_run()
        b.ours_rounds.append(dt)
        if dt < ours_best:
            ours_best = dt
            best_stages = dict(st.stage_seconds)
        b.ours = min(b.ours, ours_best)
        # always complete at least one round; stop when over budget
        if time.perf_counter() - t_rounds > budget:
            break

    # the kernel against its plain twin, on the card, every run
    if _flag_on("RAFT_BENCH_PILEUP_CHECK"):
        try:
            b.pileup_ok = check_pileup_parity(reads, paf, b.device)
        except (RuntimeError, ValueError, TypeError) as e:
            print(f"bench: pileup parity check errored: {e}",
                  file=sys.stderr)
            b.pileup_ok = False

    # card-against-own-host ablation (a --device cpu subprocess)
    if b.device == "cuda" and _flag_on("RAFT_BENCH_CPU_ABLATION"):
        b.cpu_backend = run_cpu_backend(b, reads, paf)

    # thread-scaled reference baseline (nproc processes, sharded input)
    if ref_bin and _flag_on("RAFT_BENCH_PARALLEL_REF"):
        try:
            # best-of-2: single runs swing with VM CPU steal
            r1 = run_reference_parallel(b, ref_bin, reads, paf)
            r2 = run_reference_parallel(b, ref_bin, reads, paf)
            b.ref_par_rounds = [x for x in (r1, r2) if x == x]
            b.ref_par = min(b.ref_par_rounds, default=float("nan"))
        except (OSError, subprocess.SubprocessError) as e:
            print(f"bench: parallel-ref baseline failed: {e}",
                  file=sys.stderr)

    if ref_bin and ref_best == ref_best and ref_best != float("inf"):
        ref_reads_per_s = b.n_reads / ref_best
    else:
        ref_reads_per_s = BASELINE_READS_PER_S

    signal.alarm(0)  # single JSON line: never race the deadline handler
    # the warm-up timing counts as a (pessimistic) round
    ours_best = min(ours_best, b.ours)
    print("bench stages (best run): "
          + ", ".join(f"{k}={v:.3f}s" for k, v in best_stages.items()),
          file=sys.stderr)
    print(f"bench: ours {ours_best:.3f}s on {b.device}, reference(1t) "
          f"{ref_best:.3f}s, reference({os.cpu_count()}proc) "
          f"{b.ref_par:.3f}s on {b.n_reads} reads ({ref_reads_per_s:.0f} "
          "ref reads/s)", file=sys.stderr)
    emit_json(b, ours_best, ref_reads_per_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
