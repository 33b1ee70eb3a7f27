"""The benchmark's harness: reads ``BENCHMARK.json``, finds a cell's
configuration, traffic mix and per-layer metric readers by name, makes
the inputs from the seed, warms up, runs passes of the program for the
window, and judges every pass's output files against the plain reference.

A pass is one user invocation of the program:
``raft_tpu_torch.pipeline.run_pipeline(reads, paf, params,
device="cuda", verbose=False)`` with the program's own defaults (it picks
whole-file or streaming from the input size). The inputs are written
once, in set-up, as files under ``TMPDIR`` (a user's inputs are files; on
a sandboxed kernel such as gVisor, mapping a memfd's pages costs far more
than mapping a file's), gzip- or BGZF-compressed where the traffic mix
says so. Every pass writes its four outputs through
symlinks into fresh memfds (``/proc/self/fd/<n>``), so no pass's output
reaches the disk and every pass's bytes are still there to compare once
the window has closed.

A traffic mix, ``perfbench/traffic/<name>.json``, holds ``why``,
``n_reads``, ``expect`` (the ``schedule`` and ``n_chunks`` the program has
to take), and optionally ``inputs`` (``plain``, ``gzip`` or ``bgzf``) and
``config``: keys of the configuration that it sets for its cells, each
group whole. So a cell is added by files alone.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import gc
import importlib.util
import itertools
import json
import mmap
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from perfbench import gen, peaks, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate(bench: dict) -> None:
    """Names and units within the characters allowed, cells naming
    known configurations, metric ``workloads`` naming known cells."""
    def name(x, what):
        if not isinstance(x, str) or not NAME_RE.fullmatch(x):
            raise ValueError(f"bad {what} name {x!r}")
    cfgs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        name(c["name"], "config")
        for k in c["reduced"]:
            name(k, "reduced key")
    cells = {}
    for w in bench["workloads"]:
        name(w["name"], "cell")
        name(w["config"], "config")
        name(w["traffic"], "traffic")
        if w["config"] not in cfgs:
            raise ValueError(f"cell {w['name']} names unknown config")
        cells[w["name"]] = w
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        name(m["name"], "metric")
        if not UNIT_RE.fullmatch(m["unit"]):
            raise ValueError(f"bad unit {m['unit']!r} of {m['name']}")
        for w in m.get("workloads", []):
            if w not in cells:
                raise ValueError(f"{m['name']} names unknown cell {w}")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", []):
            if w not in moved.get("workloads", cells):
                raise ValueError(f"{m['name']} lists {w}, which does not "
                                 f"report {m['moves']}")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    validate(bench)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic",
                                     w["traffic"] + ".json"))
    # a traffic mix may set keys of the configuration (groups whole)
    over = traffic.get("config", {})
    unknown = set(over) - set(config)
    if unknown:
        raise ValueError(f"traffic {w['traffic']} sets keys that "
                         f"{cfg['name']} lacks: {sorted(unknown)}")
    config = {**config, **over}

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


def metric_reader(name: str, root: str = ROOT):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Sinks:
    """One pass's four output files: memfds behind symlinks named
    ``<dir>/out<suffix>``; the program opens, truncates and writes them
    as it would files."""

    def __init__(self, base: str, k: int):
        d = os.path.join(base, f"p{k}")
        os.mkdir(d)
        self.prefix = os.path.join(d, "out")
        self.fds = {}
        for sfx in reference.SUFFIXES:
            fd = gen.memfd("out" + sfx)
            os.symlink(gen.fd_path(fd), self.prefix + sfx)
            self.fds[sfx] = fd

    def mismatch(self, sfx: str, want: bytes) -> int | None:
        """First byte offset at which the file differs from ``want``
        (its length where one is a prefix of the other), None if equal."""
        fd = self.fds[sfx]
        size = os.fstat(fd).st_size
        n = min(size, len(want))
        bad = None
        if n:
            with mmap.mmap(fd, size, flags=mmap.MAP_SHARED | mmap.MAP_POPULATE,
                           prot=mmap.PROT_READ) as mm:
                bad = first_difference(mm, want, n)
        if bad is None and size != len(want):
            bad = n
        return bad

    def close(self) -> None:
        for fd in self.fds.values():
            os.close(fd)
        self.fds = {}


def first_difference(got, want, n: int) -> int | None:
    """First offset below ``n`` at which two buffers differ, or None;
    compared 8 bytes at a time, in slices, then byte by byte in the word
    that differs (or the tail)."""
    step = 1 << 23
    n8 = n // 8
    start = 8 * n8
    g = np.frombuffer(got, np.uint64, count=n8)
    w = np.frombuffer(want, np.uint64, count=n8)
    for lo in range(0, n8, step):
        if not np.array_equal(g[lo:lo + step], w[lo:lo + step]):
            k = lo + int(np.flatnonzero(g[lo:lo + step]
                                        != w[lo:lo + step])[0])
            start, n = 8 * k, 8 * k + 8
            break
    del g
    gb = np.frombuffer(got, np.uint8, count=n)[start:]
    d = np.flatnonzero(gb != np.frombuffer(want, np.uint8, count=n)[start:])
    del gb
    return start + int(d[0]) if len(d) else None


def program_pass(device: str):
    """The entry the window drives: one ``run_pipeline`` call with the
    program's defaults."""
    from raft_tpu_torch import pipeline

    def run(reads: str, paf: str, params):
        return pipeline.run_pipeline(reads, paf, params, device=device,
                                     verbose=False)
    return run


def algo_params(cfg: dict, est_cov: int, prefix: str):
    from raft_tpu_torch.params import AlgoParams
    f = cfg["raft_flags"]
    return AlgoParams(reso=f["r"], est_cov=est_cov, cov_mul=f["m"],
                      repeat_length=f["p"], interval_length=f["p"],
                      read_length=f["l"], overlap_length=f["v"],
                      flanking_length=f["f"], outputfilename=prefix)


def stats_record(st) -> dict:
    """The plain numbers of a pass's ``TorchRunStats`` (none where a
    stand-in for the program returned none)."""
    if st is None:
        return {}
    return {"stage_seconds": dict(st.stage_seconds),
            "schedule": st.schedule, "n_chunks": st.n_chunks,
            "launches": dict(st.launches)}


class PeakRSS:
    """The process's peak RSS over the window only: a thread reading
    ``/proc/self/statm`` every 5 ms from the window's start to its end."""

    def __init__(self):
        self._peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while not self._stop.wait(0.005):
            with open("/proc/self/statm") as f:
                self._peak = max(self._peak, int(f.read().split()[1]) * page)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return self._peak


def write_bytes() -> int:
    """Bytes this process sent to storage (``/proc/self/io``)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def nvidia_smi_start():
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def nvidia_smi_read(p) -> str:
    if p is None:
        return "nvidia-smi not found"
    try:
        out, _ = p.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        return "nvidia-smi timed out"
    return out.strip().replace("\n", " | ")


def forbidden_modules() -> list[str]:
    """Top-level names of JAX and the JAX package that this process has
    loaded (``raft_tpu_torch`` is another name)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    result: dict             # the last line
    info: list               # earlier stdout lines
    checks: list             # (name, value, limit), stderr's last lines


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", pass_fn=None,
             root: str = ROOT) -> Outcome:
    """One run of a cell. ``pass_fn(reads, paf, params)`` stands in for
    the program (the control and the fault tests); ``device`` "cpu" runs
    the program on the CPU for the tests."""
    info: list = []
    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    smi = nvidia_smi_start() if on_card else None
    import torch
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    t = time.perf_counter()
    if on_card and pass_fn is None:
        from raft_tpu_torch.io import native
        from raft_tpu_torch.ops import _lib
        _lib.get_lib()
        native._get_lib()
    build_s = time.perf_counter() - t
    if pass_fn is None:
        pass_fn = program_pass(device)

    base = tempfile.mkdtemp(prefix="perfbench-")
    try:
        reads_path = os.path.join(base, "reads.fasta")
        paf_path = os.path.join(base, "overlaps.paf")
        t = time.perf_counter()
        ds = gen.make_dataset(cfg, traffic, seed)
        with open(reads_path, "w+b") as f:
            fasta_bytes = gen.render_fasta(ds, f.fileno())
        with open(paf_path, "wb") as f:
            paf_bytes = gen.render_paf(ds, f.fileno())
        # the program reads these; the reference, the plain FASTA
        fmt = traffic.get("inputs", "plain")
        prog_reads, prog_paf = reads_path, paf_path
        if fmt != "plain":
            prog_reads, prog_paf = reads_path + ".gz", paf_path + ".gz"
            fasta_bytes = gen.compress_file(reads_path, prog_reads, fmt)
            paf_bytes = gen.compress_file(paf_path, prog_paf, fmt)
            os.unlink(paf_path)
        gen_s = time.perf_counter() - t
        total_bases, est_cov = ds.total_bases, ds.est_cov
        info.append(
            f"perfbench dataset: cell={cell.name} seed={seed} "
            f"reads={ds.n_reads} bases={total_bases} paf_rows={ds.n_rows} "
            f"inputs={fmt} fasta_bytes={fasta_bytes} paf_bytes={paf_bytes} "
            f"genome_slice={ds.genome_size} est_cov={est_cov} "
            f"repeat_families={len(ds.families)}")
        del ds
        gc.collect()

        sinks: list = []
        expect = traffic["expect"]
        chunk_trace = os.path.join(base, "chunks.jsonl") if trace else None
        if chunk_trace:
            os.environ["RAFT_CHUNK_TRACE"] = chunk_trace

        ids = itertools.count()

        def one_pass():
            s = Sinks(base, next(ids))
            sinks.append(s)
            params = algo_params(cfg, est_cov, s.prefix)
            return stats_record(pass_fn(prog_reads, prog_paf, params))

        def schedule_ok(rec):
            # a stand-in for the program (the control) reports no schedule
            return ("schedule" not in rec
                    or (rec["schedule"] == expect["schedule"]
                        and rec["n_chunks"] == expect["n_chunks"]))

        t = time.perf_counter()
        warm = one_pass()
        warm_s = time.perf_counter() - t
        warm_sink = sinks.pop()
        warm_sink.close()
        gc.collect()

        passes: list = []
        failed_passes = 0
        wb0 = write_bytes()
        rss = PeakRSS()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        t1 = t0
        while t1 - t0 < seconds:
            p0 = time.perf_counter()
            try:
                rec = one_pass()
            except Exception:
                traceback.print_exc()
                failed_passes += 1
                sinks.pop().close()
                rec = None
            t1 = time.perf_counter()
            if rec is None:
                break
            rec["wall_s"] = t1 - p0
            if chunk_trace and os.path.exists(chunk_trace):
                with open(chunk_trace) as f:
                    rec["chunks"] = [json.loads(x) for x in f]
            passes.append(rec)
        window_s = t1 - t0
        peak_rss = rss.stop()
        wb1 = write_bytes()
        smi_after = nvidia_smi_start() if on_card else None

        prof = None
        if trace:
            rec, prof = devtrace_pass(one_pass, on_card)
            passes_prof = [rec]
        else:
            passes_prof = []
        mem_peak = torch.cuda.max_memory_allocated() if on_card else 0

        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # the reference, once the window has closed
        t = time.perf_counter()
        ds = gen.make_dataset(cfg, traffic, seed, with_genome=False)
        fl = reference.Flags.from_config(cfg["raft_flags"], est_cov)
        with open(reads_path, "rb") as f, \
                mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ) as src:
            want, work = reference.expected_outputs(ds, fl, src)
        ref_s = time.perf_counter() - t
        t = time.perf_counter()
        bad = {sfx: 0 for sfx in reference.SUFFIXES}
        bad_pass = [False] * len(sinks)
        jobs = [(k, sfx) for k in range(len(sinks))
                for sfx in reference.SUFFIXES]
        with cf.ThreadPoolExecutor(8) as ex:
            offs = list(ex.map(lambda j: sinks[j[0]].mismatch(j[1],
                                                              want[j[1]]),
                               jobs))
        for (k, sfx), off in zip(jobs, offs):
            if off is not None:
                bad[sfx] += 1
                bad_pass[k] = True
                if bad[sfx] <= 3:
                    print(f"perfbench: pass {k} {sfx} differs from the "
                          f"reference from byte {off}", file=sys.stderr)
        cmp_s = time.perf_counter() - t
        sched_bad = sum(not schedule_ok(r)
                        for r in [warm] + passes + passes_prof)
        del want
    finally:
        for s in sinks:
            s.close()
        shutil.rmtree(base, ignore_errors=True)
        if chunk_trace:
            os.environ.pop("RAFT_CHUNK_TRACE", None)

    n_done = len(passes)
    attempted = n_done + failed_passes + len(passes_prof)
    failed = failed_passes + sum(bad_pass)
    checks = [(f"{sfx.lstrip('.').replace('.', '_')}_bad_passes", bad[sfx], 0)
              for sfx in reference.SUFFIXES]
    checks += [("schedule_bad_passes", sched_bad, 0),
               ("failed_passes", failed, 0)]
    correct = all(v <= lim for _, v, lim in checks) and n_done > 0

    walls = [round(r["wall_s"], 4) for r in passes]
    launches = passes[0].get("launches", {}) if passes else {}
    info += [
        f"perfbench card: {kind}; nvidia-smi before the window: "
        f"{nvidia_smi_read(smi)}; after: {nvidia_smi_read(smi_after)}",
        f"perfbench setup: setup_s={setup_s} build_s={build_s} "
        f"gen_s={gen_s} warm_s={warm_s}",
        f"perfbench schedule: expected {expect['schedule']} x "
        f"{expect['n_chunks']}; warm pass {warm.get('schedule')} x "
        f"{warm.get('n_chunks')}",
        f"perfbench window: passes={n_done} window_s={window_s} "
        f"pass_walls_s={walls}",
        f"perfbench launches per pass: {launches}",
        f"perfbench stage seconds per pass (mean over the window): "
        f"{stage_means(passes)}",
        f"perfbench bytes written to storage in the window: {wb1 - wb0}",
        f"perfbench reference: reference_s={ref_s} compare_s={cmp_s} "
        f"passes_compared={len(sinks)} work={dataclasses.asdict(work)}",
    ]

    metrics: dict = {}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {
            "mbp_per_s": n_done * total_bases / 1e6 / window_s
            if n_done else None,
            "peak_rss_mb": peak_rss / 1e6,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": units[m["name"]]}
    else:
        data = TraceData(passes=passes, gbp=total_bases / 1e9,
                         profile=prof, work=work)
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        if prof is not None:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
            nb, ops = peaks.device_step_work(**dataclasses.asdict(work))
            least, bound = peaks.least_seconds(nb, ops)
            info.append(
                f"perfbench profiled pass: window_s={prof['window_s']} "
                f"busy_s={prof['busy_s']} kernel_s={prof['kernel_s']} "
                f"device_ops={prof['n_device_ops']}; device step least "
                f"time {least} s ({bound} bound: {nb} bytes at "
                f"{peaks.HBM_BYTES_S:g} B/s, {ops} int32 ops at "
                f"{peaks.INT32_OPS_S:g}/s, rates at 700 W; card above)")
        if passes and passes[0].get("chunks"):
            info.append("perfbench chunk trace of the last window pass: "
                        + json.dumps(passes[-1]["chunks"]))
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return Outcome(result, info, checks)


def stage_means(passes: list) -> dict:
    keys = sorted({k for p in passes for k in p.get("stage_seconds", {})})
    return {k: round(sum(p["stage_seconds"].get(k, 0.0) for p in passes)
                     / len(passes), 4) for k in keys}


def devtrace_pass(one_pass, on_card: bool):
    """The traced run's profiled pass (after the window)."""
    if not on_card:
        return one_pass(), None
    from perfbench import devtrace
    return devtrace.profile_pass(one_pass)


@dataclasses.dataclass
class TraceData:
    """What a per-layer metric reader sees: the traced window's passes
    (``stage_seconds``, ``schedule``, ``n_chunks``, and in the streaming
    schedule ``chunks``, the program's per-chunk trace), the input Gbp of
    one pass, the profiled pass's summary (``devtrace.summarize``; None
    off the card) and the reference's work count."""
    passes: list
    gbp: float
    profile: dict | None
    work: reference.Work

    def s_per_gbp(self, *stages: str) -> float | None:
        if not self.passes:
            return None
        secs = [sum(p["stage_seconds"].get(s, 0.0) for s in stages)
                for p in self.passes]
        if not any(secs):
            return None
        return sum(secs) / (self.gbp * len(self.passes))
