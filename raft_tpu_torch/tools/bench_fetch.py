"""Mirrors raft_tpu/tools/bench_fetch.py: the transfer decomposition of
the engine's per-bucket loop on the card.

``compute_torch`` once spent its ``h2d`` and ``step`` stages moving
bucket inputs to the card and packed results back (pageable copies, one
bucket at a time); since its inputs are gathered on the card from one
copy of the event table (``ops.gather_cuda``), only the D2H half of that
is the engine's. This tool separates that wall into its physical parts, on
the workload of the headline benchmark (``cov_out="host"``: the packed
``[B, 2K+2F+5]`` int32 array is the only D2H):

* ``rpc_floor_ms``   — D2H of a 4-byte tensor (the copy's fixed cost)
* ``bw_mb_s``        — D2H of one 8 MB tensor into pageable memory, as
                       ``compute_torch`` copies
* ``h2d_bytes``, ``h2d_s``, ``h2d_mb_s`` — every bucket's inputs, built
                       on the host (``host_inputs``), moved to the card
                       array by array
* ``exec_s``         — every bucket's ``device_step`` on inputs already
                       on the card, then one synchronize, no D2H
* ``fetch_w{N}_s``   — D2H of every (already computed) packed output
                       with N threads
* ``fetch_batched_s``— every D2H issued back to back (non-blocking), then
                       one synchronize
* ``engine_like_s``  — ``compute_torch``'s device path: the partition
                       (``plan_steps``), the grouped table's copy, the
                       gather, then step and D2H bucket by bucket
                       (``run_shards`` over the one device)
* ``n_buckets``, ``d2h_bytes``, ``d2h_floor_s`` (the D2H bytes over
                       ``bw_mb_s``)

Each time is the minimum of 3 runs after a warm-up (20 for
``rpc_floor_ms``), unrounded. ``RAFT_FORCE_CPU`` of
the original is ``--device cpu`` here (the tests' path: every copy is
then a host copy, and the numbers are not device numbers).

Usage::

    python -m raft_tpu_torch.tools.bench_fetch [n_reads] [--device {cuda,cpu}]

``n_reads`` defaults to ``RAFT_BENCH_READS`` or 32000; the dataset lives
under ``RAFT_BENCH_DIR`` (default ``raft_bench`` under the temporary
directory), shared with ``raft_tpu_torch.bench``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

from raft_tpu_torch.bench import (cuda_missing, env_reads, headline_dataset,
                                  headline_table, work_dir)


def _best(fn, n: int = 3) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=env_reads())
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if cuda_missing(a.device, "bench_fetch"):
        return 1
    import torch
    dev = torch.device(a.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    reads, paf = headline_dataset(work_dir(), a.n_reads)

    import concurrent.futures as cf

    import numpy as np

    from raft_tpu_torch import bucketing
    from raft_tpu_torch.engine_torch import (derive_cfg, device_step,
                                             host_inputs, packed_width,
                                             plan_steps)
    from raft_tpu_torch.ops import gather_cuda
    from raft_tpu_torch.parallel.mesh import run_shards

    res = {"backend": a.device, "n_reads": a.n_reads,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else None)}

    # --- link microbenchmarks -------------------------------------------
    tiny = torch.zeros((1,), dtype=torch.int32, device=dev)
    sync()
    res["rpc_floor_ms"] = _best(tiny.cpu, 20) * 1e3
    big = torch.zeros((2 << 20,), dtype=torch.int32, device=dev)  # 8 MB
    sync()
    res["bw_mb_s"] = round(8.0 * 2**20 / 1e6 / _best(big.cpu), 1)

    # --- real workload buckets ------------------------------------------
    got = headline_table(reads, paf)
    if got is None:
        print(json.dumps({"error": "no native grouped events"}))
        return 1
    params, lens, grouped = got
    buckets = bucketing.iter_buckets(lens, None, None, None, params.reso,
                                     prebinned=grouped)
    prepared = []
    d2h_bytes = h2d_bytes = 0
    for bk in buckets:
        cfg = derive_cfg(bk.B, bk.W, bk.E, params, cov_out="host")
        host = host_inputs(bk, cfg)
        prepared.append((cfg, host))
        h2d_bytes += sum(x.nbytes for x in host)
        d2h_bytes += bk.B * packed_width(cfg) * 4
    res["n_buckets"] = len(prepared)
    res["d2h_bytes"] = d2h_bytes
    res["d2h_floor_s"] = d2h_bytes / 1e6 / res["bw_mb_s"]
    res["h2d_bytes"] = h2d_bytes

    def to_device():
        out = [(cfg, tuple(torch.from_numpy(x).to(dev) for x in host))
               for cfg, host in prepared]
        sync()
        return out

    on_dev = to_device()  # warm-up
    res["h2d_s"] = _best(to_device)
    res["h2d_mb_s"] = round(h2d_bytes / 1e6 / res["h2d_s"], 1)

    def dispatch_all():
        return [device_step(*args, cfg=cfg)["packed"] for cfg, args in on_dev]

    dispatch_all()  # warm-up: kernel build or load, first allocations
    sync()

    # exec-only: results stay on the device
    res["exec_s"] = _best(lambda: (dispatch_all(), sync()))

    # fetch-only at thread counts (outputs already computed on the device)
    outs = dispatch_all()
    sync()
    for nw in (1, 2, 4, 8):
        def fetch(nw=nw):
            with cf.ThreadPoolExecutor(max_workers=nw) as ex:
                list(ex.map(torch.Tensor.cpu, outs))
        res[f"fetch_w{nw}_s"] = _best(fetch)

    # every D2H issued back to back, one synchronize
    res["fetch_batched_s"] = _best(lambda: (
        [o.to("cpu", non_blocking=True) for o in outs], sync()))

    # the engine's device path: partition, the table's copy, one gather,
    # then step and D2H bucket by bucket
    def engine_like():
        planned = list(plan_steps(lens, np.diff(grouped[0]), params,
                                  cov_out="host"))
        table, _ = gather_cuda.upload_table(*grouped, lens, dev)
        plan = gather_cuda.GatherPlan([st for _, _, (st,) in planned])
        arena = gather_cuda.gather(table, plan)
        return [run_shards([gather_cuda.views(arena, plan, i)], cfg)
                for i, (_, cfg, _) in enumerate(planned)]

    engine_like()
    res["engine_like_s"] = _best(engine_like)

    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
