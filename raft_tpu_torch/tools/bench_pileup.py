"""Mirrors raft_tpu/tools/bench_pallas.py (renamed: the port has no
Pallas): the pileup kernel A/B on the card.

For every bucket of the headline benchmark's workload, as the engine
hands it to the device (``iter_buckets`` on the grouped events, then
``bucket_to_device``), this times the hand-written CUDA pileup kernel
(``ops/pileup_cuda.pileup``) against its plain PyTorch twin
(``pileup_torch``) on the same card tensors, and compares their outputs
exactly — the compiled-on-hardware correctness check the CPU tests
cannot give.

Timing discipline, as in the original: the two sides are INTERLEAVED
(plain, kernel, plain, kernel, …) over ``RAFT_AB_ROUNDS`` rounds (5) per
shape, after a warm-up of each, so machine drift hits both equally; the
per-round arrays and the spread ship in the JSON, and a "win" only
counts when it clears the measured spread of both sides. A sample is the
host wall of ``LAUNCHES`` back-to-back calls and one synchronize, over
``LAUNCHES``. The original's second bucketing (events padded to the
Pallas kernel's block) has no counterpart: both sides take the same
bucket. Every bucket goes through the kernel (no eligibility rule).

Usage::

    python -m raft_tpu_torch.tools.bench_pileup [n_reads] [--device {cuda,cpu}]

``--device cpu`` runs the harness on the CPU for the tests: both sides
are then the plain twin. Prints one JSON line; exits 1 unless every
shape's outputs are equal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from raft_tpu_torch.bench import (cuda_missing, env_reads, headline_buckets,
                                  headline_dataset, work_dir)

LAUNCHES = 20  # calls per timed sample


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=env_reads())
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if cuda_missing(a.device, "bench_pileup"):
        return 1
    import torch
    dev = torch.device(a.device)
    reads, paf = headline_dataset(work_dir(), a.n_reads)

    from raft_tpu_torch.engine_torch import bucket_to_device, derive_cfg
    from raft_tpu_torch.ops import pileup_cuda

    got = headline_buckets(reads, paf)
    if got is None:
        print(json.dumps({"error": "no native grouped events"}))
        return 1
    params, buckets = got

    rounds = int(os.environ.get("RAFT_AB_ROUNDS", "5"))

    def timed(fn):
        """Seconds per call over LAUNCHES back-to-back calls; the last
        call's output."""
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / LAUNCHES, out

    results = []
    for bk in buckets:
        cfg = derive_cfg(bk.B, bk.W, bk.E, params)
        _, ev_off, ev_pk = bucket_to_device(bk, cfg, dev)
        sides = {"plain": lambda: pileup_cuda.pileup_torch(ev_off, ev_pk,
                                                           cfg),
                 "kernel": lambda: pileup_cuda.pileup(ev_off, ev_pk, cfg)}
        out = {k: fn() for k, fn in sides.items()}  # warm-up
        times = {k: [] for k in sides}
        for _ in range(rounds):
            for k, fn in sides.items():
                dt, out[k] = timed(fn)
                times[k].append(dt)
        tp, tk = times["plain"], times["kernel"]
        p_min, k_min = min(tp), min(tk)
        # spread: relative wobble of each side's own rounds — the noise
        # bar a claimed win must clear
        p_spread = (max(tp) - p_min) / p_min if p_min else 0.0
        k_spread = (max(tk) - k_min) / k_min if k_min else 0.0
        speedup = p_min / k_min if k_min else 0.0
        row = {"B": bk.B, "W": bk.W, "E": bk.E, "n_used": bk.n_used,
               "wire": "pairs" if cfg.ev_pack == 0 else "pack32",
               "plain_s": p_min, "kernel_s": k_min,
               "plain_rounds_s": tp, "kernel_rounds_s": tk,
               "spread": round(max(p_spread, k_spread), 3),
               "kernel_speedup": round(speedup, 3),
               # win only if it clears BOTH sides' wobble
               "clears_spread": bool(speedup > 1.0 + max(p_spread,
                                                         k_spread)),
               "outputs_equal": bool(torch.equal(out["plain"],
                                                 out["kernel"]))}
        results.append(row)
        print(f"shape B={bk.B} W={bk.W} E={bk.E}: {row}", file=sys.stderr)

    all_equal = all(r["outputs_equal"] for r in results)
    wins = [r for r in results if r["clears_spread"]]
    print(json.dumps({
        "backend": a.device,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
        "rounds": rounds,
        "launches_per_sample": LAUNCHES,
        "n_shapes": len(results),
        "outputs_equal": all_equal,
        "kernel_wins_clearing_spread": len(wins),
        "shapes": results,
    }), flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
