"""Mirrors raft_tpu/tools/bench_cpu.py: the CPU ablation, the IDENTICAL
pipeline with ``--device cpu``, so the benchmark can publish the
card-against-its-own-host number beside the card-against-reference one.

``raft_tpu_torch.bench`` runs it as a subprocess, as ``bench.py`` runs
the original, so the measured process holds nothing of the parent's CUDA
context. Prints ONE line: min wall seconds over N runs (after one
warm-up run).

Usage: python -m raft_tpu_torch.tools.bench_cpu reads.fa ovl.paf outprefix [N]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    import time
    from raft_tpu_torch.params import AlgoParams
    from raft_tpu_torch.pipeline import run_pipeline

    reads, paf, out = argv[0], argv[1], argv[2]
    rounds = int(argv[3]) if len(argv) > 3 else 2
    params = AlgoParams(est_cov=20, outputfilename=out)
    run_pipeline(reads, paf, params, verbose=False, device="cpu")  # warm-up
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_pipeline(reads, paf, params, verbose=False, device="cpu")
        best = min(best, time.perf_counter() - t0)
    print(f"{best:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
