"""The benchmark of ``raft_tpu_torch`` on one NVIDIA GPU.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (timed as ``setup_s``): torch and the
card, the program's kernel and I/O libraries (built only on a checkout's
first run), the cell's inputs from the seed, one warm pass. Then passes
back to back until ``--seconds`` have elapsed (the pass in flight at the
deadline completes and counts), then the plain reference and the
comparison of every pass's four output files. The last line of standard
output is the result; ``--trace 1`` reports the per-layer metrics from the
same kind of window, plus one profiled pass after it.

Exits 2, printing no result, without a CUDA device, or where the run's
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from perfbench import harness
    cell = harness.find_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), T_START)
    for line in out.info:
        print(line)
    found = harness.forbidden_modules()
    if found:
        print("perfbench: the run's process has loaded "
              + ", ".join(found), file=sys.stderr)
        return 2
    for name, value, limit in out.checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out.result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
