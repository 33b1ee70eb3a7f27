"""The comparison's control: the plain reference put in the program's
place, computed one precision step below what the configurations state
(coverage held in int8, saturating at 127, everything downstream computed
from it), must come out as not correct.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>]

runs the harness at the cell's own size for each seed with the control in
the program's place, and prints one JSON line per seed with its ``correct``
and every number compared. The benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import mmap  # noqa: E402
import sys  # noqa: E402


def control_pass(cell, seed: int):
    """A pass function writing the control's four files (worked out once,
    on the first pass) into the pass's sinks."""
    from perfbench import gen, reference
    files: dict = {}

    def run(reads: str, paf: str, params):
        if not files:
            ds = gen.make_dataset(cell.config, cell.traffic, seed,
                                  with_genome=False)
            fl = reference.Flags.from_config(cell.config["raft_flags"],
                                             ds.est_cov)
            with open(reads, "rb") as f, \
                    mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ) as src:
                files.update(reference.expected_outputs(
                    ds, fl, src, cov_saturate=True)[0])
        for sfx, data in files.items():
            with open(params.outputfilename + sfx, "wb") as f:
                f.write(data)
        return None
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from perfbench import harness
    cell = harness.find_cell(a.workload)
    for seed in a.seeds:
        out = harness.run_cell(cell, seed, a.seconds, False,
                               time.perf_counter(), device=a.device,
                               pass_fn=control_pass(cell, seed))
        found = harness.forbidden_modules()
        if found:
            print("perfbench: the control's process has loaded "
                  + ", ".join(found), file=sys.stderr)
            return 2
        print(json.dumps({"control": a.workload, "seed": seed,
                          "correct": out.result["correct"],
                          "attempted": out.result["attempted"],
                          "checks": out.result["checks"]}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
