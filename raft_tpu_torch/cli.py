"""Command-line front end of the torch port: the reference flag surface of
``raft_tpu.cli`` (its ``parse_args`` and ``print_help``, reused as they
are) plus two options of its own, stripped before getopt sees them:

* ``--device {cuda,cpu}`` (default cuda): where the torch engine runs. A
  missing CUDA device is an error, never a quiet switch to the CPU.
* ``--engine {torch,oracle}`` (default torch).

``--trace DIR`` writes a ``torch.profiler`` Chrome trace into DIR. The
options of ``raft_tpu`` that this package does not carry yet
(``--devices``, ``--pallas``/``--no-pallas``) exit 1 with an error
instead of being ignored. stdout is line-identical to ``raft_tpu.cli``
apart from the wall-time and ``CMD:`` lines.
"""

from __future__ import annotations

import sys
import time

from raft_tpu.cli import parse_args, print_help
from raft_tpu.params import AlgoParams

_HELP = """
raft_tpu_torch extensions (not part of the reference surface):
  --device {cuda,cpu}     where the torch engine runs (default cuda;
                          no CUDA device is an error)
  --engine {torch,oracle} compute engine (default torch)
  --auto-e                estimate est_cov (-e) from the data
  --no-strict             drop out-of-bounds/unknown-read PAF rows
                          instead of erroring
  --pure-python-io        disable the native C++ I/O library
  --no-compat-getopt      -v no longer falls through to -o
  --profile               print per-stage timings
  --stats-json FILE       write machine-readable run stats
  --gz-out                write outputs BGZF-compressed (.gz)
  --chunk-reads N         stream the reads in chunks of N (0 = whole-file;
                          default: chunks of 32768 when an input is over
                          RAFT_AUTO_CHUNK_BYTES, 2 GB)
  --spill-paf / --no-spill-paf
                          in streaming mode, spill the PAF's coverage
                          events to per-chunk files (default: auto, PAF
                          > max(2 GiB, 15% of memory))
  --cov-out MODE          coverage return path: host (default; rebuilt
                          host-side, minimal D2H), diff8 (int8 diff
                          transfer), cov (full int32)
  --trace DIR             write a torch.profiler Chrome trace into DIR
Not yet supported (exit 1): --devices, --pallas/--no-pallas.
"""

_OWN = {"--device": ("cuda", "cpu"), "--engine": ("torch", "oracle")}


def _strip_own_options(argv: list[str]):
    """Remove ``--device``/``--engine`` (``--x V`` or ``--x=V``) from argv;
    returns ({option: value}, rest). Raises ValueError on a bad value."""
    got = {"--device": "cuda", "--engine": "torch"}
    rest: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        opt, sep, val = a.partition("=")
        if opt in _OWN:
            if not sep:
                if i + 1 >= len(argv):
                    raise ValueError(f"{opt} needs a value")
                i += 1
                val = argv[i]
            if val not in _OWN[opt]:
                raise ValueError(f"{opt} must be one of "
                                 f"{', '.join(_OWN[opt])} (got {val!r})")
            got[opt] = val
        else:
            rest.append(a)
        i += 1
    return got, rest


def _unsupported(extras: dict) -> list[str]:
    """The raft_tpu options in ``extras`` that this package does not carry
    yet."""
    bad = []
    if extras["devices"] is not None:
        bad.append("--devices")
    if extras["pallas"] is not None:
        bad.append("--pallas" if extras["pallas"] else "--no-pallas")
    return bad


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "--help-extended" in argv:
        print_help(AlgoParams())
        print(_HELP)
        raise SystemExit(0)
    try:
        own, rest = _strip_own_options(argv)
    except ValueError as e:
        print(f"ERROR, {e}", file=sys.stderr)
        return 1
    params, reads_path, paf_path, extras = parse_args(rest)
    bad = _unsupported(extras)
    if bad:
        print(f"ERROR, {bad[0]} is not yet supported by raft_tpu_torch",
              file=sys.stderr)
        return 1
    engine, device = own["--engine"], own["--device"]
    if engine == "torch" and device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("ERROR, --device cuda: no CUDA device is available "
                  "(pass --device cpu to run on the CPU)", file=sys.stderr)
            return 1

    if params.est_cov <= 0 and not extras["auto_e"]:
        print("ERROR, main(), estimated coverage must be set properly")
        print_help(params)
        raise SystemExit(1)

    for line in params.info_lines():
        if extras["auto_e"] and line.endswith("est_cov = 0"):
            line = line[:-1] + "auto"
        print(line)

    t0 = time.perf_counter()
    print("INFO, main(), started timer")

    from raft_tpu_torch import profiling
    from raft_tpu_torch.pipeline import run_pipeline
    try:
        (params.replace(est_cov=1) if extras["auto_e"] and
         params.est_cov <= 0 else params).validate()
    except ValueError as e:
        print(f"ERROR, {e}", file=sys.stderr)
        return 1
    try:
        with profiling.trace(extras["trace"], device):
            stats = run_pipeline(reads_path, paf_path, params, engine=engine,
                                 strict=extras["strict"],
                                 use_native=extras["use_native"],
                                 gz_out=extras["gz_out"],
                                 auto_e=extras["auto_e"], device=device,
                                 chunk_reads=extras["chunk_reads"],
                                 spill_paf=extras["spill_paf"],
                                 cov_out=extras["cov_out"])
    except ValueError as e:
        print(f"ERROR, {e}", file=sys.stderr)
        return 1

    wct = time.perf_counter() - t0
    print(f"INFO, main(), program completed after {wct:g} seconds")
    print("INFO, main(), CMD: raft " + " ".join(argv))
    if extras["profile"]:
        for k, v in stats.stage_seconds.items():
            print(f"PROFILE, {k}: {v:.4f} s")
    if extras["stats_json"]:
        import json
        with open(extras["stats_json"], "w") as f:
            json.dump(stats.to_json(), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
