"""Command-line front end of the torch port: the reference flag surface of
``raft_tpu.cli`` (its ``parse_args`` and ``print_help`` with their
helpers, copied below unchanged) plus two options of its own, stripped
before getopt sees them:

* ``--device {cuda,cpu}`` (default cuda): where the torch engine runs. A
  missing CUDA device is an error, never a quiet switch to the CPU.
* ``--engine {torch,jax,oracle}`` (default torch). ``jax``, ``raft_tpu``'s
  name for its device engine and its default, is taken as the port's
  device engine, the torch engine, so a ``raft_tpu`` command line runs
  unchanged.

``--trace DIR`` writes a ``torch.profiler`` Chrome trace into DIR, the
run's host spans (``profiling``) on its clock. ``--profile`` prints the
stage seconds and, when the run recorded spans (``RAFT_SPANS=1``), their
seconds by name and the counters; ``--stats-json`` holds both.
``--devices N`` shards the reads over ``parallel.mesh.make_devices(N,
--device)``: the first N cards (fewer if fewer exist), or N shards on the
CPU; 0 runs unsharded. ``--pallas``/``--no-pallas`` are accepted and
change nothing: there is one pileup, the CUDA kernel on ``--device cuda``
and its plain twin on ``--device cpu``, as ``raft_tpu`` runs its one
scatter pileup either way off a TPU. ``--cov-out host|diff8|cov`` is
accepted too and gives the same bytes in every mode, since the port
renders the coverage on the host; another value is refused where the
torch engine would start. stdout is line-identical to
``raft_tpu.cli`` apart from the wall-time and ``CMD:`` lines.
"""

from __future__ import annotations

import re
import sys
import time

from raft_tpu_torch.params import AlgoParams

# ---------------------------------------------------------------------------
# Copied from raft_tpu/cli.py unchanged: the reference flag surface.
# ---------------------------------------------------------------------------

def _atoi(s: str) -> int:
    m = re.match(r"\s*[+-]?[0-9]*", s)
    tok = m.group(0).strip() if m else ""
    try:
        return int(tok)
    except ValueError:
        return 0


_STOD_RE = re.compile(
    r"\s*[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?")


def _stod(s: str) -> float:
    m = _STOD_RE.match(s)
    if not m or not m.group(0).strip():
        raise ValueError(f"stod: cannot parse {s!r}")
    return float(m.group(0))


def print_help(params: AlgoParams, out=None) -> None:
    out = out if out is not None else sys.stdout
    cm = f"{params.cov_mul:g}"
    out.write("Usage: raft [options] <input-reads.fa> <in.paf>\n")
    out.write(f"  -r NUM     resolution of coverage {params.reso}\n")
    out.write("  -e NUM     estimated coverage \n")
    out.write(f"  -m NUM     coverage multiplier {cm}\n")
    out.write(f"  -l NUM     read_length {params.read_length}\n")
    out.write(f"  -v NUM     overlap_length {params.overlap_length}\n")
    out.write(f"  -p NUM     repeat_length {params.repeat_length}\n")
    out.write(f"  -f NUM     flanking_length {params.flanking_length}\n")
    out.write(f"  -o FILE    prefix of output files {params.outputfilename}\n")


def _gnu_getopt(argv: list[str], optstring: str):
    """Minimal GNU getopt: returns (opts, positionals) or raises ValueError
    on an unknown option. Supports joined (-e42) and separate (-e 42)
    arguments, argument permutation, and ``--`` terminator."""
    takes_arg = {optstring[i]: (i + 1 < len(optstring) and optstring[i + 1] == ":")
                 for i in range(len(optstring)) if optstring[i] != ":"}
    opts: list[tuple[str, str]] = []
    pos: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--":
            pos.extend(argv[i + 1:])
            break
        if len(a) >= 2 and a[0] == "-" and a != "-":
            j = 1
            while j < len(a):
                c = a[j]
                if c not in takes_arg:
                    raise ValueError(c)
                if takes_arg[c]:
                    if j + 1 < len(a):
                        opts.append((c, a[j + 1:]))
                    else:
                        i += 1
                        if i >= len(argv):
                            raise ValueError(c)
                        opts.append((c, argv[i]))
                    break
                opts.append((c, ""))
                j += 1
        else:
            pos.append(a)
        i += 1
    return opts, pos


def parse_args(argv: list[str], compat_getopt: bool = True):
    """Parse reference-surface args; returns (params, reads, paf, extras)."""
    params = AlgoParams()
    extras = {"engine": "jax", "strict": True, "use_native": None,
              "profile": False, "pallas": None, "stats_json": None,
              "chunk_reads": None, "devices": None, "spill_paf": None,
              "gz_out": False, "cov_out": None, "trace": None,
              "auto_e": False}

    # Strip rebuild-only long options first (they are NOT part of the
    # reference surface and must not disturb getopt compat).
    rest: list[str] = []
    skip = False
    for i, a in enumerate(argv):
        if skip:
            skip = False
            continue
        if a == "--engine":
            extras["engine"] = argv[i + 1]
            skip = True
        elif a.startswith("--engine="):
            extras["engine"] = a.split("=", 1)[1]
        elif a == "--no-strict":
            extras["strict"] = False
        elif a == "--auto-e":
            extras["auto_e"] = True
        elif a == "--pure-python-io":
            extras["use_native"] = False
        elif a == "--profile":
            extras["profile"] = True
        elif a == "--pallas":
            extras["pallas"] = True
        elif a == "--no-pallas":
            extras["pallas"] = False
        elif a == "--stats-json":
            extras["stats_json"] = argv[i + 1]
            skip = True
        elif a == "--chunk-reads":
            extras["chunk_reads"] = int(argv[i + 1])
            skip = True
        elif a.startswith("--chunk-reads="):
            extras["chunk_reads"] = int(a.split("=", 1)[1])
        elif a == "--gz-out":
            extras["gz_out"] = True
        elif a == "--cov-out":
            extras["cov_out"] = argv[i + 1]
            skip = True
        elif a.startswith("--cov-out="):
            extras["cov_out"] = a.split("=", 1)[1]
        elif a == "--trace":
            extras["trace"] = argv[i + 1]
            skip = True
        elif a.startswith("--trace="):
            extras["trace"] = a.split("=", 1)[1]
        elif a == "--spill-paf":
            extras["spill_paf"] = True
        elif a == "--no-spill-paf":
            extras["spill_paf"] = False
        elif a == "--devices":
            extras["devices"] = int(argv[i + 1])
            skip = True
        elif a.startswith("--devices="):
            extras["devices"] = int(a.split("=", 1)[1])
        elif a.startswith("--stats-json="):
            extras["stats_json"] = a.split("=", 1)[1]
        elif a == "--no-compat-getopt":
            compat_getopt = False
        elif a in ("--help-extended", "--help"):
            print_help(params)
            print(
                "\nraft_tpu extensions (not part of the reference surface):\n"
                "  --engine {jax,oracle}   compute engine (default jax)\n"
                "  --pallas / --no-pallas  force the Pallas MXU pileup\n"
                "                          kernel on/off (default: per-\n"
                "                          bucket auto policy on TPU)\n"
                "  --auto-e                estimate est_cov (-e) from the\n"
                "                          data (median per-window pileup\n"
                "                          coverage + safety bias; see\n"
                "                          EVAL.md) — -e becomes optional\n"
                "  --no-strict             drop out-of-bounds/unknown-read\n"
                "                          PAF rows instead of erroring\n"
                "  --pure-python-io        disable the native C++ I/O library\n"
                "  --no-compat-getopt      -v no longer falls through to -o\n"
                "  --profile               print per-stage timings\n"
                "  --trace DIR             capture a JAX profiler trace of\n"
                "                          the run into DIR (view with\n"
                "                          TensorBoard / xprof)\n"
                "  --stats-json FILE       write machine-readable run stats\n"
                "  --chunk-reads N         streaming mode: bound memory by\n"
                "                          processing N reads at a time\n"
                "                          (auto for inputs over 2 GB —\n"
                "                          RAFT_AUTO_CHUNK_BYTES tunes,\n"
                "                          N=0 forces whole-file)\n"
                "  --spill-paf             with --chunk-reads: spill PAF\n"
                "                          events to disk per chunk instead\n"
                "                          of keeping rows resident (auto\n"
                "                          when the PAF would pressure RAM:\n"
                "                          > max(2 GiB, 15% of memory))\n"
                "  --devices N             shard_map data parallelism over\n"
                "                          the first N local devices\n"
                "  --gz-out                write outputs BGZF-compressed\n"
                "                          (.gz; block-parallel deflate,\n"
                "                          zcat/bgzip/htslib-readable;\n"
                "                          level via RAFT_GZ_LEVEL)\n"
                "  --cov-out MODE          coverage return path: host\n"
                "                          (default; rebuilt host-side,\n"
                "                          minimal D2H), diff8 (int8 diff\n"
                "                          transfer), cov (full int32)\n"
                "\nAdvisories: when the observed coverage/window is far\n"
                "from the supplied -e (the est_cov mis-specification the\n"
                "EVAL.md sweep quantifies), a HINT is printed on stderr;\n"
                "RAFT_NO_HINTS=1 silences it. stdout always stays\n"
                "line-identical to the reference.\n")
            raise SystemExit(0)
        else:
            rest.append(a)

    try:
        opts, pos = _gnu_getopt(rest, "r:e:m:l:i:p:f:v:o:")
    except ValueError:
        print_help(params)
        raise SystemExit(1)

    kw: dict = {}
    for flag, val in opts:
        if flag == "r":
            kw["reso"] = _atoi(val)
        elif flag == "e":
            kw["est_cov"] = _atoi(val)
        elif flag == "m":
            kw["cov_mul"] = _stod(val)
        elif flag == "l":
            kw["read_length"] = _atoi(val)
        elif flag == "p":
            kw["repeat_length"] = _atoi(val)
            kw["interval_length"] = _atoi(val)
        elif flag == "f":
            kw["flanking_length"] = _atoi(val)
        elif flag == "v":
            kw["overlap_length"] = _atoi(val)
            if compat_getopt:
                # reference fallthrough: -v also sets the output prefix
                kw["outputfilename"] = val
        elif flag == "o":
            kw["outputfilename"] = val
        elif flag == "i":
            # in the getopt string but no case → default: → help + exit(1)
            print_help(params)
            raise SystemExit(1)
    params = params.replace(**kw)

    if len(pos) < 2:
        print_help(params)
        raise SystemExit(1)
    return params, pos[0], pos[1], extras



# ---------------------------------------------------------------------------
# The torch port's own options and entry point
# ---------------------------------------------------------------------------

_HELP = """
raft_tpu_torch extensions (not part of the reference surface):
  --device {cuda,cpu}     where the torch engine runs (default cuda;
                          no CUDA device is an error)
  --engine {torch,jax,oracle}
                          compute engine (default torch); jax, raft_tpu's
                          name for its device engine, runs the torch
                          engine
  --auto-e                estimate est_cov (-e) from the data
  --no-strict             drop out-of-bounds/unknown-read PAF rows
                          instead of erroring
  --pure-python-io        disable the native C++ I/O library
  --no-compat-getopt      -v no longer falls through to -o
  --profile               print per-stage timings (with RAFT_SPANS=1,
                          also the spans by name and the counters)
  --stats-json FILE       write machine-readable run stats
  --gz-out                write outputs BGZF-compressed (.gz)
  --chunk-reads N         stream the reads in chunks of N (0 = whole-file;
                          default: chunks of 32768 when an input is over
                          RAFT_AUTO_CHUNK_BYTES, 2 GB)
  --spill-paf / --no-spill-paf
                          in streaming mode, spill the PAF's coverage
                          events to per-chunk files (default: auto, PAF
                          > max(2 GiB, 15% of memory))
  --cov-out MODE          host, diff8 or cov, accepted for raft_tpu
                          command lines: the port renders the coverage on
                          the host in every mode, and the three give the
                          same bytes (any other value is refused)
  --trace DIR             write a torch.profiler Chrome trace, with the
                          run's host spans, into DIR
  --devices N             shard the reads over the first N CUDA devices
                          (N shards with --device cpu; 0 = unsharded)
  --pallas / --no-pallas  accepted for raft_tpu command lines; both run
                          the one pileup (the CUDA kernel on the card)
"""

_OWN = {"--device": ("cuda", "cpu"), "--engine": ("torch", "jax", "oracle")}
# raft_tpu's engine names -> the port's: its device engine is the torch one
_ENGINE = {"jax": "torch"}


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
    engine = _ENGINE.get(own["--engine"], own["--engine"])
    device = own["--device"]
    if engine == "torch" and device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("ERROR, --device cuda: no CUDA device is available "
                  "(pass --device cpu to run on the CPU)", file=sys.stderr)
            return 1
    devices = None
    if extras["devices"] and engine == "torch":
        from raft_tpu_torch.parallel.mesh import make_devices
        try:
            devices = make_devices(extras["devices"], device)
        except ValueError as e:
            print(f"ERROR, {e}", file=sys.stderr)
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
                                 cov_out=extras["cov_out"], devices=devices)
    except ValueError as e:
        print(f"ERROR, {e}", file=sys.stderr)
        return 1

    wct = time.perf_counter() - t0
    print(f"INFO, main(), program completed after {wct:g} seconds")
    print("INFO, main(), CMD: raft " + " ".join(argv))
    if extras["profile"]:
        for k, v in stats.stage_seconds.items():
            print(f"PROFILE, {k}: {v:.4f} s")
        for k, (v, n) in profiling.span_seconds(stats.spans).items():
            print(f"PROFILE, span {k}: {v:.4f} s in {n}")
        for k, v in sorted(stats.counters.items()):
            print(f"PROFILE, counter {k}: {v}")
    if extras["stats_json"]:
        import json
        with open(extras["stats_json"], "w") as f:
            json.dump(stats.to_json(), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
