"""raft_tpu_torch.cli against raft_tpu.cli on the tests/datagen.py
fixtures: the four output files byte-equal and stdout line-equal (apart
from the wall-time and CMD lines), plus the port's own CLI rules. Outputs
are compared as bytes: the tolerance is exact equality."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import cli as tpu_cli  # noqa: E402
from raft_tpu_torch import cli as port_cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
ARGS = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000", "-f", "300",
        "-v", "200"]
# The schedules a run can take: whole-file, chunked, chunked with the PAF
# spilled
SCHEDULES = {"whole": [], "chunk7": ["--chunk-reads", "7"],
             "spill": ["--chunk-reads", "7", "--spill-paf"]}
# An import of jax or of raft_tpu (not raft_tpu_torch), at any indentation.
PORT_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                         r"import\s+raft_tpu(?!\w)|from\s+raft_tpu(?!\w))",
                         re.M)
# A quoted module name of raft_tpu (not raft_tpu_torch), as a subprocess's
# "-m" argument names it.
PORT_LAUNCH = re.compile(r"""["']raft_tpu\.""")


def _run(main, args, cwd, capsys):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        try:
            rc = main(args)
        except SystemExit as e:
            rc = e.code
    finally:
        os.chdir(old)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _norm(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("INFO, main(), program completed"):
            ln = "TIME"
        elif ln.startswith("INFO, main(), CMD:"):
            ln = "CMD"
        out.append(ln)
    return out


def _assert_same_run(tmp_path, capsys, args, extra=(), sfx=""):
    """Both CLIs on the same inputs; files byte-equal, stdout equal."""
    a = _run(tpu_cli.main, [*args, *extra, "-o", "tpu"], tmp_path, capsys)
    b = _run(port_cli.main, [*args, *extra, "-o", "port", "--device", "cpu"],
             tmp_path, capsys)
    assert a[0] == b[0] == 0, (a[2], b[2])
    assert _norm(a[1]) == _norm(b[1])
    for ext in OUTS:
        want = (tmp_path / f"tpu{ext}{sfx}").read_bytes()
        got = (tmp_path / f"port{ext}{sfx}").read_bytes()
        assert got == want, ext
    return b


def _inputs(tmp_path, kind, seed):
    """A 25-read ``datagen.standard_case`` fixture: ``plain``, one of its
    modes (``simulated``, ``gz``, ...), or ``bgzf``, the plain case's
    reads and PAF rewritten as BGZF in 4 KiB blocks."""
    mode = {} if kind in ("plain", "bgzf") else {kind: True}
    reads, paf = datagen.standard_case(seed=seed, tmpdir=str(tmp_path),
                                       n_reads=25, **mode)
    if kind != "bgzf":
        return reads, paf
    for path in (reads, paf):
        with open(path, "rb") as f:
            datagen.write_bgzf(path + ".gz", f.read(), block=4096)
    return reads + ".gz", paf + ".gz"


@pytest.mark.parametrize("kind,schedule", [
    pytest.param(kind, schedule, id="-".join(
        ({"plain": "real"}.get(kind, kind),)
        + ((schedule,) if schedule != "whole" else ())))
    for kind in ("plain", "simulated", "symmetric", "gz", "fastq",
                 "multiline", "bgzf")
    for schedule in SCHEDULES])
def test_outputs_byte_equal(tmp_path, capsys, kind, schedule):
    """Every input kind in every schedule: files byte-equal and stdout
    line-equal to raft_tpu.cli with the same flags."""
    reads, paf = _inputs(tmp_path, kind, seed=11)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=SCHEDULES[schedule])


def test_auto_e_byte_equal(tmp_path, capsys):
    reads, paf = datagen.standard_case(seed=31, tmpdir=str(tmp_path),
                                       n_reads=25)
    args = [a for a in ARGS if a not in ("-e", "10")]
    _, _, err = _assert_same_run(tmp_path, capsys, [*args, reads, paf],
                                 extra=["--auto-e"])
    assert "--auto-e estimated est_cov" in err


def test_gz_out_byte_equal(tmp_path, capsys):
    reads, paf = datagen.standard_case(seed=12, tmpdir=str(tmp_path),
                                       n_reads=25, simulated=True)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=["--gz-out"], sfx=".gz")


def test_no_strict_byte_equal(tmp_path, capsys):
    """A PAF row naming a read absent from the FASTA: both CLIs refuse it
    with rc 1 in strict mode and drop it identically with --no-strict."""
    reads, paf = datagen.standard_case(seed=13, tmpdir=str(tmp_path),
                                       n_reads=25)
    with open(paf, "a") as f:
        f.write("ghost\t5000\t10\t900\t+\tr00001\t5000\t0\t890\t880\t890\t"
                "cm:i:1\n")
    for main, extra in ((tpu_cli.main, []),
                        (port_cli.main, ["--device", "cpu"])):
        rc, _, err = _run(main, [*ARGS, *extra, "-o", "s", reads, paf],
                          tmp_path, capsys)
        assert rc == 1 and "absent from the input FASTA" in err
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=["--no-strict"])


def test_pure_python_io_and_oracle_engine(tmp_path, capsys):
    """The host-side options reach the port's I/O as raft_tpu's reach its
    own, and the port's oracle engine matches its torch engine."""
    reads, paf = datagen.standard_case(seed=14, tmpdir=str(tmp_path),
                                       n_reads=20)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=["--pure-python-io"])
    rc, _, _ = _run(port_cli.main, [*ARGS, "-o", "orc", "--engine", "oracle",
                                    "--device", "cpu", reads, paf],
                    tmp_path, capsys)
    assert rc == 0
    for ext in OUTS:
        assert ((tmp_path / f"orc{ext}").read_bytes()
                == (tmp_path / f"port{ext}").read_bytes()), ext


@pytest.mark.parametrize("flag", [["--pallas"], ["--no-pallas"]],
                         ids=lambda f: "_".join(f))
def test_pallas_flags_byte_equal(tmp_path, capsys, flag):
    """--pallas and --no-pallas are accepted: files byte-equal and stdout
    line-equal to raft_tpu.cli with the same flag (off a TPU raft_tpu runs
    its scatter pileup either way, the port its one pileup)."""
    reads, paf = datagen.standard_case(seed=15, tmpdir=str(tmp_path),
                                       n_reads=25)
    _, out, err = _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                                   extra=flag)
    assert "ERROR" not in err and out


@pytest.mark.parametrize("flag", [
    ["--chunk-reads", "5"], ["--spill-paf"], ["--trace", "tr"]],
    ids=lambda f: "_".join(f))
def test_streaming_cov_out_and_trace_flags_byte_equal(tmp_path, capsys,
                                                      flag):
    """Streaming, PAF spill and --trace: files byte-equal and stdout
    line-equal to raft_tpu.cli with the same flags. (The coverage return
    modes are test_torch_cov_out.test_cov_out_values_byte_equal's.)"""
    reads, paf = datagen.standard_case(seed=15, tmpdir=str(tmp_path),
                                       n_reads=25)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf], extra=flag)
    if "--trace" in flag:
        from raft_tpu_torch.profiling import TRACE_FILE
        assert (tmp_path / "tr" / TRACE_FILE).stat().st_size > 0


@pytest.mark.parametrize("flag", [
    ["--devices", "4"], ["--devices", "4", "--chunk-reads", "5"],
    ["--devices", "0"]], ids=lambda f: "_".join(f))
def test_devices_byte_equal(tmp_path, capsys, flag):
    """--devices: raft_tpu shards over that many of the 8 virtual CPU
    devices, the port over as many CPU shards (0: unsharded); files
    byte-equal and stdout line-equal, whole-file and chunked. The port's
    stats name one device per shard and list every shard's launch."""
    reads, paf = datagen.standard_case(seed=18, tmpdir=str(tmp_path),
                                       n_reads=25)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=[*flag, "--stats-json", "s.json"])
    import json
    with open(tmp_path / "s.json") as f:
        st = json.load(f)
    n = int(flag[1]) or 1
    assert st["devices"] == ["cpu"] * n
    b = st["buckets"]
    assert b and len(b) % n == 0
    assert all(b[i] == b[i - i % n] for i in range(len(b)))


@pytest.mark.parametrize("flag", [["--engine", "jax"], ["--engine=jax"]],
                         ids=["engine_jax", "engine_eq_jax"])
def test_engine_jax_byte_equal(tmp_path, capsys, flag):
    """``--engine jax``, raft_tpu's name for its device engine and its
    default, runs the port's torch engine: files byte-equal and stdout
    line-equal to raft_tpu.cli with the same flag."""
    reads, paf = datagen.standard_case(seed=19, tmpdir=str(tmp_path),
                                       n_reads=25)
    _, out, err = _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                                   extra=flag)
    assert "ERROR" not in err and out


def test_devices_below_one_exits_1(tmp_path, capsys):
    reads, paf = datagen.standard_case(seed=18, tmpdir=str(tmp_path),
                                       n_reads=5)
    rc, out, err = _run(port_cli.main, [*ARGS, "--devices", "-1", "--device",
                                        "cpu", reads, paf], tmp_path, capsys)
    assert rc == 1 and out == ""
    assert "ERROR, --devices must be at least 1" in err


def test_default_device_cuda_without_gpu_exits_1(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads, paf = datagen.standard_case(seed=16, tmpdir=str(tmp_path),
                                       n_reads=5)
    rc, out, err = _run(port_cli.main, [*ARGS, reads, paf], tmp_path, capsys)
    assert rc == 1
    assert "no CUDA device" in err and out == ""
    rc, _, err = _run(port_cli.main, [*ARGS, "--device=gpu", reads, paf],
                      tmp_path, capsys)
    assert rc == 1 and "--device must be one of" in err


def test_help_names_the_port_options(capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("Usage: raft") and "--device" in out


def test_port_run_never_imports_jax(tmp_path):
    """In a fresh process (this one imported jax in conftest), importing
    raft_tpu_torch.parallel and full CLI runs of the port, whole-file,
    chunked under --trace and sharded with --devices 2, leave jax and
    every raft_tpu module out of sys.modules."""
    reads, paf = datagen.standard_case(seed=17, tmpdir=str(tmp_path),
                                       n_reads=10)
    chunked = [*ARGS, "-o", "ch", "--chunk-reads", "3", "--trace", "tr",
               "--device", "cpu", reads, paf]
    sharded = [*ARGS, "-o", "sh", "--devices", "2", "--device", "cpu",
               reads, paf]
    code = ("import sys\n"
            "import raft_tpu_torch.parallel\n"
            "from raft_tpu_torch.cli import main\n"
            f"rc = main({[*ARGS, '--device', 'cpu', reads, paf]!r})\n"
            f"rc += main({chunked!r})\n"
            f"rc += main({sharded!r})\n"
            "print('RC', rc, 'JAX', 'jax' in sys.modules,\n"
            "      any(m.split('.')[0] == 'raft_tpu'\n"
            "          for m in sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "RC 0 JAX False False"
    assert (tmp_path / "200.reads.fasta").exists()
    for pre in ("ch", "sh"):
        assert ((tmp_path / f"{pre}.reads.fasta").read_bytes()
                == (tmp_path / "200.reads.fasta").read_bytes())
    assert os.listdir(tmp_path / "tr")


def test_no_jax_import_in_port_sources():
    """Neither jax nor any module of raft_tpu is imported by the port or
    chip_smoke.py, at any indentation (function-level imports included):
    ``import raft_tpu``, ``import raft_tpu.x``, ``from raft_tpu import``
    and ``from raft_tpu.x import``, but not ``raft_tpu_torch``. Nor does
    any of them start a ``raft_tpu`` module in a subprocess: no string
    ``"raft_tpu.x"`` (a ``-m`` argument), only ``"raft_tpu_torch.x"``.
    Both patterns are first shown to catch what they are for."""
    for bad in ("import jax\n", "    from raft_tpu.io import native\n",
                "import raft_tpu.cli\n"):
        assert PORT_IMPORT.search(bad), bad
    assert not PORT_IMPORT.search("from raft_tpu_torch import cli\n")
    for bad in ('[sys.executable, "-m", "raft_tpu.cli"]',
                "['-m', 'raft_tpu.tools.bench_cpu']"):
        assert PORT_LAUNCH.search(bad), bad
    assert not PORT_LAUNCH.search('["-m", "raft_tpu_torch.cli"]')
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "raft_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 28
    for fn in files:
        with open(fn) as f:
            src = f.read()
        assert not PORT_IMPORT.search(src), fn
        assert not PORT_LAUNCH.search(src), fn


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches raft_tpu only through raft_tpu_torch."""
    pat = re.compile(r"^\s*(import\s+raft_tpu\b(?!_torch)|"
                     r"from\s+raft_tpu\b(?!_torch))", re.M)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "raft_tpu_torch" in src and not pat.search(src)


@pytest.mark.parametrize("pure_python", [False, True])
def test_stats_json_reports_buckets_and_native_io(tmp_path, capsys,
                                                  pure_python):
    """--stats-json holds the (B, W, E) of every bucket the torch engine
    ran, in order, as iter_buckets makes them, and whether the native I/O
    library did the parse."""
    import json

    import numpy as np

    from raft_tpu_torch import bucketing
    from raft_tpu_torch.io import native
    from raft_tpu_torch.io.fasta import load_reads
    from raft_tpu_torch.io.paf import load_paf
    reads, paf = datagen.standard_case(seed=29, tmpdir=str(tmp_path),
                                       n_reads=41)
    extra = ["--pure-python-io"] if pure_python else []
    rc, _, err = _run(port_cli.main, [*ARGS, *extra, "--device", "cpu",
                                      "--stats-json", "s.json", "-o", "o",
                                      reads, paf], tmp_path, capsys)
    assert rc == 0, err
    with open(tmp_path / "s.json") as f:
        st = json.load(f)
    assert st["native_io"] is (not pure_python
                               and native._get_lib() is not None)
    store = load_reads(reads)
    ev_read, ev_lo, ev_hi = load_paf(paf, store).events(store.n_reads)
    order = np.argsort(ev_read, kind="stable")
    want = [[b.B, b.W, b.E] for b in bucketing.iter_buckets(
        store.lens.astype(np.int32), ev_read[order], ev_lo[order],
        ev_hi[order], port_cli.parse_args(ARGS + [reads, paf])[0].reso,
        presorted=True)]
    assert st["buckets"] == want and len(want) > 0
