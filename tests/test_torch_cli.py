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


@pytest.mark.parametrize("mode", [
    dict(), dict(simulated=True), dict(symmetric=True), dict(gz=True),
    dict(fastq=True), dict(multiline=True)],
    ids=["real", "simulated", "symmetric", "gz", "fastq", "multiline"])
def test_outputs_byte_equal(tmp_path, capsys, mode):
    reads, paf = datagen.standard_case(seed=11, tmpdir=str(tmp_path),
                                       n_reads=25, **mode)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf])


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
    """The host-side options reach raft_tpu's I/O unchanged, and the
    port's oracle engine matches its torch engine."""
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


@pytest.mark.parametrize("flag", [
    ["--devices", "2"], ["--pallas"], ["--no-pallas"]],
    ids=lambda f: "_".join(f))
def test_unsupported_flag_exits_1(tmp_path, capsys, flag):
    reads, paf = datagen.standard_case(seed=15, tmpdir=str(tmp_path),
                                       n_reads=5)
    rc, out, err = _run(port_cli.main, [*ARGS, *flag, "--device", "cpu",
                                        reads, paf], tmp_path, capsys)
    assert rc == 1
    assert f"ERROR, {flag[0]} is not yet supported by raft_tpu_torch" in err
    assert out == ""
    assert not (tmp_path / "200.reads.fasta").exists()


@pytest.mark.parametrize("flag", [
    ["--chunk-reads", "5"], ["--spill-paf"], ["--cov-out", "diff8"],
    ["--cov-out", "cov"], ["--trace", "tr"],
    ["--chunk-reads", "4", "--spill-paf", "--cov-out", "diff8"]],
    ids=lambda f: "_".join(f))
def test_streaming_cov_out_and_trace_flags_byte_equal(tmp_path, capsys,
                                                      flag):
    """Streaming, PAF spill, coverage return modes and --trace: files
    byte-equal and stdout line-equal to raft_tpu.cli with the same
    flags."""
    reads, paf = datagen.standard_case(seed=15, tmpdir=str(tmp_path),
                                       n_reads=25)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf], extra=flag)
    if "--trace" in flag:
        from raft_tpu_torch.profiling import TRACE_FILE
        assert (tmp_path / "tr" / TRACE_FILE).stat().st_size > 0


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
    """In a fresh process (this one imported jax in conftest), full CLI
    runs of the port, whole-file and then chunked under --trace, leave
    jax out of sys.modules."""
    reads, paf = datagen.standard_case(seed=17, tmpdir=str(tmp_path),
                                       n_reads=10)
    chunked = [*ARGS, "-o", "ch", "--chunk-reads", "3", "--trace", "tr",
               "--device", "cpu", reads, paf]
    code = ("import sys\n"
            "from raft_tpu_torch.cli import main\n"
            f"rc = main({[*ARGS, '--device', 'cpu', reads, paf]!r})\n"
            f"rc += main({chunked!r})\n"
            "print('RC', rc, 'JAX', 'jax' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "RC 0 JAX False"
    assert (tmp_path / "200.reads.fasta").exists()
    assert ((tmp_path / "ch.reads.fasta").read_bytes()
            == (tmp_path / "200.reads.fasta").read_bytes())
    assert os.listdir(tmp_path / "tr")


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "raft_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 6
    for fn in files:
        with open(fn) as f:
            assert not pat.search(f.read()), fn


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

    from raft_tpu import bucketing
    from raft_tpu.io import native
    from raft_tpu.io.fasta import load_reads
    from raft_tpu.io.paf import load_paf
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
