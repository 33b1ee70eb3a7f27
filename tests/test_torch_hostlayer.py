"""The port's own host layer against raft_tpu's, module by module: each
copy in ``raft_tpu_torch`` (native and pure-Python I/O, bucketing, the
numpy oracle, the result builder, the CLI parser, the dataset generator)
is run beside its ``raft_tpu`` original on the tests/datagen.py fixtures,
each side loading its own inputs with its own package. Every compared
value is an integer array, a string or bytes: the tolerance is exact
equality. Also: the port's CLI run loads neither raft_tpu nor jax."""

from __future__ import annotations

import dataclasses
import io
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import bucketing as jbucketing  # noqa: E402
from raft_tpu import cli as jcli  # noqa: E402
from raft_tpu import pipeline as jpipeline  # noqa: E402
from raft_tpu import result as jresult  # noqa: E402
from raft_tpu.io import fasta as jfasta  # noqa: E402
from raft_tpu.io import native as jnative  # noqa: E402
from raft_tpu.io import paf as jpaf  # noqa: E402
from raft_tpu.tools import benchgen as jbenchgen  # noqa: E402
from raft_tpu_torch import bucketing, cli, gen_dataset, pipeline  # noqa: E402
from raft_tpu_torch import result  # noqa: E402
from raft_tpu_torch.io import fasta, native, paf  # noqa: E402
from test_torch_cli import PORT_IMPORT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [dict(), dict(simulated=True), dict(symmetric=True), dict(gz=True),
            dict(fastq=True), dict(multiline=True)]
FIXTURE_IDS = ["real", "simulated", "symmetric", "gz", "fastq", "multiline"]


def _fixture(tmp_path, mode, seed=41, n_reads=41):
    return datagen.standard_case(seed=seed, tmpdir=str(tmp_path),
                                 n_reads=n_reads, **mode)


def _load_both(reads, paf_path, use_native):
    """(port store, port table), (raft_tpu store, raft_tpu table): each
    package parses the same files with its own parsers."""
    ps = fasta.load_reads(reads, use_native=use_native)
    js = jfasta.load_reads(reads, use_native=use_native)
    return ((ps, paf.load_paf(paf_path, ps, use_native=use_native)),
            (js, jpaf.load_paf(paf_path, js, use_native=use_native)))


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _same_fields(a, b, fields, what):
    for f in fields:
        _same(getattr(a, f), getattr(b, f), f"{what}.{f}")


def _outside_the_emitters(src: str, writers: str) -> str:
    """A raftio.cpp without its output writers (from the comment
    ``writers`` to the end of ``emit_sharded``) and its ``raftio_emit_*``
    entry points (the file's tail), and without the port's one extra
    include."""
    a = src.index(writers)
    b = src.index("}  // namespace", a)
    c = src.index("// Fragment FASTA with in-C++ header rendering")
    return src[:a].replace("#include <ctime>\n", "") + src[b:c]


def test_native_library_is_the_ports_own():
    """The port loads its own library, built from its own source with
    fixed flags, independent of raft_tpu's (both load in one process).
    Its source is raft_tpu's apart from the emitters, which take an
    optional stats array (NULL: no clock read)."""
    assert native._get_lib() is not None
    assert native._SO.startswith(os.path.join(ROOT, "raft_tpu_torch"))
    assert os.path.basename(native._SO) == "libraftio_torch.so"
    assert native._SRC == os.path.join(ROOT, "raft_tpu_torch", "_native",
                                       "raftio.cpp")
    assert not any(a.startswith("$") for a in native.BUILD_CMD)
    if jnative._get_lib() is not None:
        assert native._get_lib()._handle != jnative._get_lib()._handle
    with open(native._SRC) as f, open(os.path.join(
            ROOT, "raft_tpu", "_native", "raftio.cpp")) as g:
        port, orig = f.read(), g.read()
    assert (_outside_the_emitters(port, "// The emitters' optional stats")
            == _outside_the_emitters(orig, "// Zero-copy emitter"))
    for fn in ("frags_full", "coverage", "coverage_events", "bed",
               "repeats"):
        sig = port[port.index(f"int raftio_emit_{fn}("):]
        assert "int gz, int64_t* stats) {" in sig[:sig.index("{") + 1]


@pytest.mark.parametrize("use_native", [None, False], ids=["native", "python"])
@pytest.mark.parametrize("mode", FIXTURES, ids=FIXTURE_IDS)
def test_load_reads_and_paf_equal(tmp_path, mode, use_native):
    """ReadStore and OverlapTable arrays, and both event views, equal
    raft_tpu's on the same files, native and --pure-python-io."""
    reads, paf_path = _fixture(tmp_path, mode)
    (ps, pt), (js, jt) = _load_both(reads, paf_path, use_native)
    _same_fields(ps, js, [f.name for f in dataclasses.fields(ps)
                          if f.name != "name_to_id"], "ReadStore")
    _same_fields(pt, jt, [f.name for f in dataclasses.fields(pt)],
                 "OverlapTable")
    for a, b in zip(pt.events(ps.n_reads), jt.events(js.n_reads),
                    strict=True):
        _same(a, b, "events")
    lens = ps.lens.astype(np.int64)
    for a, b in zip(pt.events_grouped(ps.n_reads, lens, 50),
                    jt.events_grouped(js.n_reads, lens, 50), strict=True):
        _same(a, b, "events_grouped")


def test_load_reads_range_and_index_equal(tmp_path):
    """The streaming schedule's native index and byte-range load."""
    reads, _ = _fixture(tmp_path, dict(simulated=True))
    pi, ji = native.index_reads(reads), jnative.index_reads(reads)
    assert pi["n"] == ji["n"] == 41
    for k in ("rec_off", "lens", "names", "real_reads", "fastq"):
        _same(pi[k], ji[k], k)
    lo, hi = int(pi["rec_off"][7]), int(pi["rec_off"][30])
    ps = native.load_reads_range(pi["data_path"], lo, hi, fastq=pi["fastq"])
    js = jnative.load_reads_range(ji["data_path"], lo, hi, fastq=ji["fastq"])
    _same_fields(ps, js, ["names", "seq_blob", "seq_off", "lens"], "range")


@pytest.mark.parametrize("mode", FIXTURES[:3], ids=FIXTURE_IDS[:3])
def test_iter_buckets_equal(tmp_path, mode):
    """Every bucket of iter_buckets, field for field, dtype included, from
    the sorted events and from the native grouping."""
    reads, paf_path = _fixture(tmp_path, mode, seed=43)
    (ps, pt), (js, jt) = _load_both(reads, paf_path, None)
    lens = ps.lens.astype(np.int32)

    def buckets(mod, store, table, grouped):
        if grouped:
            g = table.events_grouped(store.n_reads, store.lens, 50)
            return list(mod.iter_buckets(lens, None, None, None, 50,
                                         presorted=True, prebinned=g))
        r, a, b = table.events(store.n_reads)
        o = np.argsort(r, kind="stable")
        return list(mod.iter_buckets(lens, r[o], a[o], b[o], 50,
                                     presorted=True))

    for grouped in (False, True):
        got = buckets(bucketing, ps, pt, grouped)
        want = buckets(jbucketing, js, jt, grouped)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same_fields(g, w, [f.name for f in dataclasses.fields(g)],
                         "Bucket")


@pytest.mark.parametrize("mode", FIXTURES[:3], ids=FIXTURE_IDS[:3])
def test_oracle_and_result_equal(tmp_path, mode):
    """compute_oracle (the numpy oracle's three stages per read) and
    from_per_read_lists give raft_tpu's per-read lists and flat result."""
    reads, paf_path = _fixture(tmp_path, mode, seed=47)
    (ps, pt), (js, jt) = _load_both(reads, paf_path, None)
    args = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000", "-f",
            "300", "-v", "200", reads, paf_path]
    got = pipeline.compute_oracle(ps, pt, cli.parse_args(args)[0])
    want = jpipeline.compute_oracle(js, jt, jcli.parse_args(args)[0])
    for g, w in zip(got[0], want[0], strict=True):
        _same(g, w, "coverage")
    assert got[1] == want[1]
    assert ([[dataclasses.astuple(f) for f in fr] for fr in got[2]]
            == [[dataclasses.astuple(f) for f in fr] for fr in want[2]])
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])
    gr = result.from_per_read_lists(ps.n_reads, *got)
    wr = jresult.from_per_read_lists(js.n_reads, *want)
    _same_fields(gr, wr, [f.name for f in dataclasses.fields(gr)],
                 "ComputeResult")
    _same(gr.ensure_cov(), wr.ensure_cov(), "ensure_cov")


ARGVS = [
    ["-e", "10", "r.fa", "o.paf"],
    ["-e20", "-m", "1.5", "-p", "10000", "-l", "20000", "-f", "1000",
     "-v", "500", "r.fa", "o.paf"],
    ["-v", "500", "-o", "pre", "r.fa", "o.paf"],
    ["-v", "500", "--no-compat-getopt", "r.fa", "o.paf"],
    ["-r", "100", "-e", "7x", "-m", "2e0", "--", "r.fa", "o.paf"],
    ["r.fa", "-e", "3", "o.paf", "--no-strict", "--pure-python-io",
     "--profile", "--gz-out", "--auto-e"],
    ["-e", "5", "--chunk-reads", "7", "--spill-paf", "--cov-out", "diff8",
     "--trace", "tr", "--devices", "2", "--stats-json", "s.json",
     "r.fa", "o.paf"],
    ["-e", "5", "--chunk-reads=0", "--no-spill-paf", "--cov-out=cov",
     "--trace=t2", "--devices=4", "--stats-json=x", "--engine=oracle",
     "--pallas", "r.fa", "o.paf"],
    ["-e", "5", "--engine", "jax", "--no-pallas", "r.fa", "o.paf"],
]
BAD_ARGVS = [["-e", "5", "r.fa"], ["-x", "r.fa", "o.paf"],
             ["-i", "3", "r.fa", "o.paf"], ["-e"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_parse_args_equal(argv):
    """The same params and extras as raft_tpu.cli.parse_args."""
    got = cli.parse_args(argv)
    want = jcli.parse_args(argv)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=lambda a: " ".join(a))
def test_parse_args_refusals_equal(argv, capsys):
    """Unknown flags, -i and a missing input exit 1 with the same help."""
    outs = []
    for mod in (cli, jcli):
        with pytest.raises(SystemExit) as e:
            mod.parse_args(argv)
        outs.append((e.value.code, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][0] == 1


def test_print_help_equal():
    for argv in ARGVS[:3]:
        a, b = io.StringIO(), io.StringIO()
        cli.print_help(cli.parse_args(argv)[0], a)
        jcli.print_help(jcli.parse_args(argv)[0], b)
        assert a.getvalue() == b.getvalue() and a.getvalue()


def test_gen_dataset_byte_equal(tmp_path):
    """The seed-7 generator writes raft_tpu's bytes."""
    kw = dict(n_reads=60, n_overlaps=900, est_cov=20, seed=7)
    got = gen_dataset(str(tmp_path / "port"), **kw)
    want = jbenchgen.gen_dataset(str(tmp_path / "ref"), **kw)
    for g, w in zip(got, want):
        with open(g, "rb") as f, open(w, "rb") as h:
            data = f.read()
            assert data == h.read() and data


def test_port_cli_loads_neither_raft_tpu_nor_jax(tmp_path):
    """A fresh process runs the port's CLI on a fixture with --device cpu
    (native I/O, then --engine oracle): no raft_tpu or raft_tpu.* module
    and no jax is ever in sys.modules, and the outputs are written."""
    reads, paf_path = _fixture(tmp_path, dict(simulated=True), n_reads=12)
    args = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000", "-f", "300",
            "-v", "200", "--device", "cpu", reads, paf_path]
    code = ("import sys\n"
            "from raft_tpu_torch.cli import main\n"
            f"rc = main({args!r})\n"
            f"rc += main({[*args, '-o', 'orc', '--engine', 'oracle']!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('raft_tpu', 'jax'))\n"
            "print('RC', rc, 'LOADED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "RC 0 LOADED []"
    assert ((tmp_path / "200.reads.fasta").read_bytes()
            == (tmp_path / "orc.reads.fasta").read_bytes())


@pytest.mark.parametrize("line,caught", [
    ("import raft_tpu", True), ("import raft_tpu.cli", True),
    ("    from raft_tpu import emit", True),
    ("\tfrom raft_tpu.io import native", True),
    ("        from raft_tpu.io.fasta import (ReadStore,", True),
    ("import jax.numpy as jnp", True), ("    from jax import lax", True),
    ("from raft_tpu_torch import emit", False),
    ("    from raft_tpu_torch.io import native", False),
    ("import raft_tpu_torch.parallel", False),
    ("# raft_tpu.io.native builds its library", False),
])
def test_source_scan_catches_every_import_form(line, caught):
    """The pattern of test_torch_cli.test_no_jax_import_in_port_sources
    rejects top-level and function-level imports of raft_tpu and jax, and
    nothing of raft_tpu_torch."""
    assert bool(PORT_IMPORT.search(f"x = 1\n{line}\n")) is caught


OUT_EXTS = (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
            ".long_repeats.bed")


def _reserve_params(tmp, name, cls):
    return cls(est_cov=10, cov_mul=1.3, repeat_length=2000,
               interval_length=2000, read_length=4000, flanking_length=300,
               overlap_length=200, outputfilename=f"{tmp}/{name}")


@pytest.fixture(scope="module")
def reserve_case(tmp_path_factory):
    """A real-read fixture and raft_tpu's four outputs on it."""
    from raft_tpu.params import AlgoParams as JAlgoParams
    tmp = str(tmp_path_factory.mktemp("reserve"))
    reads, paf_path = datagen.standard_case(seed=43, tmpdir=tmp, n_reads=41)
    jpipeline.run_pipeline(reads, paf_path,
                           _reserve_params(tmp, "ref", JAlgoParams),
                           engine="jax", verbose=False)
    ref = {}
    for ext in OUT_EXTS:
        with open(f"{tmp}/ref{ext}", "rb") as f:
            ref[ext] = f.read()
    return reads, paf_path, ref


def _memfd_outputs(prefix):
    """The four outputs as symlinks to fresh memfds, as the benchmark's
    sinks make them; returns the fds."""
    fds = {}
    for ext in OUT_EXTS:
        fds[ext] = os.memfd_create("out" + ext)
        os.symlink(f"/proc/self/fd/{fds[ext]}", prefix + ext)
    return fds


RESERVE_CASES = ("overshoot", "undershoot", "fails", "memfd", "memfd_fails")


@pytest.mark.parametrize("shards", ["1", "4"])
@pytest.mark.parametrize("case", RESERVE_CASES)
@pytest.mark.parametrize("source", ["heap", "mapped"])
def test_reserved_fasta_outputs_equal(reserve_case, tmp_path, monkeypatch,
                                      case, shards, source):
    """The whole-file schedule reserves the plain FASTA's extent ahead of
    its writer; the four outputs stay raft_tpu's, byte for byte, on the
    serial and the sharded emitter, whether the reservation overshoots
    the output (the file shrinks to its size), undershoots it (the
    writes allocate the rest), fails (nothing reserved, counter 0) or
    lands in a memfd behind a symlink, reserved or not. The writer copies
    every sequence into its buffer, whether the reads load into the
    process's memory (``heap``: the fixture is under the threaded
    parser's threshold) or stay in the input's file mapping
    (``mapped``)."""
    reads, paf_path, ref = reserve_case
    monkeypatch.setenv("RAFT_EMIT_SHARDS", shards)
    monkeypatch.setenv("RAFT_SPANS", "1")
    if source == "mapped":
        monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "0")
    if case == "overshoot":
        real = native.reserve
        monkeypatch.setattr(native, "reserve",
                            lambda path, n: real(path, 4 * n + 4096))
    if case.endswith("fails"):
        monkeypatch.setattr(native._get_lib(), "raftio_reserve",
                            lambda path, n: -28)  # ENOSPC
    prefix = str(tmp_path / "out")
    fds = _memfd_outputs(prefix) if case.startswith("memfd") else {}
    try:
        st = pipeline.run_pipeline(
            reads, paf_path,
            _reserve_params(str(tmp_path), "out", pipeline.AlgoParams),
            device="cpu", verbose=False)
        got = {}
        for ext in OUT_EXTS:
            with open(prefix + ext, "rb") as f:
                got[ext] = f.read()
    finally:
        for fd in fds.values():
            os.close(fd)
    for ext in OUT_EXTS:
        assert got[ext] == ref[ext], ext
    size = len(got[".reads.fasta"])
    reserved = st.counters["emit.fasta.reserved_bytes"]
    assert st.counters["emit.fasta.bytes"] == size
    assert {"overshoot": reserved > size, "undershoot": 0 < reserved < size,
            "fails": reserved == 0, "memfd": reserved > 0,
            "memfd_fails": reserved == 0}[case], reserved


@pytest.fixture(scope="module")
def oversized_case(tmp_path_factory):
    """Short reads around one read longer than the FASTA writer's 4 MB
    buffer, every read passed whole (``-l`` above the longest), and
    raft_tpu's four outputs on them."""
    from raft_tpu.params import AlgoParams as JAlgoParams
    tmp = str(tmp_path_factory.mktemp("oversized"))
    rng = random.Random(45)
    reads = datagen.make_reads(rng, 8, 300, 20000)
    reads.insert(4, ("r_long", datagen._seq(rng, 4096) * 1100))
    reads_path, paf_path = f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf"
    datagen.write_fasta(reads_path, reads)
    datagen.write_paf(paf_path, datagen.make_paf(rng, reads, 40,
                                                 include_self=True))
    jpipeline.run_pipeline(
        reads_path, paf_path,
        _reserve_params(tmp, "ref", JAlgoParams).replace(
            read_length=5_000_000), engine="jax", verbose=False)
    ref = {}
    for ext in OUT_EXTS:
        with open(f"{tmp}/ref{ext}", "rb") as f:
            ref[ext] = f.read()
    return reads_path, paf_path, ref


@pytest.mark.parametrize("shards", ["1", "4"])
def test_oversized_read_fasta_equal(oversized_case, tmp_path, monkeypatch,
                                    shards):
    """A whole read longer than the writer's buffer: the writer flushes
    and writes it straight from the store, and the outputs stay
    raft_tpu's on the serial and the sharded emitter."""
    reads, paf_path, ref = oversized_case
    monkeypatch.setenv("RAFT_EMIT_SHARDS", shards)
    st = pipeline.run_pipeline(
        reads, paf_path,
        _reserve_params(str(tmp_path), "out", pipeline.AlgoParams).replace(
            read_length=5_000_000), device="cpu", verbose=False)
    for ext in OUT_EXTS:
        with open(f"{tmp_path}/out{ext}", "rb") as f:
            assert f.read() == ref[ext], ext
    frags = [ln for ln in ref[".reads.fasta"].split(b"\n")
             if ln and not ln.startswith(b">")]
    assert max(map(len, frags)) > 1 << 22
    assert sum(map(len, frags)) == st.total_read_length


def test_failure_before_the_writer_leaves_no_reserved_fasta(
        reserve_case, tmp_path, monkeypatch):
    """An exception in ``compute`` after the FASTA's extent was reserved
    leaves no FASTA, as ``raft_tpu`` leaves none: the file the
    reservation created is removed, not left as reserved NULs."""
    reads, paf_path, _ = reserve_case
    fasta = str(tmp_path / "out.reads.fasta")

    def boom(*a, **k):
        deadline = time.monotonic() + 60
        while not (os.path.exists(fasta) and os.path.getsize(fasta)):
            assert time.monotonic() < deadline, "nothing was reserved"
            time.sleep(0.002)
        raise RuntimeError("compute failed")

    monkeypatch.setattr(pipeline, "compute_torch", boom)
    with pytest.raises(RuntimeError, match="compute failed"):
        pipeline.run_pipeline(
            reads, paf_path,
            _reserve_params(str(tmp_path), "out", pipeline.AlgoParams),
            device="cpu", verbose=False)
    assert not os.path.exists(fasta)


@pytest.mark.parametrize("found", ["absent", "empty"])
def test_parse_failure_leaves_the_fasta_as_it_was(reserve_case, tmp_path,
                                                  monkeypatch, found):
    """A parse that fails after the FASTA's reservation engaged (it starts
    with the pass on a plain FASTA) removes a FASTA the reservation
    created and leaves an empty one it found empty."""
    reads, paf_path, _ = reserve_case
    fasta = tmp_path / "out.reads.fasta"
    if found == "empty":
        fasta.write_bytes(b"")
    reserved = []
    real = native.reserve

    def reserve(path, n):
        reserved.append(real(path, n))
        return reserved[-1]

    def boom(*a, **k):
        deadline = time.monotonic() + 60
        while not reserved:
            assert time.monotonic() < deadline, "nothing was reserved"
            time.sleep(0.002)
        raise ValueError("parse failed")

    monkeypatch.setattr(native, "reserve", reserve)
    monkeypatch.setattr(pipeline, "load_reads", boom)
    with pytest.raises(ValueError, match="parse failed"):
        pipeline.run_pipeline(
            reads, paf_path,
            _reserve_params(str(tmp_path), "out", pipeline.AlgoParams),
            device="cpu", verbose=False)
    assert reserved == [os.path.getsize(reads)]
    if found == "absent":
        assert not fasta.exists()
    else:
        assert fasta.read_bytes() == b""


def test_reserve_failure_is_reported(reserve_case, tmp_path, monkeypatch,
                                     capsys):
    """A full disk met by the reservation is said on stderr while the run
    computes; nothing is reserved and the outputs are still written."""
    reads, paf_path, ref = reserve_case
    monkeypatch.setattr(native._get_lib(), "raftio_reserve",
                        lambda path, n: -28)  # ENOSPC
    pipeline.run_pipeline(
        reads, paf_path,
        _reserve_params(str(tmp_path), "out", pipeline.AlgoParams),
        device="cpu", verbose=True)
    err = capsys.readouterr().err
    assert "WARNING, cannot reserve" in err and "out.reads.fasta" in err
    assert (tmp_path / "out.reads.fasta").read_bytes() == ref[".reads.fasta"]
