"""The port's scale tools against their originals, with ``--device cpu``:
``tools/bench_chunk`` (its trace analysis on one port trace, and a run),
``tools/bench_scale`` and ``tools/bench_gz_scale``. Each side builds its
300-read dataset with its own package's ``gen_dataset``; the JAX side is
``raft_tpu.cli`` on CPU JAX. What is compared: output files as bytes
(exact) and the trace analysis as dicts (exact)."""

from __future__ import annotations

import json
import os

import pytest

torch = pytest.importorskip("torch")

from raft_tpu import cli as tpu_cli  # noqa: E402
from raft_tpu.tools import bench_chunk as tpu_chunk  # noqa: E402
from raft_tpu.tools import benchgen as tpu_benchgen  # noqa: E402
from raft_tpu_torch import cli as port_cli  # noqa: E402
from raft_tpu_torch.tools import bench_chunk as port_chunk  # noqa: E402
from raft_tpu_torch.tools import bench_gz_scale as port_gz  # noqa: E402
from raft_tpu_torch.tools import bench_scale as port_scale  # noqa: E402
from raft_tpu_torch.tools import benchgen as port_benchgen  # noqa: E402

OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
N = 300
ROWS = 30


def _dataset(benchgen, d):
    """bench_scale's dataset at N reads x ROWS rows, as its own tag names
    it."""
    return benchgen.gen_dataset(os.path.join(d, f"scale{N}"), n_reads=N,
                                n_overlaps=N * ROWS, est_cov=20)


@pytest.fixture(scope="module")
def tpu_outputs(tmp_path_factory):
    """``raft_tpu.cli`` with the tools' flags on raft_tpu's own dataset:
    the output prefix."""
    d = str(tmp_path_factory.mktemp("tpu"))
    reads, paf = _dataset(tpu_benchgen, d)
    prefix = os.path.join(d, "ref")
    try:
        rc = tpu_cli.main([*tpu_chunk.ARGS, "-o", prefix, reads, paf])
    except SystemExit as e:
        rc = e.code
    assert rc in (0, None)
    return prefix


def _same_files(got: str, want: str):
    for ext in OUTS:
        with open(got + ext, "rb") as a, open(want + ext, "rb") as b:
            assert a.read() == b.read(), ext


def _json_line(out: str) -> dict:
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _on_cpu(run: dict):
    """A port run's facts from its --stats-json: the CPU, buckets, no
    launch of any kernel."""
    assert run["devices"] == ["cpu"] and run["n_buckets"] > 0
    assert run["launches"] == {"pileup": 0, "scan_chop": 0, "gather": 0}


@pytest.mark.parametrize("flags", [["--chunk-reads", "100"],
                                   ["--chunk-reads", "64", "--spill-paf"]],
                         ids=["chunked", "chunked_spill"])
def test_bench_chunk_analyze_same_as_original(tmp_path, monkeypatch,
                                              capsys, flags):
    """One port run's ``RAFT_CHUNK_TRACE`` and ``--stats-json``: the
    original's ``analyze`` and the port's give the same dict, whose
    engine substages are the port's (``h2d`` among them)."""
    reads, paf = _dataset(port_benchgen, str(tmp_path))
    trace = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("RAFT_CHUNK_TRACE", trace)
    rc = port_cli.main([*port_chunk.ARGS, *flags, "--device", "cpu",
                        "--stats-json", str(tmp_path / "s.json"), "-o",
                        str(tmp_path / "o"), reads, paf])
    capsys.readouterr()
    assert rc == 0
    with open(tmp_path / "s.json") as f:
        stats = json.load(f)
    got = port_chunk.analyze(trace, 1.5, stats)
    assert got == tpu_chunk.analyze(trace, 1.5, stats)
    assert got["n_chunks"] == -(-N // int(flags[1]))
    assert {"bucket_prep", "h2d", "step", "integrate"} <= set(
        got["main_thread"]["engine_substages_s"])


def test_bench_chunk_without_trace_same_as_original(tmp_path):
    """No trace (the run took the whole-file path): both stop with the
    same message."""
    msgs = []
    for mod in (tpu_chunk, port_chunk):
        with pytest.raises(SystemExit) as e:
            mod.analyze(str(tmp_path / "none.jsonl"), 1.0, {})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no chunk trace" in msgs[0]


def test_bench_chunk_run_equals_expected(tmp_path, capsys, tpu_outputs):
    """``tools/bench_chunk --device cpu --chunk 100 --expect P`` against
    ``raft_tpu.cli``'s outputs: ``all_equal`` true, the run on the CPU,
    three chunks."""
    reads, paf = _dataset(port_benchgen, str(tmp_path))
    rc = port_chunk.main(["--reads", reads, "--paf", paf, "--workdir",
                          str(tmp_path / "w"), "--chunk", "100", "--device",
                          "cpu", "--expect", tpu_outputs])
    line = _json_line(capsys.readouterr().out)
    assert rc == 0 and line["all_equal"] is True
    assert line["n_chunks"] == 3 and line["device"] == "cpu"
    assert line["n_fragments"] > N and line["output_bytes"] > 0
    _on_cpu(line)


def test_bench_scale_cpu(tmp_path, capsys, tpu_outputs):
    """``tools/bench_scale --device cpu`` at 300 reads: whole-file and
    chunked+spill outputs equal (``all_equal``), the whole-file ones
    byte-equal to ``raft_tpu.cli``'s, every run on the CPU."""
    d = str(tmp_path / "scale")
    rc = port_scale.main(["--reads", str(N), "--rows-per-read", str(ROWS),
                          "--chunk", "100", "--dir", d, "--device", "cpu",
                          "--keep-outputs"])
    line = _json_line(capsys.readouterr().out)
    assert rc == 0 and line["all_equal"] is True
    assert line["n_reads"] == N and line["n_paf_rows"] == N * ROWS
    for run in ("whole", "chunked"):
        _on_cpu(line[run])
        assert line[run]["reads_per_s"] > 0
    assert line["chunked"]["n_buckets"] > line["whole"]["n_buckets"]
    _same_files(os.path.join(d, "out_whole"), tpu_outputs)


def test_bench_gz_scale_cpu(tmp_path, capsys, tpu_outputs):
    """``tools/bench_gz_scale --device cpu``: the gz and BGZF runs equal
    the plain one (``all_equal``), which is byte-equal to
    ``raft_tpu.cli``'s; the BGZF index sees every read."""
    reads, paf = _dataset(port_benchgen, str(tmp_path))
    d = str(tmp_path / "gz")
    rc = port_gz.main(["--reads", reads, "--paf", paf, "--dir", d,
                       "--device", "cpu"])
    line = _json_line(capsys.readouterr().out)
    assert rc == 0 and line["all_equal"] is True
    assert line["bgzf_index_n"] == N
    for run in ("plain", "gz", "bgzf"):
        _on_cpu(line[run])
    _same_files(os.path.join(d, "out_plain"), tpu_outputs)


@pytest.mark.parametrize("tool", ["bench_scale", "bench_chunk",
                                  "bench_gz_scale"])
def test_cuda_without_card_exits_nonzero(tmp_path, monkeypatch, capsys,
                                         tool):
    """The default ``--device cuda`` with no CUDA device: exit 1 before
    anything is generated, compressed or run; no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "d")
    argv = {"bench_scale": ["--reads", "5", "--dir", d],
            "bench_chunk": ["--reads", "r", "--paf", "p", "--workdir", d],
            "bench_gz_scale": ["--reads", "r", "--paf", "p", "--dir", d]}
    main = {"bench_scale": port_scale.main, "bench_chunk": port_chunk.main,
            "bench_gz_scale": port_gz.main}[tool]
    assert main(argv[tool]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err
    assert not os.path.exists(d)
