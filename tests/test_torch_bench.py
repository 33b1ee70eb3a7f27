"""The port's headline benchmark and its helpers against their originals:
``raft_tpu_torch.bench`` against the root ``bench.py``,
``tools/refbuild``, ``tools/bench_cpu``, ``tools/bench_fetch`` and
``tools/bench_pileup`` (the original's ``tools/bench_pallas``), all with
``--device cpu``. Each side builds its 300-read dataset with its own
package's ``gen_dataset``. What is compared: output files as bytes
(exact), the JSON lines' keys (the original's, renamed where they name
TPU machinery) and every number that does not come from a clock
(exact); timings are only checked to be positive."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import bench as tpu_bench  # noqa: E402  (the root bench.py)
from raft_tpu import cli as tpu_cli  # noqa: E402
from raft_tpu.tools import bench_fetch as tpu_fetch  # noqa: E402
from raft_tpu.tools import bench_pallas as tpu_pallas  # noqa: E402
from raft_tpu.tools import benchgen as tpu_benchgen  # noqa: E402
from raft_tpu.tools import refbuild as tpu_refbuild  # noqa: E402
from raft_tpu_torch import bench as port_bench  # noqa: E402
from raft_tpu_torch.tools import bench_cpu as port_cpu  # noqa: E402
from raft_tpu_torch.tools import bench_fetch as port_fetch  # noqa: E402
from raft_tpu_torch.tools import bench_pileup as port_pileup  # noqa: E402
from raft_tpu_torch.tools import benchgen as port_benchgen  # noqa: E402
from raft_tpu_torch.tools import refbuild as port_refbuild  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
N = 300
# the original's keys that name TPU machinery -> the port's
RENAMED = {"pallas_ok": "pileup_ok", "tpu_vs_cpu_backend": "gpu_vs_cpu_backend"}
# what the port's line adds: where it ran
ADDED = {"device", "device_name", "nvidia_smi"}


def _dataset(benchgen, d):
    return benchgen.gen_dataset(os.path.join(d, f"data{N}"), n_reads=N,
                                n_overlaps=N * 30, est_cov=20)


@pytest.fixture(scope="module")
def tpu_outputs(tmp_path_factory):
    """``python -m raft_tpu.cli`` with the benchmark's flags on raft_tpu's
    own 300-read benchmark dataset: the output prefix."""
    d = str(tmp_path_factory.mktemp("tpu"))
    reads, paf = _dataset(tpu_benchgen, d)
    prefix = os.path.join(d, "ref")
    try:
        rc = tpu_cli.main([*tpu_bench.ARGS, "-o", prefix, reads, paf])
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


@pytest.mark.parametrize("case", ["missing_source", "cached_binary"])
def test_refbuild_same_as_original(tmp_path, monkeypatch, case):
    """No source tree: both return None. A binary already in the output
    directory: both return it without building."""
    for mod in (tpu_refbuild, port_refbuild):
        monkeypatch.setattr(mod, "REF_DIR", str(tmp_path / "no_reference"))
    got = {}
    for name, mod in (("tpu", tpu_refbuild), ("port", port_refbuild)):
        out = tmp_path / name
        if case == "cached_binary":
            out.mkdir()
            (out / "raft_ref").write_bytes(b"#!/bin/sh\n")
        got[name] = mod.build_reference(str(out))
    if case == "missing_source":
        assert got == {"tpu": None, "port": None}
    else:
        assert got == {"tpu": str(tmp_path / "tpu" / "raft_ref"),
                       "port": str(tmp_path / "port" / "raft_ref")}


def test_bench_device_cpu_line_and_outputs(tmp_path, tpu_outputs):
    """``python -m raft_tpu_torch.bench --device cpu`` with 300 reads and
    one round: one JSON line with the original's keys for a run without
    a reference (renamed as listed, ``pileup_ok`` null, no CPU ablation),
    and the four files byte-equal to ``raft_tpu.cli``'s."""
    work = tmp_path / "port"
    env = {**os.environ, "PYTHONPATH": ROOT, "RAFT_BENCH_DIR": str(work),
           "RAFT_BENCH_READS": str(N), "RAFT_BENCH_ROUNDS": "1"}
    r = subprocess.run([sys.executable, "-m", "raft_tpu_torch.bench",
                        "--device", "cpu"], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = _json_line(r.stdout)
    assert set(line) == {
        "metric", "value", "unit", "vs_baseline", "vs_ideal_scaled_ref",
        "pileup_ok", "rounds", "ours_rounds_s", "ref_rounds_s",
        "warmup_s", "workdir", "n_reads"} | ADDED
    assert line["metric"] == "reads_per_s" and line["unit"] == "reads/s"
    assert line["pileup_ok"] is None and line["device"] == "cpu"
    assert line["device_name"] is None and line["n_reads"] == N
    assert line["rounds"] == 1 and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / port_bench.BASELINE_READS_PER_S, 3)
    assert "bench stages (best run)" in r.stderr
    _same_files(str(work / "ours"), tpu_outputs)


def _emit_state(kind: str) -> dict:
    """A benchmark's best-so-far state, in the original's ``_BEST`` terms."""
    nan = float("nan")
    st = {"ours": 1.25, "ref": float("inf"), "ref_par": nan,
          "pallas_ok": None, "cpu_backend": nan, "warmup_s": 4.5,
          "ours_rounds": [1.3, 1.25], "ref_rounds": [], "ref_par_rounds": [],
          "ref_rps": 2600.0, "deadline": False}
    if kind in ("reference_parallel_faster", "reference_parallel_slower"):
        st.update(ref=9.0, ref_rounds=[9.5, 9.0], pallas_ok=True,
                  cpu_backend=2.5, ref_rps=N / 9.0)
        par = [2.0, 2.25] if kind.endswith("faster") else [40.0, 41.0]
        st.update(ref_par=min(par), ref_par_rounds=par)
    elif kind == "check_failed":
        st.update(pallas_ok=False, cpu_backend=0.75)
    elif kind == "deadline":
        st.update(ours_rounds=[], warmup_s=nan, deadline=True)
    return st


@pytest.mark.parametrize("kind", [
    "no_reference", "reference_parallel_faster", "reference_parallel_slower",
    "check_failed", "deadline"])
def test_bench_emit_json_same_as_original(monkeypatch, capsys, kind):
    """The result line from the same numbers: the original's
    ``_emit_json`` and the port's ``emit_json`` give the same keys
    (renamed as listed) and values; the port always carries
    ``pileup_ok`` (null when it did not run) and where it ran."""
    st = _emit_state(kind)
    work = "/dev/shm/raft_bench" if kind == "deadline" else "bench_dir"
    monkeypatch.setattr(tpu_bench, "N_READS", N)
    monkeypatch.setattr(tpu_bench, "WORK", work)
    for k in ("ours", "ref", "ref_par", "pallas_ok", "cpu_backend",
              "warmup_s", "ours_rounds", "ref_rounds", "ref_par_rounds"):
        monkeypatch.setitem(tpu_bench._BEST, k, st[k])
    tpu_bench._emit_json(st["ours"], st["ref_rps"], deadline=st["deadline"])
    want = {RENAMED.get(k, k): v
            for k, v in _json_line(capsys.readouterr().out).items()}
    want.setdefault("pileup_ok", None)
    b = port_bench.Bench(
        work=work, n_reads=N, rounds=2, device="cpu", ours=st["ours"],
        ref=st["ref"], ref_par=st["ref_par"], pileup_ok=st["pallas_ok"],
        cpu_backend=st["cpu_backend"], warmup_s=st["warmup_s"],
        ours_rounds=st["ours_rounds"], ref_rounds=st["ref_rounds"],
        ref_par_rounds=st["ref_par_rounds"])
    got = port_bench.emit_json(b, st["ours"], st["ref_rps"],
                               deadline=st["deadline"])
    assert _json_line(capsys.readouterr().out) == got
    assert {k: v for k, v in got.items() if k not in ADDED} == want
    assert got["device"] == "cpu"


def test_bench_parallel_reference_shards_same_as_original(tmp_path,
                                                          monkeypatch):
    """The thread-scaled reference baseline's inputs: with a stand-in
    binary that exits 0, both write the same per-process PAF and FASTA
    shards (halo reads included) and both report a wall."""
    stand_in = shutil.which("true")
    tpu_work, port_work = str(tmp_path / "tpu"), str(tmp_path / "port")
    monkeypatch.setattr(tpu_bench, "WORK", tpu_work)
    monkeypatch.setattr(tpu_bench, "N_READS", N)
    os.makedirs(tpu_work)
    os.makedirs(port_work)
    want = tpu_bench.run_reference_parallel(
        stand_in, *_dataset(tpu_benchgen, tpu_work))
    b = port_bench.Bench(work=port_work, n_reads=N, rounds=1, device="cpu")
    got = port_bench.run_reference_parallel(
        b, stand_in, *_dataset(port_benchgen, port_work))
    assert math.isnan(got) == math.isnan(want)
    names = sorted(os.listdir(os.path.join(tpu_work, "refpar")))
    assert names == sorted(os.listdir(os.path.join(port_work, "refpar")))
    if (os.cpu_count() or 1) > 1:
        assert got > 0 and len(names) == 2 * os.cpu_count() + 1
    for n in names:
        with open(os.path.join(tpu_work, "refpar", n), "rb") as a, \
                open(os.path.join(port_work, "refpar", n), "rb") as p:
            assert a.read() == p.read(), n


def test_bench_cpu_tool(tmp_path, capsys, tpu_outputs):
    """``tools/bench_cpu``: one line, the best wall in seconds, and the
    run's files byte-equal to ``raft_tpu.cli``'s."""
    reads, paf = _dataset(port_benchgen, str(tmp_path))
    out = str(tmp_path / "ours_cpu")
    assert port_cpu.main([reads, paf, out, "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and float(lines[0]) > 0
    _same_files(out, tpu_outputs)


def test_bench_fetch_same_buckets_as_original(tmp_path, monkeypatch, capsys):
    """``tools/bench_fetch --device cpu`` against the original under
    ``RAFT_FORCE_CPU=1``: the same bucket count and D2H bytes, every key
    of the original's line, and the port's H2D bytes."""
    monkeypatch.setenv("RAFT_BENCH_DIR", str(tmp_path / "tpu"))
    monkeypatch.setenv("RAFT_FORCE_CPU", "1")
    assert tpu_fetch.main([str(N)]) == 0
    want = _json_line(capsys.readouterr().out)
    monkeypatch.setenv("RAFT_BENCH_DIR", str(tmp_path / "port"))
    monkeypatch.delenv("RAFT_FORCE_CPU")
    assert port_fetch.main([str(N), "--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    assert set(want) <= set(got)
    assert {"h2d_bytes", "h2d_s", "h2d_mb_s"} <= set(got)
    for k in ("n_reads", "n_buckets", "d2h_bytes"):
        assert got[k] == want[k], k
    assert got["backend"] == "cpu" and got["h2d_bytes"] > 0
    assert all(got[k] > 0 for k in ("exec_s", "engine_like_s",
                                    "fetch_w4_s", "bw_mb_s"))


def test_bench_pileup_same_shapes_as_original(tmp_path, monkeypatch, capsys):
    """``tools/bench_pileup --device cpu`` against ``tools/bench_pallas``
    on CPU JAX: the same (B, W, E, n_used) per bucket, in order; both
    sides equal on every shape (on the CPU both are the plain twin)."""
    monkeypatch.setenv("RAFT_AB_ROUNDS", "1")
    monkeypatch.setenv("RAFT_BENCH_DIR", str(tmp_path / "tpu"))
    assert tpu_pallas.main([str(N)]) == 0
    want = _json_line(capsys.readouterr().out)
    monkeypatch.setenv("RAFT_BENCH_DIR", str(tmp_path / "port"))
    assert port_pileup.main([str(N), "--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)

    def shapes(line):
        return [(r["B"], r["W"], r["E"], r["n_used"]) for r in line["shapes"]]

    assert shapes(got) == shapes(want) and got["n_shapes"] == len(
        shapes(want)) > 0
    assert got["outputs_equal"] is True
    assert all(r["outputs_equal"] and len(r["kernel_rounds_s"]) == 1
               for r in got["shapes"])


@pytest.mark.parametrize("tool", ["bench", "bench_fetch", "bench_pileup"])
def test_cuda_without_card_exits_nonzero(tmp_path, monkeypatch, capsys,
                                         tool):
    """The default ``--device cuda`` with no CUDA device: exit 1 before
    any work, no result line on stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RAFT_BENCH_DIR", str(tmp_path))
    main = {"bench": port_bench.main, "bench_fetch": port_fetch.main,
            "bench_pileup": port_pileup.main}[tool]
    assert main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("module, original", [
    ("raft_tpu_torch.bench", "bench.py at the repository root"),
    ("raft_tpu_torch.tools.refbuild", "raft_tpu/tools/refbuild.py"),
    ("raft_tpu_torch.tools.bench_cpu", "raft_tpu/tools/bench_cpu.py"),
    ("raft_tpu_torch.tools.bench_fetch", "raft_tpu/tools/bench_fetch.py"),
    ("raft_tpu_torch.tools.bench_pileup", "raft_tpu/tools/bench_pallas.py"),
    ("raft_tpu_torch.tools.bench_scale", "raft_tpu/tools/bench_scale.py"),
    ("raft_tpu_torch.tools.bench_chunk", "raft_tpu/tools/bench_chunk.py"),
    ("raft_tpu_torch.tools.bench_gz_scale",
     "raft_tpu/tools/bench_gz_scale.py")])
def test_docstring_names_the_original(module, original):
    """Each entry point's docstring starts by naming the file it
    mirrors, and that file exists."""
    import importlib
    first = importlib.import_module(module).__doc__.splitlines()[0]
    assert first.startswith(f"Mirrors {original}")
    assert os.path.exists(os.path.join(ROOT, original.split()[0]))
