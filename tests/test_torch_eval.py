"""The port's ground-truth evaluation tools (``raft_tpu_torch.tools``:
simulate, split_naive, eval_repeats, asm_proxy, asm_stats) against
raft_tpu's originals on the CPU. Each side builds its inputs with its own
package from the same seed; every compared value is an integer, a rounded
float printed by both tools, a string or bytes, so the tolerance is exact
equality. Also: the recorded 2 Mbp rows of EVAL_sweep_r05.jsonl, the
tool's refusal to run on a missing GPU, and a fresh-process run that
loads neither jax nor raft_tpu. The ``slow`` tests port
tests/test_eval_quality.py's 2 Mbp checks."""

from __future__ import annotations

import gzip
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.io import fasta as jfasta  # noqa: E402
from raft_tpu.io import paf as jpaf  # noqa: E402
from raft_tpu.params import AlgoParams as JParams  # noqa: E402
from raft_tpu.tools import asm_proxy as jasm  # noqa: E402
from raft_tpu.tools import asm_stats as jstats  # noqa: E402
from raft_tpu.tools import eval_repeats as jev  # noqa: E402
from raft_tpu.tools import simulate as jsim  # noqa: E402
from raft_tpu.tools import split_naive as jsplit  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.io import fasta, paf  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402
from raft_tpu_torch.tools import asm_proxy, asm_stats  # noqa: E402
from raft_tpu_torch.tools import eval_repeats as ev  # noqa: E402
from raft_tpu_torch.tools import simulate, split_naive  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_EXTS = (".reads.fasta", ".overlaps.paf", ".truth_repeats.bed")
# a small genome whose repeats (2 families x 3 copies x 12 kb) are longer
# than the default -p 10000, so the eval rows score real detections
SMALL = dict(genome_size=300_000, coverage=12.0, repeat_fams=2,
             repeat_len=12_000, copies=3)


def _sim_both(tmp_path, *args, **kw):
    """(port prefix, raft_tpu prefix, info), each written by its own
    package; the info dicts must agree."""
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    info = simulate.write_simulation(p, *args, **kw)
    assert info == jsim.write_simulation(j, *args, **kw)
    return p, j, info


@pytest.mark.parametrize("kw", [
    dict(), dict(drop_rate=0.3), dict(spurious_rate=0.2),
    dict(jitter_sd=250.0),
    dict(drop_rate=0.2, spurious_rate=0.1, jitter_sd=100.0, seed=23)],
    ids=["clean", "drop", "spurious", "jitter", "combined"])
def test_simulate_byte_equal(tmp_path, kw):
    p, j, _ = _sim_both(tmp_path, 200_000, 8.0, 2, 6000, 3, **kw)
    for ext in SIM_EXTS:
        assert ((tmp_path / f"p{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes()), ext


def test_simulate_main_byte_equal(tmp_path, capsys):
    args = ["--genome-size", "150000", "--coverage", "6", "--repeat-len",
            "5000", "--seed", "3", "--jitter-sd", "50"]
    assert simulate.main([*args, "--out", str(tmp_path / "p")]) == 0
    assert jsim.main([*args, "--out", str(tmp_path / "j")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" → ")[0] == out[1].split(" → ")[0]
    assert "python -m raft_tpu_torch.cli" in out[0]
    for ext in SIM_EXTS:
        assert ((tmp_path / f"p{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes()), ext


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_interval_algebra_equal(seed):
    """merge / total_len / intersect_len / points_in / n50 on seeded
    random intervals (empty sets included) equal raft_tpu's."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 200):
        s = rng.integers(0, 50_000, n)
        a = np.stack([s, s + rng.integers(0, 3000, n)], axis=1)
        s = rng.integers(0, 50_000, n // 2 + 1)
        b = np.stack([s, s + rng.integers(1, 5000, len(s))], axis=1)
        ma, mb = ev.merge_intervals(a), ev.merge_intervals(b)
        np.testing.assert_array_equal(ma, jev.merge_intervals(a))
        assert ma.dtype == jev.merge_intervals(a).dtype
        assert ev.total_len(ma) == jev.total_len(ma)
        assert ev.intersect_len(ma, mb) == jev.intersect_len(ma, mb)
        pts = rng.integers(-10, 60_000, 3 * n)
        np.testing.assert_array_equal(ev.points_in(pts, ma),
                                      jev.points_in(pts, ma))
        lens = rng.integers(1, 40_000, n)
        assert ev.n50(lens) == jev.n50(lens)


def test_interval_algebra_hand_checked():
    """The hand-checked cases of tests/test_eval_quality.py, on the port."""
    iv = np.asarray([[5, 10], [0, 3], [9, 12], [20, 30]])
    m = ev.merge_intervals(iv)
    assert m.tolist() == [[0, 3], [5, 12], [20, 30]]
    assert ev.total_len(m) == 3 + 7 + 10
    other = np.asarray([[2, 6], [25, 40]])
    assert ev.intersect_len(m, ev.merge_intervals(other)) == (1 + 1 + 5)
    got = ev.points_in(np.asarray([0, 2, 3, 4, 11, 12, 29, 30]), m)
    assert got.tolist() == [True, True, False, False, True, False, True,
                            False]
    assert ev.n50(np.asarray([1, 1, 1, 97])) == 97


@pytest.mark.parametrize("seed", [4, 9])
def test_cut_positions_equal(tmp_path, seed):
    """cut_positions on seeded random fragment arrays, and
    naive_cut_positions, over each package's own load of one simulation;
    then the cut positions of each package's own engine result."""
    p, j, info = _sim_both(tmp_path, 200_000, 8.0, 2, 12_000, 3, seed=seed)
    ps = fasta.load_reads(p + ".reads.fasta")
    js = jfasta.load_reads(j + ".reads.fasta")
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 5, ps.n_reads)
    fr = np.repeat(np.arange(ps.n_reads), per)
    res = types.SimpleNamespace(
        frag_read=fr, frag_char_start=rng.integers(0, 8000, len(fr)),
        frag_char_len=rng.integers(1, 8000, len(fr)),
        frag_whole=rng.random(len(fr)) < 0.2)
    np.testing.assert_array_equal(ev.cut_positions(res, ps),
                                  jev.cut_positions(res, js))
    for sub in (5000, 20_000):
        np.testing.assert_array_equal(ev.naive_cut_positions(ps, sub),
                                      jev.naive_cut_positions(js, sub))
    pt = paf.load_paf(p + ".overlaps.paf", ps)
    jt = jpaf.load_paf(j + ".overlaps.paf", js)
    kw = dict(est_cov=info["est_cov"], real_reads=False)
    got = ev.cut_positions(compute_torch(
        ps, pt, AlgoParams(**kw, symmetric_overlaps=pt.symmetric),
        device="cpu"), ps)
    want = jev.cut_positions(compute_jax(
        js, jt, JParams(**kw, symmetric_overlaps=jt.symmetric)), js)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(auto_e=True),
    dict(drop_rate=0.2, spurious_rate=0.1, jitter_sd=100.0)],
    ids=["clean", "auto_e", "combined_noise"])
def test_run_eval_equal(tmp_path, kw):
    """One evaluation point, row for row (keys in order), and the four
    product outputs byte for byte."""
    got = ev.run_eval(str(tmp_path / "p"), **SMALL, seed=7, verbose=False,
                      device="cpu", **kw)
    want = jev.run_eval(str(tmp_path / "j"), **SMALL, seed=7,
                        verbose=False, engine="jax", **kw)
    assert list(got.items()) == list(want.items())
    assert got["bed_recall"] > 0 and got["interior_cuts"] > 0
    for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                ".long_repeats.bed"):
        assert ((tmp_path / "p" / f"out{ext}").read_bytes()
                == (tmp_path / "j" / f"out{ext}").read_bytes()), ext


def test_run_eval_oracle_engine_equal(tmp_path):
    """--engine oracle runs the product run on the numpy oracle: the same
    row as the torch engine's."""
    got = ev.run_eval(str(tmp_path / "o"), **SMALL, seed=8, verbose=False,
                      engine="oracle", device="cpu")
    want = ev.run_eval(str(tmp_path / "t"), **SMALL, seed=8, verbose=False,
                       device="cpu")
    assert got == want


@pytest.mark.parametrize("scales", [(0.5, 1.0), (0.75, 2.0)],
                         ids=["0.5_1", "0.75_2"])
def test_run_sweep_equal(tmp_path, scales, capsys):
    """The sensitivity sweep at two scales plus its --auto-e row, and the
    JSON lines it prints."""
    common = dict(genome_size=SMALL["genome_size"],
                  coverage=SMALL["coverage"], seeds=(5,), scales=scales,
                  repeat_fams=2, repeat_len=12_000, copies=3)
    got = ev.run_sweep(str(tmp_path / "p"), **common, device="cpu")
    out_p = capsys.readouterr().out
    want = jev.run_sweep(str(tmp_path / "j"), **common, engine="jax")
    out_j = capsys.readouterr().out
    assert [list(r.items()) for r in got] == [list(r.items()) for r in want]
    assert len(got) == 3 and out_p == out_j


def test_run_noise_sweep_equal(tmp_path):
    pts = ({"drop_rate": 0.2}, {"spurious_rate": 0.1, "jitter_sd": 100.0})
    common = dict(genome_size=200_000, coverage=10.0, seeds=(3,),
                  points=pts, verbose=False)
    got = ev.run_noise_sweep(str(tmp_path / "p"), **common, device="cpu")
    want = jev.run_noise_sweep(str(tmp_path / "j"), **common, engine="jax")
    assert [list(r.items()) for r in got] == [list(r.items()) for r in want]
    assert len(got) == 3


def test_recorded_2m_rows(tmp_path):
    """The 2 Mbp, seed-11 sweep's 1x and --auto-e rows equal their lines
    in EVAL_sweep_r05.jsonl, field for field and in order."""
    with open(os.path.join(ROOT, "EVAL_sweep_r05.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    rows = ev.run_sweep(str(tmp_path), 2_000_000, 30.0, seeds=(11,),
                        scales=(1.0,), verbose=False, device="cpu")
    for r in rows:
        want = [x for x in rec if x["genome_size"] == 2_000_000
                and x["seed"] == 11 and x["auto_e"] == r["auto_e"]
                and x["est_cov_scale"] == r["est_cov_scale"]]
        assert len(want) == 1
        assert list(r.items()) == list(want[0].items())


@pytest.mark.parametrize("sub_len", [3000, 20_000])
def test_split_naive_byte_equal(tmp_path, sub_len):
    p, j, _ = _sim_both(tmp_path, 150_000, 5.0, 1, 5000, 2, seed=6)
    n = split_naive.split_naive(p + ".reads.fasta", str(tmp_path / "p.fa"),
                                sub_len)
    assert n == jsplit.split_naive(j + ".reads.fasta",
                                   str(tmp_path / "j.fa"), sub_len)
    assert split_naive.main([p + ".reads.fasta", str(tmp_path / "pm.fa"),
                             str(sub_len)]) == 0
    got = (tmp_path / "p.fa").read_bytes()
    assert got == (tmp_path / "j.fa").read_bytes()
    assert got == (tmp_path / "pm.fa").read_bytes()


def _header_tiling(reads_fasta, L):
    """The position-blind tiling of tests/test_eval_quality.py:138-162:
    non-overlapping ``L``-bp tiles of every read, in genome coordinates
    from the simulated headers."""
    hdr = re.compile(
        rb">read=\d+,(forward|reverse),position=(\d+)-(\d+),length=\d+,")
    iv = []
    with open(reads_fasta, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                m = hdr.match(line)
                al, a, b = m.group(1), int(m.group(2)), int(m.group(3))
                cuts = list(range(0, b - a, L)) + [b - a]
                for k in range(len(cuts) - 1):
                    lo, hi = cuts[k], cuts[k + 1]
                    iv.append((a + lo, a + hi) if al == b"forward"
                              else (b - hi, b - lo))
    return np.asarray(iv, dtype=np.int64)


def _merged_truth(mod, bed):
    reps = mod.read_bed(bed)
    merged = [list(reps[0])]
    for s, e in reps[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.int64)


def test_asm_proxy_equal(tmp_path):
    """evaluate() on each package's own RAFT fragments, and assemble /
    ng50 on the header tiling, equal raft_tpu's; main prints the same
    JSON."""
    ev.run_eval(str(tmp_path / "p"), **SMALL, seed=7, verbose=False,
                device="cpu")
    jev.run_eval(str(tmp_path / "j"), **SMALL, seed=7, verbose=False,
                 engine="jax")
    pfr, pbed = (str(tmp_path / "p" / "out.reads.fasta"),
                 str(tmp_path / "p" / "sim.truth_repeats.bed"))
    jfr, jbed = (str(tmp_path / "j" / "out.reads.fasta"),
                 str(tmp_path / "j" / "sim.truth_repeats.bed"))
    got = asm_proxy.evaluate(pfr, pbed)
    assert got == jasm.evaluate(jfr, jbed)
    assert got["n_fragments"] > 0
    for mo in (500, 2000):
        assert asm_proxy.evaluate(pfr, pbed, mo) == jasm.evaluate(jfr, jbed,
                                                                   mo)
    L = AlgoParams().read_length
    tp = _header_tiling(str(tmp_path / "p" / "sim.reads.fasta"), L)
    tj = _header_tiling(str(tmp_path / "j" / "sim.reads.fasta"), L)
    np.testing.assert_array_equal(tp, tj)
    c, amb, gap = asm_proxy.assemble(tp, _merged_truth(asm_proxy, pbed), 500)
    jc, jamb, jgap = jasm.assemble(tj, _merged_truth(jasm, jbed), 500)
    np.testing.assert_array_equal(c, jc)
    assert (amb, gap) == (jamb, jgap)
    span = int(tp[:, 1].max() - tp[:, 0].min())
    assert asm_proxy.ng50(c, span) == jasm.ng50(jc, span) > 0
    np.testing.assert_array_equal(asm_proxy.fragment_intervals(pfr),
                                  jasm.fragment_intervals(jfr))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_asm_stats_equal(tmp_path, capsys, gz):
    rng = np.random.default_rng(5)
    text = b"".join(
        b">c%d\n" % i + b"ACGT" * int(rng.integers(0, 40)) + b"\n"
        + b"GA" * int(rng.integers(0, 9)) + b"\n" for i in range(30))
    path = tmp_path / ("asm.fa.gz" if gz else "asm.fa")
    path.write_bytes(gzip.compress(text) if gz else text)
    lens = asm_stats.contig_lengths(str(path))
    assert lens == jstats.contig_lengths(str(path)) and len(lens) == 30
    for denom in (sum(lens), 1000, 10 ** 6):
        for x in (0.5, 0.9):
            assert asm_stats.nx(lens, denom, x) == jstats.nx(lens, denom, x)
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr\n" + "C" * 2000 + "\n")
    for extra in ([], ["-r", str(ref)], ["-g", "500"]):
        assert asm_stats.main([str(path), *extra]) == 0
        got = capsys.readouterr().out
        assert jstats.main([str(path), *extra]) == 0
        assert got == capsys.readouterr().out
        assert json.loads(got)["contigs"] == 30


def test_eval_main_default_cuda_without_gpu_exits_1(tmp_path):
    """No --device and no GPU: exit 1 with an ERROR line, nothing run."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from raft_tpu_torch.tools.eval_repeats import main\n"
            f"sys.exit(main(['--workdir', {str(tmp_path / 'w')!r}]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    assert r.stderr.startswith("ERROR, --device cuda: no CUDA device")
    assert r.stdout == "" and not (tmp_path / "w").exists()


def test_eval_cpu_run_loads_no_jax(tmp_path):
    """In a fresh process, the eval tool's main with --device cpu, then
    split_naive, asm_proxy and asm_stats on its outputs, leave jax and
    every raft_tpu module out of sys.modules; the eval row equals the
    in-process one."""
    w = str(tmp_path / "w")
    args = ["--workdir", w, "--genome-size", "300000", "--coverage", "12",
            "--repeat-fams", "2", "--repeat-len", "12000", "--copies", "3",
            "--seed", "7", "--device", "cpu"]
    code = ("import sys\n"
            "from raft_tpu_torch.tools import eval_repeats, split_naive\n"
            "from raft_tpu_torch.tools import asm_proxy, asm_stats\n"
            f"rc = eval_repeats.main({args!r})\n"
            f"rc += split_naive.main([{w + '/sim.reads.fasta'!r}, "
            f"{w + '/naive.fa'!r}, '20000'])\n"
            f"rc += asm_proxy.main(['--fragments', {w + '/out.reads.fasta'!r},"
            f" '--truth-bed', {w + '/sim.truth_repeats.bed'!r}])\n"
            f"rc += asm_stats.main([{w + '/naive.fa'!r}, '-g', '300000'])\n"
            "print('RC', rc, 'JAX', 'jax' in sys.modules,\n"
            "      any(m.split('.')[0] == 'raft_tpu' for m in sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[-1] == "RC 0 JAX False False"
    want = jev.run_eval(str(tmp_path / "j"), **SMALL, seed=7, verbose=False)
    assert json.loads(lines[0]) == json.loads(json.dumps(want))
    assert json.loads(lines[1])["n_fragments"] == want["n_fragments"]
    assert json.loads(lines[2])["contigs"] > 0


# ---------------------------------------------------------------------------
# tests/test_eval_quality.py's 2 Mbp checks, on the port (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_quality_at_2m_scale(tmp_path):
    out = ev.run_eval(str(tmp_path), genome_size=2_000_000, coverage=30.0,
                      verbose=False, device="cpu")
    assert out["bed_recall"] >= 0.95, out
    assert out["bed_precision_flank_tolerant"] >= 0.95, out
    assert out["genome_fraction_covered_by_fragments"] >= 0.99, out
    assert out["cut_in_repeat_rate"] <= 0.06, out
    assert (out["cut_in_repeat_rate"]
            <= 0.6 * out["naive_cut_in_repeat_rate"]), out
    assert out["n_fragments"] > out["n_reads"], out


@pytest.mark.slow
def test_est_cov_sensitivity_shape(tmp_path):
    rows = ev.run_sweep(str(tmp_path), genome_size=2_000_000, coverage=30.0,
                        seeds=(11,), scales=(0.5, 1.0, 2.0), verbose=False,
                        device="cpu")
    by_scale = {r["est_cov_scale"]: r for r in rows}
    lo, mid, hi = by_scale[0.5], by_scale[1.0], by_scale[2.0]
    assert lo["bed_precision_flank_tolerant"] <= 0.5, lo
    assert lo["n_fragments"] <= 0.9 * mid["n_fragments"], (lo, mid)
    assert lo["fraction_repeat_stat"] >= 3 * mid["fraction_repeat_stat"]
    for r in (mid, hi):
        assert r["bed_recall"] >= 0.95, r
        assert r["bed_precision_flank_tolerant"] >= 0.95, r
    assert abs(hi["n_fragments"] - mid["n_fragments"]) \
        <= 0.02 * mid["n_fragments"], (mid, hi)


@pytest.mark.slow
def test_auto_e_quality(tmp_path):
    out = ev.run_eval(str(tmp_path), genome_size=2_000_000, coverage=30.0,
                      verbose=False, auto_e=True, device="cpu")
    assert 31 <= out["est_cov_used"] <= 45, out
    assert out["bed_recall"] >= 0.95, out
    assert out["bed_precision_flank_tolerant"] >= 0.95, out
    assert out["cut_in_repeat_rate"] <= 0.06, out
    assert out["n_fragments"] > out["n_reads"], out


@pytest.mark.slow
def test_noisy_overlaps_quality(tmp_path):
    out = ev.run_eval(str(tmp_path), genome_size=2_000_000, coverage=30.0,
                      verbose=False, drop_rate=0.2, spurious_rate=0.1,
                      jitter_sd=100.0, device="cpu")
    assert out["bed_recall"] >= 0.95, out
    assert out["bed_precision_flank_tolerant"] >= 0.90, out
    assert out["cut_in_repeat_rate"] <= 0.08, out
    assert out["n_fragments"] > out["n_reads"], out


@pytest.mark.slow
def test_asm_proxy_contiguity(tmp_path):
    """RAFT fragments assemble more contiguously than the position-blind
    tiling, and the 2 Mbp seed-11 row of EVAL.md's table (RAFT NG50
    593,307 with 5 contigs and 4 ambiguous breaks; tiling 258,450, 11 and
    9) holds exactly."""
    prefix = str(tmp_path / "sim")
    info = simulate.write_simulation(prefix, 2_000_000, 30.0, 3, 15000, 4,
                                     seed=11)
    from raft_tpu_torch.pipeline import run_pipeline
    params = AlgoParams(est_cov=info["est_cov"],
                        outputfilename=str(tmp_path / "out"))
    run_pipeline(prefix + ".reads.fasta", prefix + ".overlaps.paf", params,
                 verbose=False, device="cpu")
    raft = asm_proxy.evaluate(str(tmp_path / "out.reads.fasta"),
                              prefix + ".truth_repeats.bed")
    naive = _header_tiling(prefix + ".reads.fasta", params.read_length)
    c, amb, _ = asm_proxy.assemble(
        naive, _merged_truth(asm_proxy, prefix + ".truth_repeats.bed"), 500)
    naive_ng50 = asm_proxy.ng50(c, int(naive[:, 1].max()
                                       - naive[:, 0].min()))
    assert raft["ng50"] >= 1.5 * naive_ng50, (raft, naive_ng50)
    assert raft["ambiguous_junction_breaks"] < amb, (raft, amb)
    assert (raft["ng50"], raft["n_contigs"],
            raft["ambiguous_junction_breaks"]) == (593_307, 5, 4)
    assert (naive_ng50, len(c), amb) == (258_450, 11, 9)
