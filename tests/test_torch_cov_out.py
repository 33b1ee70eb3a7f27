"""The coverage return modes (``cov_out`` host / diff8 / cov) and the
port's ``--trace`` against raft_tpu (JAX on the CPU): device_step array
for array against ``engine_jax.device_step_impl`` in each mode; the
port's one coverage path (compute_torch) against compute_jax in each of
its modes and the numpy oracle; and ``--cov-out`` on the command line,
where each mode gives the same files as raft_tpu.cli running it. Each
side's inputs are built with its own package. Every compared value is
integer or boolean, and files are compared as bytes, so the tolerance is
exact equality."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import datagen  # noqa: E402
from raft_tpu import bucketing as jbucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.params import AlgoParams as JAlgoParams  # noqa: E402
from raft_tpu.pipeline import compute_oracle  # noqa: E402
from raft_tpu.result import from_per_read_lists  # noqa: E402
from raft_tpu_torch import bucketing  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402
from test_torch_cli import (ARGS, SCHEDULES, _assert_same_run,  # noqa: E402
                            _inputs)
from test_torch_engine import (COV_FIELDS, _assert_same, _case,  # noqa: E402
                               _mk_store, _mk_table, _random_rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["host", "diff8", "cov"]


def _overflow_bucket_case(rng, n_reads=40, hot=(3, 17), stack=300):
    """Random events plus ``stack`` identical intervals on each ``hot``
    read, so those rows gain more than int8 holds in one window."""
    lens = rng.integers(200, 30000, n_reads).astype(np.int32)
    ev_read, ev_lo, ev_hi = [], [], []
    for r in range(n_reads):
        for _ in range(int(rng.integers(0, 40))):
            lo = int(rng.integers(0, lens[r]))
            ev_read.append(r)
            ev_lo.append(lo)
            ev_hi.append(int(rng.integers(lo, lens[r])))
    for r in hot:
        ev_read += [r] * stack
        ev_lo += [100] * stack
        ev_hi += [int(lens[r]) - 1] * stack
    return (lens, np.asarray(ev_read, np.int32), np.asarray(ev_lo, np.int32),
            np.asarray(ev_hi, np.int32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(3))
def test_device_step_matches_jax(mode, seed):
    """Every array of the step's dict (packed with its ok8 column, diff8
    or cov) equals device_step_impl's for the same bucket, including rows
    whose int8 diff wrapped."""
    rng = np.random.default_rng(300 + seed)
    kw = dict(est_cov=3, cov_mul=1.2, repeat_length=500, interval_length=500,
              read_length=1500, overlap_length=60, flanking_length=120)
    params, jparams = AlgoParams(**kw), JAlgoParams(**kw)
    lens, ev_read, ev_lo, ev_hi = _overflow_bucket_case(rng)
    n_bad = 0
    for bk, jbk in zip(
            bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50),
            jbucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50),
            strict=True):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, params, cov_out=mode)
        assert cfg.cov_out == mode
        got = et.device_step(*et.bucket_to_device(bk, cfg, "cpu"), cfg=cfg)
        jcfg = ej.derive_cfg(jbk.B, jbk.W, jbk.E, jparams, use_pallas=False,
                             cov_out=mode)
        want = ej.device_step_impl(
            jnp.asarray(jbk.lens), jnp.asarray(jbk.ev_off),
            jnp.asarray(ej.pack_events(jbk.ev_w0, jbk.ev_w1, jcfg)), jcfg)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == {"diff8": torch.int8}.get(k, torch.int32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} W={bk.W}")
        n_bad += int((~et.unpack_out(got["packed"].numpy(), cfg)["ok8"]).sum())
    assert n_bad == (2 if mode == "diff8" else 0)


@pytest.mark.parametrize("path", ["grouped", "sorted"])
def test_cov_out_modes_equal(path):
    """The port's one coverage path, on the native-grouped and on the
    sorted events, equals compute_jax's result in each of its three modes,
    the coverage compared through ensure_cov(): it carries the events and
    no cov_flat, as compute_jax's host mode does."""
    rng = np.random.default_rng(17)
    lens = rng.integers(100, 30000, 64)
    port, ref = _case(lens, _random_rows(rng, lens, 600), path, est_cov=4,
                      cov_mul=1.2, repeat_length=800, interval_length=800,
                      read_length=2000, flanking_length=100,
                      overlap_length=50)
    res = compute_torch(*port, device="cpu")
    assert res.cov_flat is None and res.cov_ev_w0 is not None
    for m in MODES:
        want = compute_jax(*ref, cov_out=m)
        assert (want.cov_flat is None) == (m == "host")
        _assert_same(res, want, skip=COV_FIELDS)
    _assert_same(res, compute_jax(*ref, cov_out="host"))


def test_int8_overflow_fallback():
    """>127 intervals starting on the same window, the rows whose int8
    diff wraps in diff8 mode: the one path equals the oracle and
    compute_jax(cov_out="diff8"), which rebuilds those rows on the
    host."""
    lens = [5000, 3000]
    rows = [(0, 100, 4000, 1, 0, 3900)] * 200 + [(1, 10, 2900, 0, 5, 2895)]
    kw = dict(est_cov=10, repeat_length=1000, interval_length=1000,
              read_length=2000)
    ref = (_mk_store(lens, jax=True), _mk_table(rows, jax=True),
           JAlgoParams(**kw))
    res = compute_torch(_mk_store(lens), _mk_table(rows), AlgoParams(**kw),
                        device="cpu")
    cov, reps, frags, st = compute_oracle(*ref)
    want = from_per_read_lists(2, cov, reps, frags, st)
    np.testing.assert_array_equal(res.ensure_cov(), want.ensure_cov())
    for f in ("rep_s", "rep_e", "frag_char_start", "frag_char_len"):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f), f)
    assert res.total_coverage == want.total_coverage
    _assert_same(res, compute_jax(*ref, cov_out="diff8"), skip=COV_FIELDS)
    assert res.ensure_cov().max() >= 200  # the pileup really passed int8


@pytest.mark.parametrize("kind", ["plain", "gz", "bgzf"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", MODES)
def test_cov_out_values_byte_equal(tmp_path, capsys, mode, schedule, kind):
    """``--cov-out`` in each mode, whole-file, chunked and spilled, on
    plain, gzip and BGZF inputs: the port's four files and stdout equal
    raft_tpu.cli's, which runs that mode for real (the port renders the
    coverage on the host in every mode)."""
    reads, paf = _inputs(tmp_path, kind, seed=15)
    _assert_same_run(tmp_path, capsys, [*ARGS, reads, paf],
                     extra=[*SCHEDULES[schedule], "--cov-out", mode])


def test_trace_writes_a_chrome_trace_without_jax(tmp_path):
    """--trace DIR on the CPU, in a fresh process: the run exits 0, DIR
    holds a Chrome trace naming the engine's ops, and jax is never
    imported."""
    import json
    reads, paf = datagen.standard_case(seed=18, tmpdir=str(tmp_path),
                                       n_reads=12)
    args = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000", "-f", "300",
            "-v", "200", "--device", "cpu", "--trace", "tr", reads, paf]
    code = ("import sys\n"
            "from raft_tpu_torch.cli import main\n"
            f"rc = main({args!r})\n"
            "print('RC', rc, 'JAX', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "RC 0 JAX False"
    from raft_tpu_torch.profiling import TRACE_FILE
    with open(tmp_path / "tr" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("cumsum" in nm for nm in names), sorted(names)[:20]
    assert (tmp_path / "200.reads.fasta").exists()


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    from raft_tpu_torch import profiling
    with profiling.trace(None, "cuda"):
        pass
    with profiling.trace("", "cpu"):
        pass
    assert not os.listdir(tmp_path)


def test_cov_out_cfg_field_matches_jax():
    """derive_cfg carries cov_out into the cfg as engine_jax does."""
    params = AlgoParams(est_cov=4)
    for m in MODES:
        t = et.derive_cfg(16, 256, 64, params, cov_out=m)
        j = ej.derive_cfg(16, 256, 64, JAlgoParams(est_cov=4), cov_out=m)
        assert t.cov_out == j.cov_out == m
        assert dataclasses.replace(t, cov_out="host") == et.derive_cfg(
            16, 256, 64, params, cov_out="host")
