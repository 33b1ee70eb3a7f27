"""The port's coverage return modes (``cov_out`` host / diff8 / cov) and
its ``--trace`` against raft_tpu (JAX on the CPU): device_step array for
array against ``engine_jax.device_step_impl``, compute_torch against
compute_jax and the numpy oracle. Every compared value is integer or
boolean, so the tolerance is exact equality."""

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
from raft_tpu import bucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu.pipeline import compute_oracle  # noqa: E402
from raft_tpu.result import from_per_read_lists  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from test_engine import _mk_table  # noqa: E402
from test_torch_engine import (_as_table, _assert_same, _mk_store,  # noqa
                               _random_rows)

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
    params = AlgoParams(est_cov=3, cov_mul=1.2, repeat_length=500,
                        interval_length=500, read_length=1500,
                        overlap_length=60, flanking_length=120)
    lens, ev_read, ev_lo, ev_hi = _overflow_bucket_case(rng)
    n_bad = 0
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, params, cov_out=mode)
        assert cfg.cov_out == mode
        got = et.device_step(*et.bucket_to_device(bk, cfg, "cpu"), cfg=cfg)
        jcfg = ej.derive_cfg(bk.B, bk.W, bk.E, params, use_pallas=False,
                             cov_out=mode)
        want = ej.device_step_impl(
            jnp.asarray(bk.lens), jnp.asarray(bk.ev_off),
            jnp.asarray(ej.pack_events(bk.ev_w0, bk.ev_w1, jcfg)), jcfg)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == {"diff8": torch.int8}.get(k, torch.int32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} W={bk.W}")
        n_bad += int((~et.unpack_out(got["packed"].numpy(), cfg)["ok8"]).sum())
    assert n_bad == (2 if mode == "diff8" else 0)


@pytest.mark.parametrize("path", ["grouped", "sorted"])
def test_cov_out_modes_equal(path):
    """The three modes give identical ComputeResults, each equal to
    compute_jax's in the same mode (cov_flat materialized in diff8/cov,
    events in host)."""
    rng = np.random.default_rng(17)
    lens = rng.integers(100, 30000, 64)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 600), path)
    params = AlgoParams(est_cov=4, cov_mul=1.2, repeat_length=800,
                        interval_length=800, read_length=2000,
                        flanking_length=100, overlap_length=50)
    res = {m: compute_torch(store, table, params, cov_out=m, device="cpu")
           for m in MODES}
    for m in MODES:  # (ensure_cov below materializes host's cov_flat)
        assert (res[m].cov_flat is None) == (m == "host")
        _assert_same(res[m], compute_jax(store, table, params, cov_out=m))
    np.testing.assert_array_equal(res["host"].ensure_cov(),
                                  res["diff8"].cov_flat)
    np.testing.assert_array_equal(res["cov"].cov_flat, res["diff8"].cov_flat)
    for f in ("rep_s", "rep_e", "rep_off", "frag_read", "frag_char_start",
              "frag_char_len", "frag_whole", "total_coverage",
              "total_repeat_length"):
        for m in ("diff8", "cov"):
            np.testing.assert_array_equal(getattr(res[m], f),
                                          getattr(res["host"], f), f)


def test_int8_overflow_fallback():
    """>127 intervals starting on the same window: the diff8 rows wrap
    and are rebuilt on the host; results equal the oracle and
    compute_jax(cov_out="diff8")."""
    lens = [5000, 3000]
    rows = [(0, 100, 4000, 1, 0, 3900)] * 200 + [(1, 10, 2900, 0, 5, 2895)]
    store = _mk_store(lens)
    table = _mk_table(rows)
    params = AlgoParams(est_cov=10, repeat_length=1000, interval_length=1000,
                        read_length=2000)
    res = compute_torch(store, table, params, cov_out="diff8", device="cpu")
    cov, reps, frags, st = compute_oracle(store, table, params)
    want = from_per_read_lists(2, cov, reps, frags, st)
    np.testing.assert_array_equal(res.ensure_cov(), want.ensure_cov())
    for f in ("rep_s", "rep_e", "frag_char_start", "frag_char_len"):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f), f)
    assert res.total_coverage == want.total_coverage
    _assert_same(res, compute_jax(store, table, params, cov_out="diff8"))
    assert res.ensure_cov().max() >= 200  # the pileup really passed int8


def test_default_cov_out_from_env(monkeypatch):
    """RAFT_COV_OUT picks the mode when the caller names none; an
    explicit argument wins over it."""
    rng = np.random.default_rng(41)
    lens = rng.integers(100, 20000, 30)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 200), "grouped")
    params = AlgoParams(est_cov=3, repeat_length=500, interval_length=500,
                        read_length=1500)
    monkeypatch.setenv("RAFT_COV_OUT", "cov")
    assert et.derive_cfg(8, 64, 64, params).cov_out == "cov"
    res = compute_torch(store, table, params, device="cpu")
    assert res.cov_flat is not None and res.cov_ev_w0 is None
    host = compute_torch(store, table, params, cov_out="host", device="cpu")
    assert host.cov_flat is None and host.cov_ev_w0 is not None
    monkeypatch.delenv("RAFT_COV_OUT")
    _assert_same(res, compute_jax(store, table, params, cov_out="cov"))
    np.testing.assert_array_equal(host.ensure_cov(), res.cov_flat)


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
        j = ej.derive_cfg(16, 256, 64, params, cov_out=m)
        assert t.cov_out == j.cov_out == m
        assert dataclasses.replace(t, cov_out="host") == et.derive_cfg(
            16, 256, 64, params, cov_out="host")
