"""compute_torch (device="cpu") against compute_jax: every ComputeResult
array and total equal, on the cases of tests/test_engine.py. All compared
values are integer or boolean, so the tolerance is exact equality."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.io.fasta import ReadStore  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu.pipeline import _EventTable, compute_oracle  # noqa: E402
from raft_tpu.result import ComputeResult, from_per_read_lists  # noqa: E402
from raft_tpu_torch import engine_torch  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from test_engine import _mk_table  # noqa: E402


def _mk_store(lens):
    """Lengths only: the compute engines never read the bases."""
    return ReadStore(names=[f"r{i}" for i in range(len(lens))],
                     seq_blob=b"", seq_off=np.zeros(len(lens) + 1, np.int64),
                     lens=np.asarray(lens, dtype=np.int32), real_reads=True)


def _random_rows(rng, lens, n_rows):
    rows = []
    for _ in range(n_rows):
        a = int(rng.integers(0, len(lens)))
        b = int(rng.integers(0, len(lens)))
        qs = int(rng.integers(0, lens[a]))
        qe = int(rng.integers(qs + 1, lens[a] + 1))
        ts = int(rng.integers(0, lens[b]))
        te = int(rng.integers(ts + 1, lens[b] + 1))
        rows.append((a, qs, qe, b, ts, te))
    return rows


def _as_table(rows, path):
    """``grouped``: the OverlapTable (native counting-sort grouping);
    ``sorted``: an events()-only table, which takes the argsort path."""
    table = _mk_table(rows)
    table.symmetric = False
    if path == "sorted":
        table = _EventTable(*table.events(int(table.n_names)), False)
    return table


def _assert_same(a: ComputeResult, b: ComputeResult):
    """Every field equal; coverage compared materialized (either side may
    hold it as events)."""
    for f in dataclasses.fields(ComputeResult):
        if f.name == "cov_flat":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(a.ensure_cov(), b.ensure_cov())


@pytest.mark.parametrize("path", ["grouped", "sorted"])
def test_engines_equal_random(path):
    rng = np.random.default_rng(5)
    lens = rng.integers(100, 20000, 50)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 400), path)
    params = AlgoParams(est_cov=3, cov_mul=1.2, repeat_length=500,
                        interval_length=500, read_length=1500,
                        flanking_length=120, overlap_length=60)
    res = compute_torch(store, table, params, device="cpu")
    _assert_same(res, compute_jax(store, table, params))
    cov, reps, frags, st = compute_oracle(store, table, params)
    want = from_per_read_lists(store.n_reads, cov, reps, frags, st)
    np.testing.assert_array_equal(res.ensure_cov(), want.ensure_cov())
    np.testing.assert_array_equal(res.frag_char_len, want.frag_char_len)


def test_ultralong_reads_end_to_end():
    """Megabase reads: the pairs wire format and multi-stripe W tiers."""
    rng = np.random.default_rng(11)
    lens = [2_500_000, 2_100_000, 20_000, 500]
    rows = _random_rows(rng, lens, 300)
    rows += [(0, 1_000_000, 1_040_000, 1, 0, 40_000)] * 40
    store = _mk_store(lens)
    table = _as_table(rows, "grouped")
    params = AlgoParams(est_cov=5, cov_mul=1.2, repeat_length=10000,
                        interval_length=10000, read_length=20000,
                        overlap_length=500, flanking_length=1000)
    res = compute_torch(store, table, params, device="cpu")
    _assert_same(res, compute_jax(store, table, params))
    assert res.total_read_length == sum(lens)
    assert len(res.rep_s) > 0


def test_bucket_area_cap(monkeypatch):
    """Large-W tiers reach the engine with proportionally fewer rows
    (B*W <= max_cells), and the results still equal compute_jax's."""
    seen = []
    real = engine_torch.derive_cfg

    def spy(B, W, E, params, **kw):
        seen.append((B, W))
        return real(B, W, E, params, **kw)

    monkeypatch.setattr(engine_torch, "derive_cfg", spy)
    rng = np.random.default_rng(9)
    lens = np.full(150, 2_500_000)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 200), "grouped")
    params = AlgoParams(est_cov=2)
    res = compute_torch(store, table, params, device="cpu")
    assert seen and all(W == 65536 and B * W <= (1 << 23) for B, W in seen)
    assert len(seen) == 2
    _assert_same(res, compute_jax(store, table, params))


def test_cov_events_callback_timers_and_grouped(monkeypatch, capsys):
    """on_cov_events gets the final coverage before any device work;
    timers_out and the RAFT_TIMERS line report the stages; a passed-in
    grouped triple is used as is."""
    rng = np.random.default_rng(17)
    lens = rng.integers(100, 30000, 64)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 600), "grouped")
    params = AlgoParams(est_cov=4, cov_mul=1.2, repeat_length=800,
                        interval_length=800, read_length=2000,
                        flanking_length=100, overlap_length=50)
    early = []
    timers = {}
    grouped = table.events_grouped(store.n_reads, store.lens, params.reso)
    monkeypatch.setenv("RAFT_TIMERS", "1")
    monkeypatch.setattr(type(table), "events_grouped", None)
    res = compute_torch(store, table, params, on_cov_events=early.append,
                        timers_out=timers, grouped=grouped, device="cpu")
    assert "compute_torch timers:" in capsys.readouterr().err
    assert {"events", "bucket_prep", "h2d", "step", "integrate"} <= set(timers)
    assert len(early) == 1
    np.testing.assert_array_equal(early[0].ensure_cov(), res.ensure_cov())
    assert early[0].total_coverage == res.total_coverage
    monkeypatch.undo()
    _assert_same(res, compute_jax(store, table, params))


def test_cov_out_other_than_host_is_refused(monkeypatch):
    """A coverage return mode other than host, diff8 or cov is refused,
    from the argument and from RAFT_COV_OUT."""
    store = _mk_store([1000])
    table = _as_table([(0, 0, 500, 0, 100, 600)], "grouped")
    with pytest.raises(ValueError, match="cov_out"):
        compute_torch(store, table, AlgoParams(est_cov=2), cov_out="diff16")
    monkeypatch.setenv("RAFT_COV_OUT", "int8")
    with pytest.raises(ValueError, match="cov_out"):
        compute_torch(store, table, AlgoParams(est_cov=2))


@pytest.mark.parametrize("path", ["grouped", "sorted"])
def test_on_bucket_sees_each_bucket_before_its_step(path):
    """on_bucket gets every bucket's device inputs, once, in the engine's
    order and at the shapes iter_buckets makes; pileup on them equals the
    JAX scatter path's coverage for the same bucket (exact)."""
    from raft_tpu import bucketing
    from raft_tpu import engine_jax as ej
    from raft_tpu_torch.ops import pileup_cuda
    rng = np.random.default_rng(23)
    lens = np.concatenate([rng.integers(100, 20000, 90),
                           [300_000, 2_500_000]]).astype(np.int32)
    store = _mk_store(lens)
    table = _as_table(_random_rows(rng, lens, 700), path)
    params = AlgoParams(est_cov=3, cov_mul=1.2, repeat_length=500,
                        interval_length=500, read_length=1500,
                        flanking_length=120, overlap_length=60)
    seen = []

    def on_bucket(cfg, lens_d, ev_off, ev_pk):
        assert tuple(lens_d.shape) == (cfg.B,)
        seen.append((cfg, pileup_cuda.pileup(ev_off, ev_pk, cfg).numpy()))

    compute_torch(store, table, params, device="cpu", on_bucket=on_bucket)
    ev_read, ev_lo, ev_hi = table.events(store.n_reads)
    order = np.argsort(ev_read, kind="stable")
    bks = list(bucketing.iter_buckets(lens, ev_read[order], ev_lo[order],
                                      ev_hi[order], params.reso,
                                      presorted=True))
    assert [(c.B, c.W, c.E) for c, _ in seen] == [(b.B, b.W, b.E)
                                                  for b in bks]
    assert any(c.ev_pack == 0 for c, _ in seen)
    for (cfg, cov), bk in zip(seen, bks):
        jcfg = ej.derive_cfg(bk.B, bk.W, bk.E, params)
        want = ej.pileup_diff_scatter(bk.ev_row, bk.ev_w0, bk.ev_w1, jcfg)[0]
        np.testing.assert_array_equal(cov, np.asarray(want),
                                      err_msg=f"B={bk.B} W={bk.W}")
