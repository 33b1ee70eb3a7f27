"""compute_torch (device="cpu") against compute_jax: every ComputeResult
array and total equal, on the cases of tests/test_engine.py. Each side
builds its inputs (ReadStore, OverlapTable, AlgoParams) with its own
package from the same numbers, and the results are compared field by
field. All compared values are integer or boolean, so the tolerance is
exact equality."""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import pipeline as jpipeline  # noqa: E402
from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.io import fasta as jfasta  # noqa: E402
from raft_tpu.io import paf as jpaf  # noqa: E402
from raft_tpu.params import AlgoParams as JAlgoParams  # noqa: E402
from raft_tpu.result import from_per_read_lists  # noqa: E402
from raft_tpu_torch import cli as pcli  # noqa: E402
from raft_tpu_torch import engine_torch  # noqa: E402
from raft_tpu_torch import pipeline as ppipeline  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.io import fasta as pfasta  # noqa: E402
from raft_tpu_torch.io import paf as ppaf  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402
from raft_tpu_torch.result import ComputeResult  # noqa: E402

# Each package's own host classes: the port's side of a comparison is
# built from raft_tpu_torch, the reference's from raft_tpu.
_PKG = {False: (pfasta, ppaf, ppipeline, AlgoParams),
        True: (jfasta, jpaf, jpipeline, JAlgoParams)}


def _mk_store(lens, jax=False):
    """Lengths only: the compute engines never read the bases."""
    return _PKG[jax][0].ReadStore(
        names=[f"r{i}" for i in range(len(lens))], seq_blob=b"",
        seq_off=np.zeros(len(lens) + 1, np.int64),
        lens=np.asarray(lens, dtype=np.int32), real_reads=True)


def _mk_table(rows, jax=False, symmetric=True, n_names=None):
    """tests/test_engine.py's table builder, in either package."""
    a_id, a_s, a_e, b_id, b_s, b_e = map(
        lambda x: np.asarray(x, dtype=np.int32), zip(*rows))
    return _PKG[jax][1].OverlapTable(
        a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e, b_start=b_s,
        b_end=b_e, symmetric=symmetric,
        n_names=int(a_id.max()) + 1 if n_names is None else n_names)


def _params(jax=False, **kw):
    return _PKG[jax][3](**kw)


def _case(lens, rows, path="grouped", **params):
    """(store, table, params) for the port and for raft_tpu, each built
    with its own package from the same lengths, rows and parameters."""
    return tuple((_mk_store(lens, jax), _as_table(rows, path, jax),
                  _params(jax, **params)) for jax in (False, True))


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


def _as_table(rows, path, jax=False):
    """``grouped``: the OverlapTable (native counting-sort grouping);
    ``sorted``: an events()-only table, which takes the argsort path."""
    table = _mk_table(rows, jax, symmetric=False)
    if path == "sorted":
        table = _PKG[jax][2]._EventTable(*table.events(int(table.n_names)),
                                         False)
    return table


# the fields that carry the coverage, which ensure_cov() materializes
COV_FIELDS = ("cov_flat", "cov_ev_w0", "cov_ev_w1", "cov_ev_off")


def _assert_same(a, b, skip=("cov_flat",)):
    """Every field of the port's ComputeResult equal, one by one (the two
    packages' results are different classes with the same fields);
    coverage compared materialized (either side may hold it as events).
    ``skip=COV_FIELDS`` compares the coverage only materialized: for a
    ``compute_jax`` result of its ``diff8`` or ``cov`` mode, which carries
    ``cov_flat`` and no events."""
    for f in dataclasses.fields(ComputeResult):
        if f.name in skip:
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
    port, ref = _case(lens, _random_rows(rng, lens, 400), path, est_cov=3,
                      cov_mul=1.2, repeat_length=500, interval_length=500,
                      read_length=1500, flanking_length=120,
                      overlap_length=60)
    res = compute_torch(*port, device="cpu")
    _assert_same(res, compute_jax(*ref))
    cov, reps, frags, st = jpipeline.compute_oracle(*ref)
    want = from_per_read_lists(len(lens), cov, reps, frags, st)
    np.testing.assert_array_equal(res.ensure_cov(), want.ensure_cov())
    np.testing.assert_array_equal(res.frag_char_len, want.frag_char_len)


def test_ultralong_reads_end_to_end():
    """Megabase reads: the pairs wire format and multi-stripe W tiers."""
    rng = np.random.default_rng(11)
    lens = [2_500_000, 2_100_000, 20_000, 500]
    rows = _random_rows(rng, lens, 300)
    rows += [(0, 1_000_000, 1_040_000, 1, 0, 40_000)] * 40
    port, ref = _case(lens, rows, est_cov=5, cov_mul=1.2,
                      repeat_length=10000, interval_length=10000,
                      read_length=20000, overlap_length=500,
                      flanking_length=1000)
    res = compute_torch(*port, device="cpu")
    _assert_same(res, compute_jax(*ref))
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
    port, ref = _case(lens, _random_rows(rng, lens, 200), est_cov=2)
    res = compute_torch(*port, device="cpu")
    assert seen and all(W == 65536 and B * W <= (1 << 23) for B, W in seen)
    assert len(seen) == 2
    _assert_same(res, compute_jax(*ref))


def test_cov_events_callback_timers_and_grouped(monkeypatch):
    """on_cov_events gets the final coverage before any device work;
    timers_out and the engine's spans report the stages, timers_out the
    spans' sums; a passed-in grouped triple is used as is."""
    from raft_tpu_torch import profiling
    rng = np.random.default_rng(17)
    lens = rng.integers(100, 30000, 64)
    port, ref = _case(lens, _random_rows(rng, lens, 600), est_cov=4,
                      cov_mul=1.2, repeat_length=800, interval_length=800,
                      read_length=2000, flanking_length=100,
                      overlap_length=50)
    store, table, params = port
    early = []
    timers = {}
    grouped = table.events_grouped(store.n_reads, store.lens, params.reso)
    monkeypatch.setattr(type(table), "events_grouped", None)
    with profiling.run(force=True) as rec:
        res = compute_torch(store, table, params, on_cov_events=early.append,
                            timers_out=timers, grouped=grouped, device="cpu")
    stages = {"events", "bucket_prep", "h2d", "step", "integrate"}
    assert stages <= set(timers)
    sums: dict = {}
    for s in rec.spans:
        if s["name"].startswith("engine."):
            k = s["name"][len("engine."):]
            sums[k] = sums.get(k, 0) + s["t1"] - s["t0"]
    assert timers == {k: v / 1e9 for k, v in sums.items()}
    assert len(early) == 1
    np.testing.assert_array_equal(early[0].ensure_cov(), res.ensure_cov())
    assert early[0].total_coverage == res.total_coverage
    # sharded, the same per-bucket path marks the same stages
    timers = {}
    sharded = compute_torch(store, table, params, timers_out=timers,
                            grouped=grouped, devices=["cpu", "cpu"])
    assert {"events", "bucket_prep", "h2d", "step", "integrate"} <= set(timers)
    monkeypatch.undo()
    _assert_same(res, compute_jax(*ref))
    _assert_same(sharded, compute_jax(*ref))


def test_cov_out_other_than_host_is_refused(tmp_path, capsys):
    """A coverage return mode other than host, diff8 or cov is refused
    when ``run_pipeline`` starts, whole-file and chunked, with the text
    the engine gave before, and no output is opened; the CLI prints it and
    exits 1. The engine itself takes no mode."""
    reads, paf = datagen.standard_case(seed=21, tmpdir=str(tmp_path),
                                       n_reads=8)
    params = AlgoParams(est_cov=10, outputfilename=str(tmp_path / "x"))
    for chunk in (0, 3):
        with pytest.raises(ValueError, match=r"^cov_out='diff16': must be "
                           r"one of host, diff8, cov$"):
            ppipeline.run_pipeline(reads, paf, params, device="cpu",
                                   verbose=False, chunk_reads=chunk,
                                   cov_out="diff16")
    assert not list(tmp_path.glob("x.*"))
    rc = pcli.main(["-e", "10", "-o", str(tmp_path / "c"), "--device", "cpu",
                    "--cov-out", "int8", reads, paf])
    assert rc == 1
    assert ("ERROR, cov_out='int8': must be one of host, diff8, cov"
            in capsys.readouterr().err)
    assert "cov_out" not in inspect.signature(compute_torch).parameters


@pytest.mark.parametrize("path", ["grouped", "sorted"])
def test_on_bucket_sees_each_bucket_before_its_step(path):
    """on_bucket gets every bucket's device inputs, once, in the engine's
    order and at the shapes iter_buckets makes; pileup on them equals the
    JAX scatter path's coverage for the same bucket (exact)."""
    from raft_tpu import bucketing as jbucketing
    from raft_tpu import engine_jax as ej
    from raft_tpu_torch import bucketing
    from raft_tpu_torch.ops import pileup_cuda
    rng = np.random.default_rng(23)
    lens = np.concatenate([rng.integers(100, 20000, 90),
                           [300_000, 2_500_000]]).astype(np.int32)
    port, ref = _case(lens, _random_rows(rng, lens, 700), path, est_cov=3,
                      cov_mul=1.2, repeat_length=500, interval_length=500,
                      read_length=1500, flanking_length=120,
                      overlap_length=60)
    store, table, params = port
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
    jstore, jtable, jparams = ref
    ev_read, ev_lo, ev_hi = jtable.events(jstore.n_reads)
    order = np.argsort(ev_read, kind="stable")
    jbks = list(jbucketing.iter_buckets(lens, ev_read[order], ev_lo[order],
                                        ev_hi[order], jparams.reso,
                                        presorted=True))
    assert len(jbks) == len(bks)
    for (cfg, cov), bk in zip(seen, jbks):
        jcfg = ej.derive_cfg(bk.B, bk.W, bk.E, jparams)
        want = ej.pileup_diff_scatter(bk.ev_row, bk.ev_w0, bk.ev_w1, jcfg)[0]
        np.testing.assert_array_equal(cov, np.asarray(want),
                                      err_msg=f"B={bk.B} W={bk.W}")


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "sharded"])
def test_wide_and_chop_counters(devices):
    """Under a recording, the engine's chop counters and, over the buckets
    wider than 2,048 windows, its ``engine.wide.*`` counters equal what
    the inputs and the result give: 300 reads of 15-20 kb (one 512-window
    tier) beside 40 of 150-600 kb (merged into one wide tier), so the
    wide reads are those over 2,048 x r bases."""
    from raft_tpu_torch import profiling
    rng = np.random.default_rng(31)
    lens = rng.permutation(np.concatenate([
        rng.integers(15_000, 20_000, 300),
        rng.integers(150_000, 600_000, 40)])).astype(np.int32)
    rows = _random_rows(rng, lens, 1500)
    big = np.nonzero(lens > 150_000)[0][:6]
    rows += [(int(a), 50_000, 90_000, int(b), 10_000, 50_000)
             for a, b in zip(big, big[1:])] * 12
    (store, table, params), _ = _case(lens, rows, est_cov=5, cov_mul=1.2,
                                      repeat_length=10000,
                                      interval_length=10000,
                                      read_length=20000, overlap_length=500,
                                      flanking_length=1000)
    with profiling.run(force=True) as rec:
        res = compute_torch(store, table, params, device="cpu",
                            devices=devices)
    c = rec.counters
    reso = params.reso
    wide = lens.astype(np.int64) > engine_torch.WIDE_W * reso
    ev_read, ev_lo, ev_hi = table.events(store.n_reads)
    w0 = ev_lo // reso
    w1 = np.where(ev_hi < 0, -1, ev_hi // reso)
    per_frag = np.bincount(res.frag_read, minlength=len(lens))
    n_shards = len(devices or [None])
    assert c["engine.fragments"] == len(res.frag_read)
    assert c["engine.cut_reads"] == int((per_frag > 1).sum()) >= 40
    assert c["engine.repeats"] == len(res.rep_s) > 0
    assert c["engine.wide.buckets"] == n_shards
    assert c["engine.wide.reads"] == int(wide.sum()) == 40
    assert c["engine.wide.windows"] == int(
        (-(-lens.astype(np.int64) // reso))[wide].sum())
    assert c["engine.wide.events"] == int(
        ((w1 >= w0) & (w0 >= 0) & wide[ev_read]).sum())
    assert c["engine.wide.repeats"] == int(np.diff(res.rep_off)[wide].sum())
    assert c["engine.wide.fragments"] == int(per_frag[wide].sum())
    assert {k for k in c if k.startswith("engine.wide.")} == {
        "engine.wide." + k for k in engine_torch.WIDE_COUNTS}
    steps = [s["attrs"] for s in rec.spans if s["name"] == "engine.step"]
    assert sorted(a["W"] for a in steps) == [512, 16384]
    assert all(a["pileup_regime"] == a["scan_chop_regime"] == 0
               for a in steps)
