"""The device gather of every bucket's inputs (``ops/gather_cuda.py``) and
Σcov from the grouped events (the native grouping's ``cov_sum``, and
``engine_torch.cov_sum``: one threaded native pass, else numpy's closed
form).

The gather's plain twin, from one table and ``engine_torch.plan_steps``'
plan, must give every step the arrays ``host_inputs`` builds from
``bucketing.iter_buckets``' bucket (``parallel.mesh.shard_bucket``'s shard
where sharded), element for element: on the ``tests/datagen.py``
fixtures and on random tables whose window indices leave the int16
range, in both wire formats, with padded rows and slots; on a card the
kernel must equal the twin. Imports nothing of JAX, so the ``cuda``
cases run on a card's machine."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu_torch import bucketing, engine_torch as et  # noqa: E402
from raft_tpu_torch import pipeline  # noqa: E402
from raft_tpu_torch.io import fasta, native, paf  # noqa: E402
from raft_tpu_torch.io.paf import OverlapTable  # noqa: E402
from raft_tpu_torch.ops import _lib, gather_cuda  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402
from raft_tpu_torch.parallel import mesh  # noqa: E402

PARAMS = AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                    interval_length=2000, read_length=4000,
                    flanking_length=300, overlap_length=200)
FIXTURES = {"real": {}, "simulated": {"simulated": True},
            "symmetric": {"symmetric": True}}


def _fixture_table(tmp_path, mode, seed=43, n_reads=41):
    reads, paf_path = datagen.standard_case(seed=seed, tmpdir=str(tmp_path),
                                            n_reads=n_reads, **mode)
    store = fasta.load_reads(reads)
    table = paf.load_paf(paf_path, store)
    lens = store.lens.astype(np.int32)
    return lens, table.events_grouped(store.n_reads, lens, PARAMS.reso)


def _random_table(seed, n=300, wide=False):
    """A grouped table whose windows run past their reads, below 0, to -1
    and past int16 (as --no-strict intervals may); some reads have no
    event. ``wide``: reads long enough for buckets of 32,768 windows and
    more, whose event columns are int32."""
    rng = np.random.default_rng(seed)
    hi = 2_000_000 if wide else 300_000
    lens = rng.integers(0, hi, n).astype(np.int32)
    counts = rng.integers(0, 40, n)
    counts[rng.random(n) < 0.1] = 0
    off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    m = int(off[-1])
    nw = np.repeat(-(-lens.astype(np.int64) // PARAMS.reso), counts)
    w0 = (rng.random(m) * (nw + 2)).astype(np.int64) - 1
    w1 = w0 + rng.integers(-2, 200, m)
    odd = rng.random(m)
    w0 = np.where(odd < 0.03, rng.integers(-70_000, 70_000, m), w0)
    w1 = np.where((odd > 0.97) & (odd < 0.99), -1, w1)
    w1 = np.where(odd > 0.99, rng.integers(30_000, 100_000, m), w1)
    return lens, (off, w0.astype(np.int32), w1.astype(np.int32))


def _pairs(cfg, steps):
    return (dataclasses.replace(cfg, ev_pack=0),
            [st._replace(pairs=True) for st in steps])


def _plan(lens, grouped, n_shards, pack):
    """plan_steps' buckets, in the wire format ``pack`` (32, or 0 for
    int32 pairs at any width), and one GatherPlan of all their steps."""
    planned = []
    for shape, cfg, steps in et.plan_steps(lens, np.diff(grouped[0]),
                                           PARAMS, n_shards):
        if pack == 0:
            cfg, steps = _pairs(cfg, steps)
        planned.append((shape, cfg, steps))
    plan = gather_cuda.GatherPlan([st for _, _, steps in planned
                                   for st in steps])
    return planned, plan


def _host_steps(lens, grouped, planned, n_shards):
    """Each step's host_inputs, from iter_buckets (and shard_bucket)."""
    out = []
    bks = list(bucketing.iter_buckets(lens, None, None, None, PARAMS.reso,
                                      presorted=True, prebinned=grouped))
    assert len(bks) == len(planned)
    for bk, (shape, cfg, _) in zip(bks, planned):
        assert (bk.B, bk.W, bk.E, bk.n_used) == (shape.B, shape.W, shape.E,
                                                 shape.n_used)
        np.testing.assert_array_equal(bk.read_ids, shape.read_ids)
        if n_shards > 1:
            bk = mesh.shard_bucket(bk, n_shards)
        lens_h, off_h, pk_h = et.host_inputs(bk, cfg)
        for s in range(n_shards):
            out.append((lens_h[s * cfg.B:(s + 1) * cfg.B],
                        off_h[s * (cfg.B + 1):(s + 1) * (cfg.B + 1)],
                        pk_h[s * cfg.E:(s + 1) * cfg.E]))
    return out


def _check_twin(lens, grouped, n_shards, pack):
    planned, plan = _plan(lens, grouped, n_shards, pack)
    tab, nbytes = gather_cuda.upload_table(*grouped, lens, "cpu")
    assert nbytes == 8 * (len(lens) + 1) + 8 * len(grouped[1]) + 4 * len(lens)
    arena = gather_cuda.gather(tab, plan)
    want = _host_steps(lens, grouped, planned, n_shards)
    assert len(want) == len(plan.steps) > 0
    padded_rows = padded_slots = 0
    for i, w in enumerate(want):
        got = gather_cuda.views(arena, plan, i)
        for name, g, h in zip(("lens", "ev_off", "ev_pk"), got, w):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), h, err_msg=f"{i} {name}")
        st = plan.steps[i]
        assert plan.out_bytes(i) == sum(a.nbytes for a in w)
        padded_rows += st.B - len(st.read_ids)
        padded_slots += st.E - int(w[1][-1])
    assert padded_rows > 0 and padded_slots > 0
    return plan, arena


@pytest.mark.parametrize("pack", [32, 0], ids=["pack32", "pairs"])
@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("mode", FIXTURES)
def test_plain_gather_equals_host_inputs_on_fixtures(tmp_path, mode,
                                                     n_shards, pack):
    lens, grouped = _fixture_table(tmp_path, FIXTURES[mode])
    _check_twin(lens, grouped, n_shards, pack)


@pytest.mark.parametrize("pack", [32, 0], ids=["pack32", "pairs"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [1, 2])
def test_plain_gather_equals_host_inputs_on_odd_windows(seed, n_shards,
                                                        pack):
    """Windows out of their reads, negative, -1 and past int16: the twin
    wraps them as the int16 bucket columns do."""
    lens, grouped = _random_table(seed)
    plan, _ = _check_twin(lens, grouped, n_shards, pack)
    assert any(st.trunc16 for st in plan.steps)


def test_plain_gather_on_wide_rows():
    """Buckets of 32,768 windows and more: int32 event columns, and pairs
    where pack32 cannot hold (w0, span)."""
    lens, grouped = _random_table(5, n=60, wide=True)
    plan, _ = _check_twin(lens, grouped, 1, 32)
    assert not all(st.trunc16 for st in plan.steps)
    assert any(st.pairs for st in plan.steps)


def test_gather_checks_its_table():
    lens, grouped = _random_table(3, n=20)
    tab, _ = gather_cuda.upload_table(*grouped, lens, "cpu")
    _, plan = _plan(lens, grouped, 1, 32)
    with pytest.raises(TypeError, match="w0"):
        gather_cuda.gather((tab[0], tab[1].to(torch.int64), *tab[2:]), plan)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gather_cuda.gather(tuple(t.to("meta") for t in tab), plan)


def test_plain_gather_launches_nothing():
    lens, grouped = _random_table(4, n=50)
    before = _lib.launch_counts()
    _check_twin(lens, grouped, 1, 32)
    assert _lib.launch_counts(before) == dict.fromkeys(_lib.KERNELS, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixture", "odd", "wide", "sharded"])
def test_gather_kernel_equals_plain_on_cuda(tmp_path, case):
    """The kernel's arrays equal the twin's, every step, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if case == "fixture":
        lens, grouped = _fixture_table(tmp_path, {})
    else:
        lens, grouped = _random_table(7, n=60 if case == "wide" else 300,
                                      wide=case == "wide")
    for pack in (32, 0):
        _, plan = _plan(lens, grouped, 3 if case == "sharded" else 1, pack)
        tab, _ = gather_cuda.upload_table(*grouped, lens, "cpu")
        want = gather_cuda.gather(tab, plan)
        tab_d, _ = gather_cuda.upload_table(*grouped, lens, "cuda")
        before = _lib.launch_counts()
        got = gather_cuda.gather(tab_d, plan)
        torch.cuda.synchronize()
        assert _lib.launch_counts(before)["gather"] == 1
        for i in range(len(plan.steps)):
            for g, w in zip(gather_cuda.views(got, plan, i),
                            gather_cuda.views(want, plan, i)):
                assert torch.equal(g.cpu(), w), (case, pack, i)


# ---------------------------------------------------------------------------
# Σcov
# ---------------------------------------------------------------------------

def _closed_form(ev_off, w0, w1, lens, reso):
    """Σcov as numpy's closed form: the engine's before the native pass."""
    nwr = np.repeat(-(-lens.astype(np.int64) // reso), np.diff(ev_off))
    valid = (w1 >= w0) & (w0 >= 0) & (w0 < nwr)
    return int(np.where(valid, np.minimum(w1.astype(np.int64), nwr - 1)
                        - w0 + 1, 0).sum())


@pytest.mark.parametrize("mode", FIXTURES)
def test_cov_sum_equals_the_oracle_on_fixtures(tmp_path, mode,
                                               monkeypatch):
    """Strict inputs with self-overlaps, symmetric and not: the native
    grouping's Σcov, the native pass, numpy's closed form (the engine's
    where the library is missing) and the oracle's coverage sum agree."""
    reads, paf_path = datagen.standard_case(seed=44, tmpdir=str(tmp_path),
                                            n_reads=41, **FIXTURES[mode])
    store = fasta.load_reads(reads)
    table = paf.load_paf(paf_path, store)
    assert (table.a_id == table.b_id).any()  # self-overlaps
    lens = store.lens.astype(np.int32)
    g = table.events_grouped(store.n_reads, lens, PARAMS.reso)
    got = native.cov_sum(g[1], g[2], g[0], lens, PARAMS.reso)
    params = PARAMS.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    oracle = pipeline.compute_oracle(store, table, params)[3]
    assert g.cov_sum == et.cov_sum(*g, lens, PARAMS.reso) == got \
        == _closed_form(*g, lens, PARAMS.reso) == oracle.total_coverage > 0
    monkeypatch.setattr(native, "cov_sum", lambda *a: None)
    assert et.cov_sum(*g, lens, PARAMS.reso) == got


@pytest.mark.parametrize("symmetric", [False, True])
def test_cov_sum_on_no_strict_intervals(symmetric):
    """--no-strict intervals: negative starts (w0 < 0), empty ones
    (w1 = -1), starts past the read's windows and ends past them,
    self-overlaps; the engine's Σcov equals the closed form through the
    native grouping and through the numpy sort, and the oracle's."""
    a_id = np.array([0, 1, 2, 0, 2, 1, 0], dtype=np.int32)
    b_id = np.array([1, 0, 2, 2, 2, 1, 0], dtype=np.int32)
    a_s = np.array([-150, -1, 0, 37, 650, 0, 10], dtype=np.int32)
    a_e = np.array([-149, 0, -300, 120, 9000, 499, 900], dtype=np.int32)
    b_s = np.array([0, -75, 0, -10, 600, 5, 15], dtype=np.int32)
    b_e = np.array([50, -20, 0, -9, 700, 6, 35], dtype=np.int32)
    tab = OverlapTable(a_id, b_id, a_s, a_e, b_s, b_e,
                       symmetric=symmetric, n_names=3)
    lens = np.array([500, 450, 520], dtype=np.int32)
    reso = 100
    g = tab.events_grouped(3, lens, reso, strict=False)
    nw = np.repeat(-(-lens.astype(np.int64) // reso), np.diff(g[0]))
    assert (g[2] == -1).any() and (g[1] < 0).any() and (g[1] >= nw).any()
    assert ((g[1] >= 0) & (g[1] < nw) & (g[2] >= nw)).any()
    want = _closed_form(*g, lens, reso)
    assert g.cov_sum == et.cov_sum(*g, lens, reso) \
        == native.cov_sum(g[1], g[2], g[0], lens, reso) == want > 0
    store = fasta.ReadStore(
        names=["a", "b", "c"], seq_blob=b"A" * int(lens.sum()),
        seq_off=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
        lens=lens, real_reads=True)
    params = dataclasses.replace(PARAMS, reso=reso)
    for eg in (tab.events_grouped, None):
        t = dataclasses.replace(tab)
        t.events_grouped = eg
        res = et.compute_torch(store, t, params, strict=False, device="cpu")
        assert res.total_coverage == want
    oracle = pipeline.compute_oracle(store, tab, params, strict=False)[3]
    assert oracle.total_coverage == want


def test_cov_sum_through_auto_e(tmp_path):
    """--auto-e hands its grouped events to the engine: the same Σcov as
    the engine's own grouping and the oracle's."""
    from raft_tpu_torch import auto_e
    reads, paf_path = datagen.standard_case(seed=45, tmpdir=str(tmp_path),
                                            n_reads=41)
    store = fasta.load_reads(reads)
    table = paf.load_paf(paf_path, store)
    params = PARAMS.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    _, grouped = auto_e.estimate_for_table(
        table, store.lens.astype(np.int64), store.n_reads, params.reso,
        params.cov_mul)
    assert grouped is not None and grouped.cov_sum > 0
    via = et.compute_torch(store, table, params, grouped=grouped,
                           device="cpu")
    own = et.compute_torch(store, table, params, device="cpu")
    oracle = pipeline.compute_oracle(store, table, params)[3]
    assert via.total_coverage == own.total_coverage == grouped.cov_sum \
        == et.cov_sum(*grouped, store.lens, params.reso) \
        == oracle.total_coverage
