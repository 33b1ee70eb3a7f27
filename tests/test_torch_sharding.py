"""Read sharding of the torch engine (``raft_tpu_torch.parallel.mesh``) on
CPU shards, against the unsharded torch engine and against ``raft_tpu``'s
``shard_map`` path on the 8-virtual-CPU-device mesh (``tests/conftest.py``).
Every compared value is integer or boolean, so the tolerance is exact
equality."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import bucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.engine_jax import compute_jax  # noqa: E402
from raft_tpu.io.fasta import ReadStore, load_reads  # noqa: E402
from raft_tpu.io.paf import OverlapTable, load_paf  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu.parallel import mesh as jmesh  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_engine import _assert_same, _random_rows  # noqa: E402


def _params():
    return AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                      interval_length=2000, read_length=4000,
                      flanking_length=300, overlap_length=200)


def _table(rows, n, symmetric):
    a_id, a_s, a_e, b_id, b_s, b_e = map(
        lambda x: np.asarray(x, dtype=np.int32), zip(*rows))
    return OverlapTable(a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e,
                        b_start=b_s, b_end=b_e, symmetric=symmetric,
                        n_names=n)


def _store(lens):
    lens = np.asarray(lens, dtype=np.int32)
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens.astype(np.int64), out=off[1:])
    return ReadStore(names=[f"r{i}" for i in range(len(lens))],
                     seq_blob=b"A" * int(lens.sum()), seq_off=off,
                     lens=lens, real_reads=True)


def test_make_devices_cpu():
    cpu = torch.device("cpu")
    assert mesh.make_devices(8, "cpu") == [cpu] * 8
    assert mesh.make_devices(None, "cpu") == [cpu]
    for bad in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            mesh.make_devices(bad, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mesh.make_devices(2, "tpu")


def test_make_devices_cuda_clips_to_the_cards_present(monkeypatch, capsys):
    """The first min(n, count) cards, as make_mesh's [:n] clip; a stderr
    line says so when fewer than n exist; no card is an error."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.make_devices(4, "cuda") == cards
    assert "only 2 CUDA device(s); sharding over 2" in capsys.readouterr().err
    assert mesh.make_devices(1, "cuda") == cards[:1]
    assert mesh.make_devices(None, "cuda") == cards
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        mesh.make_devices(2, "cuda")


@pytest.mark.parametrize("n_dev,seed,n_reads,symmetric",
                         [(8, 99, 60, False), (4, 123, 10, True)])
def test_sharded_matches_single_and_raft_tpu(tmp_path, n_dev, seed, n_reads,
                                             symmetric):
    """compute_torch over n CPU shards == unsharded compute_torch ==
    compute_jax over an n-device mesh, every array."""
    reads_path, paf_path = datagen.standard_case(
        seed=seed, tmpdir=str(tmp_path), n_reads=n_reads,
        symmetric=symmetric)
    store = load_reads(reads_path)
    table = load_paf(paf_path, store)
    params = _params().replace(real_reads=store.real_reads,
                               symmetric_overlaps=table.symmetric)
    r1 = compute_torch(store, table, params)
    rn = compute_torch(store, table, params,
                       devices=mesh.make_devices(n_dev, "cpu"))
    _assert_same(r1, rn)
    _assert_same(rn, compute_jax(store, table, params,
                                 mesh=jmesh.make_mesh(n_dev)))


def test_sharded_int8_overflow_host_rebuild():
    """Rows whose diff exceeds int8 are rebuilt on the host from the
    shard-local event slabs: the global-row remap must be exact."""
    lens = [5000] * 16
    rows = []
    for r in (3, 9, 14):  # overflow rows spread across shards
        rows += [(r, 100, 4000, (r + 1) % 16, 0, 3900)] * 200
    rows += [(i, 10, 2000, (i + 2) % 16, 5, 1995) for i in range(16)]
    store, table = _store(lens), _table(rows, 16, True)
    params = _params()
    bad_rows = []
    devs = mesh.make_devices(8, "cpu")

    def count_overflow(cfg, lens_d, ev_off, ev_pk):
        out = et.device_step(lens_d, ev_off, ev_pk, cfg=cfg)
        bad_rows.append(int((et.unpack_out(out["packed"].numpy(), cfg)
                             ["ok8"] == 0).sum()))

    r1 = compute_torch(store, table, params, cov_out="diff8")
    r8 = compute_torch(store, table, params, cov_out="diff8", devices=devs,
                       on_bucket=count_overflow)
    rh = compute_torch(store, table, params, cov_out="host", devices=devs)
    rj = compute_jax(store, table, params, mesh=jmesh.make_mesh(8),
                     cov_out="diff8")
    assert sum(bad_rows) == 3 and len(bad_rows) == 8
    _assert_same(r1, r8)
    _assert_same(r8, rj)
    # host mode keeps the coverage as events: compare it materialized
    np.testing.assert_array_equal(r8.ensure_cov(), rh.ensure_cov())
    np.testing.assert_array_equal(r8.frag_char_start, rh.frag_char_start)
    assert r1.ensure_cov().max() >= 200


def test_sharded_ultralong_pairs_tier():
    """Megabase reads put the bucket past W=32768, where events ship as
    int32 (w0, span) pairs: that wire format is exact through the shards
    too."""
    rng = np.random.default_rng(7)
    lens = [2_500_000, 2_200_000, 2_000_000, 40_000, 30_000, 20_000,
            10_000, 5_000]
    rows = _random_rows(rng, lens, 400)
    # qualifying repeat run deep inside an ultralong read
    rows += [(0, 1_500_000, 1_540_000, 1, 0, 40_000)] * 30
    store, table = _store(lens), _table(rows, 8, False)
    params = AlgoParams(est_cov=5, cov_mul=1.2, repeat_length=10000,
                        interval_length=10000, read_length=20000,
                        overlap_length=500, flanking_length=1000)
    seen = []
    r8 = compute_torch(store, table, params,
                       devices=mesh.make_devices(8, "cpu"),
                       on_bucket=lambda cfg, *a: seen.append(cfg))
    assert any(c.ev_pack == 0 for c in seen)
    assert len(r8.rep_s) > 0
    _assert_same(compute_torch(store, table, params), r8)
    _assert_same(r8, compute_jax(store, table, params,
                                 mesh=jmesh.make_mesh(8)))


def _bucket(seed, n_reads, max_len=9000, sparse=False):
    """One bucket from random reads and overlaps, as compute_torch makes
    it (the largest one when iter_buckets gives several). ``sparse``:
    a handful of overlaps, so shards hold fewer events than the 64-slot
    minimum slab."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(300, max_len, n_reads).astype(np.int32)
    rows = _random_rows(rng, lens, 5 if sparse else 12 * n_reads)
    if not sparse:
        rows += [(r, 0, int(lens[r]), (r + 1) % n_reads, 0, int(lens[r]))
                 for r in range(0, n_reads, 3) for _ in range(25)]
    table = _table(rows, n_reads, False)
    ev_read, ev_lo, ev_hi = table.events(n_reads)
    order = np.argsort(ev_read, kind="stable")
    bks = bucketing.make_buckets(lens, ev_read[order], ev_lo[order],
                                 ev_hi[order], _params().reso)
    return max(bks, key=lambda b: b.n_used)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
@pytest.mark.parametrize("seed,sparse", [(0, False), (1, False), (2, False),
                                         (3, True)])
def test_shard_bucket_equals_raft_tpu(seed, sparse, n_shards):
    """The port's copy of shard_bucket gives raft_tpu's arrays, field for
    field, dtype included."""
    bk = _bucket(seed, 20 + 7 * seed, sparse=sparse)
    got = mesh.shard_bucket(bk, n_shards)
    want = jmesh.shard_bucket(bk, n_shards)
    for f in ("B", "W", "E", "n_used"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("read_ids", "lens", "ev_row", "ev_w0", "ev_w1", "ev_off"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _jax_step(bk, n_shards):
    """raft_tpu's sharded step on the n-device mesh; host outputs."""
    import jax.numpy as jnp
    params = _params()
    sbk = jmesh.shard_bucket(bk, n_shards)
    cfg = ej.derive_cfg(sbk.B // n_shards, sbk.W, sbk.E // n_shards, params)
    out = jmesh.sharded_device_step(jmesh.make_mesh(n_shards))(
        jnp.asarray(sbk.lens), jnp.asarray(sbk.ev_off),
        jnp.asarray(ej.pack_events(sbk.ev_w0, sbk.ev_w1, cfg)), cfg=cfg)
    return np.asarray(out["packed"]), int(out["global_rep_len"])


def _torch_step(bk, n_shards, on_bucket=None):
    sbk = mesh.shard_bucket(bk, n_shards)
    cfg = et.derive_cfg(sbk.B // n_shards, sbk.W, sbk.E // n_shards,
                        _params())
    step = mesh.sharded_device_step(mesh.make_devices(n_shards, "cpu"))
    return sbk, cfg, step(*et.host_inputs(sbk, cfg), cfg=cfg,
                          on_bucket=on_bucket)


def test_all_padding_tail_shards():
    """17 reads quantize to B=24, so over 8 shards of 3 rows the last two
    shards hold only padding (lens 0, offsets all zero, no valid event);
    the step still equals the unsharded one and raft_tpu's."""
    bk = _bucket(5, 17)
    assert bk.n_used == 17 and bk.B == 24
    shards = []
    sbk, cfg, out = _torch_step(
        bk, 8, on_bucket=lambda c, lens, off, pk: shards.append(
            (lens.numpy().copy(), off.numpy().copy())))
    assert len(shards) == 8 and cfg.B == 3
    for lens, off in shards[6:]:
        assert not lens.any() and not off.any()
    cfg1 = et.derive_cfg(bk.B, bk.W, bk.E, _params())
    one = et.device_step(*et.bucket_to_device(bk, cfg1, "cpu"), cfg=cfg1)
    np.testing.assert_array_equal(out["packed"][:17],
                                  one["packed"].numpy()[:17])
    jpacked, jrep = _jax_step(bk, 8)
    np.testing.assert_array_equal(out["packed"], jpacked)
    assert out["global_rep_len"] == jrep


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_global_rep_len_is_the_packed_column_sum(n_shards):
    """global_rep_len (raft_tpu's psum, a host sum here) equals the sum of
    the unsharded run's rep_len_sum column and raft_tpu's psum value."""
    bk = _bucket(11, 40)
    _, cfg, out = _torch_step(bk, n_shards)
    cfg1 = et.derive_cfg(bk.B, bk.W, bk.E, _params())
    one = et.device_step(*et.bucket_to_device(bk, cfg1, "cpu"), cfg=cfg1)
    want = int(one["packed"][:, et.rep_len_sum_col(cfg1)].sum())
    assert want > 0
    assert out["global_rep_len"] == want == _jax_step(bk, n_shards)[1]
    assert et.rep_len_sum_col(cfg) == ej.rep_len_sum_col(
        ej.derive_cfg(cfg.B, cfg.W, cfg.E, _params()))
