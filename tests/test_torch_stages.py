"""engine_torch's stages against their engine_jax twins on the CPU, on
the inputs of tests/test_kernels.py (same seeds and parameter sets).

Every compared array is integer, so the tolerance is exact equality."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raft_tpu import bucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from test_kernels import rand_case  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(want, got, msg=""):
    """Exact equality of a JAX array and a torch tensor."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _jax_cfg(tcfg):
    """The JAX cfg with the same shapes, wire format and parameters."""
    return ej.StaticCfg(**dataclasses.asdict(tcfg), use_pallas=False)


SLOT_PARAMS = [
    (50, 10000, 10000, 20000),
    (50, 50, 50, 100),
    (1, 1, 1, 2),
    (50, 200, 500, 4000),
    (100, 150, 1000, 1500),
]


@pytest.mark.parametrize("reso,rl,il,l", SLOT_PARAMS)
def test_derive_cfg_matches_jax(reso, rl, il, l):
    """M/K/F and every parameter field equal engine_jax.derive_cfg's; the
    wire format is pack32 wherever JAX packs into 32 bits or fewer."""
    params = AlgoParams(est_cov=4, cov_mul=1.0, reso=reso, repeat_length=rl,
                        interval_length=il, read_length=l,
                        flanking_length=0, overlap_length=0)
    for W in (8, 64, 256, 32768, 1 << 16, 1 << 20):
        t = et.derive_cfg(8, W, 64, params)
        j = ej.derive_cfg(8, W, 64, params)
        for f in dataclasses.fields(t):
            if f.name != "ev_pack":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.ev_pack == (32 if j.ev_pack else 0)


@pytest.mark.parametrize("seed", range(4))
def test_rows_from_offsets_matches_jax(seed):
    """Empty rows (tied offsets), empty leading rows and the padded tail
    (sentinel B) rebuild exactly as in engine_jax."""
    rng = np.random.default_rng(100 + seed)
    n_reads = int(rng.integers(1, 40))
    lens = rng.integers(1, 4000, n_reads).astype(np.int32)
    ev_read, ev_lo = [], []
    for r in range(n_reads):
        if rng.random() < 0.4:
            continue
        for _ in range(rng.integers(1, 8)):
            ev_read.append(r)
            ev_lo.append(int(rng.integers(0, lens[r])))
    ev_read = np.asarray(ev_read, dtype=np.int32)
    ev_lo = np.asarray(ev_lo, dtype=np.int32)
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_lo, 50):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, AlgoParams(est_cov=5))
        got = et.rows_from_offsets(_t(bk.ev_off), cfg)
        assert got.dtype == torch.int32
        _eq(ej.rows_from_offsets(jnp.asarray(bk.ev_off), _jax_cfg(cfg)), got)
        _eq(bk.ev_row.astype(np.int32), got)


@pytest.mark.parametrize("W,E", [
    (64, 64), (128, 64), (256, 64), (2048, 128), (2048, 66), (4096, 64),
    (32768, 64), (1 << 16, 64), (1 << 20, 64)])
@pytest.mark.parametrize("seed", range(3))
def test_unpack_events_matches_jax(W, E, seed):
    """pack32 words are bit-identical to engine_jax's 32-bit packing and
    pairs to its pairs; both decode to engine_jax's (w0, w1), padding
    and invalid events included."""
    rng = np.random.default_rng(400 + seed)
    cfg = et.derive_cfg(8, W, E, AlgoParams(est_cov=5))
    assert cfg.ev_pack == (32 if W <= 32768 else 0)
    jcfg = _jax_cfg(cfg)
    w0 = rng.integers(0, W, E).astype(np.int64)
    w1 = np.where(rng.random(E) < 0.25, -1,
                  rng.integers(0, W, E)).astype(np.int64)
    pk = et.pack_events(w0, w1, cfg)
    jpk = ej.pack_events(w0, w1, jcfg)
    np.testing.assert_array_equal(pk, jpk)
    tpk = _t(pk.view(np.int32) if pk.dtype == np.uint32 else pk)
    g0, g1 = et.unpack_events(tpk, cfg)
    j0, j1 = ej.unpack_events(jnp.asarray(jpk), jcfg)
    assert g0.dtype == g1.dtype == torch.int32
    _eq(j0, g0)
    _eq(j1, g1)


@pytest.mark.parametrize("seed", range(5))
def test_pileup_diff_scatter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    params = AlgoParams(est_cov=10, reso=50)
    lens, ev_read, ev_lo, ev_hi = rand_case(rng)
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, params)
        cov, diff = et.pileup_diff_scatter(_t(bk.ev_row), _t(bk.ev_w0),
                                           _t(bk.ev_w1), cfg)
        jcov, jdiff = ej.pileup_diff_scatter(
            jnp.asarray(bk.ev_row), jnp.asarray(bk.ev_w0),
            jnp.asarray(bk.ev_w1), _jax_cfg(cfg))
        assert cov.dtype == diff.dtype == torch.int32
        _eq(jcov, cov, f"W={bk.W}")
        _eq(jdiff, diff, f"W={bk.W}")


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("rl,flank", [(500, 100), (50, 0), (200, 5000)])
def test_repeat_scan_matches_jax(seed, rl, flank):
    rng = np.random.default_rng(100 + seed)
    reso = 50
    params = AlgoParams(est_cov=4, cov_mul=1.5, repeat_length=rl,
                        interval_length=max(rl, 1), read_length=2 * max(rl, 1),
                        flanking_length=flank, reso=reso)
    n, W, B = 12, 128, 16
    lens = np.zeros(B, dtype=np.int32)
    lens[:n] = rng.integers(1, W * reso, n)
    cov = np.zeros((B, W), dtype=np.int32)
    for r in range(n):
        nw = -(-int(lens[r]) // reso)
        cov[r, :nw] = rng.integers(0, 10, nw)
    cfg = et.derive_cfg(B, W, 64, params)
    got = et.repeat_scan(_t(cov), _t(lens), cfg)
    want = ej.repeat_scan(jnp.asarray(cov), jnp.asarray(lens), _jax_cfg(cfg))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(w, g)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("il,l,ov", [(1000, 2000, 200), (1000, 3000, 0),
                                     (500, 4000, 100)])
def test_chop_markers_matches_jax(seed, il, l, ov):
    rng = np.random.default_rng(200 + seed)
    params = AlgoParams(est_cov=10, interval_length=il, repeat_length=il,
                        read_length=l, overlap_length=ov)
    B, n, maxlen = 16, 13, 12000
    lens = np.zeros(B, dtype=np.int32)
    lens[:n] = rng.integers(0, maxlen, n)
    W = -(-maxlen // params.reso)
    cfg = et.derive_cfg(B, 1 << int(np.ceil(np.log2(W))), 64, params)
    rep_s = np.full((B, cfg.K), 1, dtype=np.int32)
    rep_e = np.zeros((B, cfg.K), dtype=np.int32)
    for r in range(n):
        ivs = []
        for _ in range(int(rng.integers(0, min(cfg.K, 4)))):
            s = int(rng.integers(0, max(lens[r], 1)))
            ivs.append((s, int(rng.integers(s, max(lens[r], 1)))))
        for j, (s, e) in enumerate(sorted(ivs)):
            rep_s[r, j] = s
            rep_e[r, j] = e
    got = et.chop_markers(_t(lens), _t(rep_s), _t(rep_e), cfg)
    want = ej.chop_markers(jnp.asarray(lens), jnp.asarray(rep_s),
                           jnp.asarray(rep_e), _jax_cfg(cfg))
    assert set(got) == set(want)
    for k in want:
        _eq(want[k], got[k], k)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("rl,il,l,ov,flank", [
    (500, 500, 1500, 60, 120), (2000, 1000, 4000, 200, 300)])
def test_device_step_packed_matches_jax(seed, rl, il, l, ov, flank):
    """The packed [B, 2K+2F+5] int32 output, column for column, with each
    engine fed its own wire format from the same bucket."""
    rng = np.random.default_rng(seed)
    params = AlgoParams(est_cov=3, cov_mul=1.2, repeat_length=rl,
                        interval_length=il, read_length=l,
                        overlap_length=ov, flanking_length=flank)
    lens, ev_read, ev_lo, ev_hi = rand_case(rng, n_reads=40, max_len=30000,
                                            max_ev_per_read=40)
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, params)
        out = et.device_step(*et.bucket_to_device(bk, cfg, "cpu"), cfg=cfg)
        assert set(out) == {"packed"}  # host mode: one D2H array
        got = out["packed"]
        jcfg = ej.derive_cfg(bk.B, bk.W, bk.E, params, use_pallas=False,
                             cov_out="host")
        want = ej.device_step(
            jnp.asarray(bk.lens), jnp.asarray(bk.ev_off),
            jnp.asarray(ej.pack_events(bk.ev_w0, bk.ev_w1, jcfg)),
            cfg=jcfg)["packed"]
        assert got.dtype == torch.int32
        assert tuple(got.shape) == (bk.B, et.packed_width(cfg))
        _eq(want, got, f"W={bk.W}")
