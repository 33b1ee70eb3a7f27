"""The device step after the pileup: ``scan_chop_torch`` and the
``scan_chop`` wrapper (CPU tensors, so its plain twin) against
``engine_jax.repeat_scan`` -> ``chop_markers`` -> the packing of
``device_step_impl``, and against ``engine_jax.device_step`` itself, on
the CPU; plus the kernel's launch plan and the wrapper's input checks.
Every compared array is integer, so the tolerance is exact equality.

The rows cover what the hand-written kernel has to reproduce: unused
repeat slots and fragment columns, padding rows (``lens`` 0), whole rows
(negative ``extra``), coverage past a read's last window, ``div`` 1,
``-f 0`` and a flank larger than a read, a flank whose products wrap
int32 (so a row's repeat slots are out of order), many marker candidates
and many repeat slots, more qualifying runs than slots, and ``diff8`` rows
that overflow int8."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from raft_tpu import bucketing as jbucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.params import AlgoParams as JAlgoParams  # noqa: E402
from raft_tpu_torch import bucketing  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.ops import _lib, scan_chop_cuda  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402
from test_kernels import rand_case  # noqa: E402

BENCH = dict(repeat_length=10000, interval_length=10000, read_length=20000,
             flanking_length=1000, overlap_length=500)
# (label, AlgoParams fields): the bench flags and the corners of the slot
# arithmetic; est_cov 4 and cov_mul 1.5 give high_cov 6
PARAM_SETS = [
    ("bench", BENCH),
    ("small_p", dict(repeat_length=100, interval_length=100,
                     read_length=300, flanking_length=50,
                     overlap_length=20)),        # M in the hundreds
    ("rl_eq_reso", dict(repeat_length=50, interval_length=500,
                        read_length=1000, flanking_length=100,
                        overlap_length=100)),    # K = (W+1)//2 + 1
    ("f0_div1", dict(repeat_length=400, interval_length=700,
                     read_length=700, flanking_length=0,
                     overlap_length=0)),         # -f 0, div 1, -v 0
    ("flank_gt_read", dict(repeat_length=300, interval_length=1000,
                           read_length=2500, flanking_length=50000,
                           overlap_length=300)),
    ("flank_wraps", dict(repeat_length=150, interval_length=400,
                         read_length=900, flanking_length=2**31 - 1 - 4000,
                         overlap_length=400)),   # (w+1)*reso + flank wraps
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_cfg(tcfg):
    """The JAX cfg with the same shapes, wire format and parameters."""
    return ej.StaticCfg(**dataclasses.asdict(tcfg), use_pallas=False)


def _jax_after_pileup(cov, lens, jcfg) -> dict:
    """``engine_jax.device_step_impl`` from its coverage on: repeat_scan,
    chop_markers, the diff8 branch (the diff of the Pallas branch, which
    equals the scatter's) and the packing concatenate."""
    cov, lens = jnp.asarray(cov), jnp.asarray(lens)
    rep_s, rep_e, rep_n, rep_len_sum = ej.repeat_scan(cov, lens, jcfg)
    frags = ej.chop_markers(lens, rep_s, rep_e, jcfg)
    out = {}
    if jcfg.cov_out == "diff8":
        diff = jnp.diff(cov, axis=1, prepend=0)
        ok8 = (jnp.max(diff, axis=1) <= 127) & (jnp.min(diff, axis=1) >= -128)
        out["diff8"] = diff.astype(jnp.int8)
    else:
        ok8 = jnp.ones(jcfg.B, dtype=jnp.bool_)
    out["packed"] = jnp.concatenate(
        [rep_s, rep_e, frags["char_start"], frags["char_len"],
         rep_n[:, None], rep_len_sum[:, None], frags["n_frag"][:, None],
         frags["whole"][:, None].astype(jnp.int32),
         ok8[:, None].astype(jnp.int32)], axis=1)
    return out


def _rows(rng, B, W, cfg):
    """A bucket's coverage and lengths with every kind of row
    (``chip_smoke.crafted_rows``, which the card's check uses too)."""
    from chip_smoke import crafted_rows
    return crafted_rows(np, rng, B, W, cfg)


def _cfg(B, W, fields, mode):
    params = AlgoParams(est_cov=4, cov_mul=1.5, **fields)
    return et.derive_cfg(B, W, 64, params, cov_out=mode)


def _assert_equal(got: dict, want: dict, msg=""):
    assert set(got) == set(want), msg
    for k in want:
        assert got[k].dtype == {"packed": torch.int32,
                                "diff8": torch.int8}[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{msg} {k}")


@pytest.mark.parametrize("mode", ["host", "diff8"])
@pytest.mark.parametrize("W", [64, 257])
@pytest.mark.parametrize("label,fields", PARAM_SETS,
                         ids=[p[0] for p in PARAM_SETS])
def test_scan_chop_matches_jax(label, fields, W, mode):
    """The wrapper on CPU tensors and its plain twin equal engine_jax's
    stages and packing, every column, on rows of every kind."""
    rng = np.random.default_rng(W + len(label))
    B = 20
    cfg = _cfg(B, W, fields, mode)
    cov, lens = _rows(rng, B, W, cfg)
    want = _jax_after_pileup(cov, lens, _jax_cfg(cfg))
    got = scan_chop_cuda.scan_chop(_t(cov), _t(lens), cfg)
    _assert_equal(got, want, label)
    _assert_equal(scan_chop_cuda.scan_chop_torch(_t(cov), _t(lens), cfg),
                  want, label)
    out = et.unpack_out(got["packed"].numpy(), cfg)
    # the corners these rows exist for did occur
    assert (lens == 0).any() and out["whole"][lens == 0].all()
    assert (out["rep_n"] == 0).any()
    assert (out["rep_n"] > 0).any() or cfg.repeat_length > W * cfg.reso
    if mode == "diff8":
        assert not out["ok8"].all() and out["ok8"].any()
    else:
        assert out["ok8"].all()


def test_scan_chop_more_runs_than_slots_and_wrapped_slots():
    """Hand-made rows: more qualifying runs than K slots (rep_n counts
    them all, the slots keep the first K), and a flank whose products
    wrap int32 so that a row's rep_e goes down (the kernel's linear-scan
    case)."""
    B, W = 4, 64
    fields = dict(repeat_length=100, interval_length=200, read_length=400,
                  flanking_length=10, overlap_length=0)
    cfg = dataclasses.replace(_cfg(B, W, fields, "host"), K=5)
    cov = np.zeros((B, W), dtype=np.int32)
    cov[:, ::3] = cfg.high_cov
    cov[:, 1::3] = cfg.high_cov  # 21 two-window runs a row, then one
    lens = np.full(B, W * cfg.reso, dtype=np.int32)
    lens[3] = 0
    for c in (cfg, dataclasses.replace(cfg, flank=2**31 - 1 - 400)):
        want = _jax_after_pileup(cov, lens, _jax_cfg(c))
        got = scan_chop_cuda.scan_chop(_t(cov), _t(lens), c)
        _assert_equal(got, want)
        out = et.unpack_out(got["packed"].numpy(), c)
        assert (out["rep_n"][:3] == 21).all() and out["rep_n"][3] == 0
    rep_e = out["rep_e"][0]
    assert (np.diff(rep_e.astype(np.int64)) < 0).any()  # out of order


@pytest.mark.parametrize("mode", ["host", "diff8", "cov"])
@pytest.mark.parametrize("seed", range(3))
def test_device_step_matches_jax_device_step(seed, mode):
    """Events in, the whole step out: ``engine_torch.device_step`` (the
    pileup, then scan_chop) against the jitted ``engine_jax.device_step``
    with use_pallas=False, each engine fed its own wire format from the
    same bucket."""
    rng = np.random.default_rng(50 + seed)
    kw = dict(est_cov=3, cov_mul=1.2, repeat_length=300, interval_length=600,
              read_length=1200, overlap_length=100, flanking_length=200)
    lens, ev_read, ev_lo, ev_hi = rand_case(rng, n_reads=30, max_len=20000,
                                            max_ev_per_read=60)
    for bk, jbk in zip(bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50),
                       jbucketing.make_buckets(lens, ev_read, ev_lo, ev_hi,
                                               50), strict=True):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, AlgoParams(**kw), cov_out=mode)
        got = et.device_step(*et.bucket_to_device(bk, cfg, "cpu"), cfg=cfg)
        jcfg = ej.derive_cfg(jbk.B, jbk.W, jbk.E, JAlgoParams(**kw),
                             use_pallas=False, cov_out=mode)
        want = ej.device_step(
            jnp.asarray(jbk.lens), jnp.asarray(jbk.ev_off),
            jnp.asarray(ej.pack_events(jbk.ev_w0, jbk.ev_w1, jcfg)),
            cfg=jcfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"W={bk.W} {k}")


@settings(max_examples=25, deadline=None, database=None)
@given(reso=st.integers(1, 120), rl=st.integers(1, 5000),
       il=st.integers(1, 3000), div=st.integers(1, 4),
       flank=st.integers(0, 10000), ov_frac=st.floats(0, 1),
       mode=st.sampled_from(["host", "diff8"]), seed=st.integers(0, 2**32 - 1))
def test_scan_chop_property(reso, rl, il, div, flank, ov_frac, mode, seed):
    """For any valid (reso, repeat_length, interval_length, read_length,
    flank, overlap) and random rows, the wrapper equals engine_jax."""
    rng = np.random.default_rng(seed)
    B, W = 10, 48
    fields = dict(reso=reso, repeat_length=rl, interval_length=il,
                  read_length=div * il, flanking_length=flank,
                  overlap_length=int(ov_frac * il))
    cfg = _cfg(B, W, fields, mode)
    cov, lens = _rows(rng, B, W, cfg)
    _assert_equal(scan_chop_cuda.scan_chop(_t(cov), _t(lens), cfg),
                  _jax_after_pileup(cov, lens, _jax_cfg(cfg)))


SHAPES = [(4096, 512), (1536, 1024), (8, 1 << 20), (64, 4096), (33, 7), (1, 1),
          (5, 100_001), (2, 64), (8, 2048), (1024, 8192), (64, 65536)]


def _plan_fits_rows(B, W, M, K, F):
    """Where launch_plan must take regime 1, from its documented rule."""
    sc = scan_chop_cuda
    return (W <= sc.NARROW_W and M <= sc.ROWS_MAX_M
            and sc.ROWS_WARPS * (2 * K + 2 * F + 5 + M) * 4 <= sc.ROWS_SMEM
            and (W < sc.FEW_ROWS_W or B >= sc.ROWS_PER_SM * sc.H100_SMS))


@pytest.mark.parametrize("label,fields", PARAM_SETS,
                         ids=[p[0] for p in PARAM_SETS])
@pytest.mark.parametrize("B,W", SHAPES)
def test_launch_plan(B, W, label, fields):
    """For the sweep's (M, K, F) at each shape: the regime the rule names;
    whole warps and a cluster of at most 16 blocks that divides the grid;
    tiles (and, in regime 2, the warps' segments and the blocks' marker
    shares) that cover the row; shared memory within the card's 232,448
    bytes; the global-memory branch exactly where K slots or a block's
    survivors do not fit."""
    sc = scan_chop_cuda
    cfg = _cfg(B, W, fields, "host")
    M, K, F = cfg.M, cfg.K, cfg.F
    p = sc.launch_plan(B, W, M, K, F)
    assert p.block % 32 == 0 and p.smem <= sc.SMEM_MAX
    assert 1 <= p.cluster <= 16 and p.grid % p.cluster == 0
    assert p.tile == 4 * sc.TILE and p.seg % sc.TILE == 0
    assert p.vec == (W % 4 == 0)
    assert (p.regime == 1) == _plan_fits_rows(B, W, M, K, F)
    if p.regime == 1:
        assert p.block == 32 * p.rows_per_block and p.cluster == 1
        assert p.grid * p.rows_per_block >= B > (p.grid - 1) * p.rows_per_block
        assert W <= p.seg < W + sc.TILE          # one warp walks the row
        assert p.slice == 2 * K + 2 * F + 5 + M and p.stars_smem
        assert p.smem == 4 * p.rows_per_block * p.slice
        return
    nw = p.block // 32
    assert 1 <= nw <= sc.WIDE_WARPS and p.grid == B * p.cluster
    segs = p.cluster * nw
    assert segs * p.seg >= W > segs * (p.seg - sc.TILE)  # whole tiles, no spare
    assert p.cluster * p.mc >= M > p.cluster * (p.mc - 1)
    assert p.stars_smem == (p.mc <= sc.STARS_CAP)
    kept = p.mc if p.stars_smem else 0
    fits = 4 * (sc.WIDE_FIXED + 2 * K + kept) <= sc.WIDE_SMEM
    assert (p.slot_cap == K) == fits and p.slot_cap <= K
    assert p.smem == 4 * (sc.WIDE_FIXED + 2 * p.slot_cap + kept)
    assert 4 * (sc.WIDE_FIXED + 2 * (p.slot_cap + 1) + kept) > sc.WIDE_SMEM \
        or p.slot_cap == K


@pytest.mark.parametrize("B,W,want", [
    (4096, 512, dict(regime=1, grid=512, block=256, slice=23)),
    (8, 2048, dict(regime=1, grid=1, block=256)),
    (1024, 8192, dict(regime=1, grid=128, block=256)),
    (256, 8192, dict(regime=2, cluster=2, block=128, seg=1024)),
    (8, 1 << 20, dict(regime=2, grid=128, block=512, cluster=16, seg=4096,
                      slot_cap=5217, mc=328, stars_smem=True)),
    (64, 65536, dict(regime=2, grid=512, block=256, cluster=8, seg=1024)),
    (8, 8192, dict(regime=2, cluster=8, block=32, seg=1024)),
])
def test_launch_plan_main_shapes(B, W, want):
    """The bench flags' plans at the main path's shapes: a warp per row
    for the 32k buckets (8 rows a block, the (4096, 512) bucket's packed
    row and survivors in 23 ints of shared memory a warp); the
    ultralong (8, 2^20) tier a cluster of 16 blocks of 512 threads per
    row (128 blocks), 4,096 windows a warp, every slot and survivor on
    chip; wide buckets of more rows fewer blocks per row, and 8,192
    windows a warp per row only from four rows an SM."""
    params = AlgoParams(est_cov=20, cov_mul=1.5, **BENCH)
    cfg = et.derive_cfg(B, W, 64, params)
    p = scan_chop_cuda.launch_plan(B, W, cfg.M, cfg.K, cfg.F)
    assert {k: getattr(p, k) for k in want} == want


def _wrap(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _part_agg(high, lo, hi, reso, rl):
    """The kernel's aggregate of the run boundaries that lie in windows
    [lo, hi) of a row (boundary w between windows w-1 and w; the one at
    the row's end belongs to its last part): (last run start or -1, the
    one run end whose start lies before lo or -1, the qualifying runs
    that start and end inside, their length sum, wrapping)."""
    W = len(high)
    last, open_end, n_q, len_sum = -1, -1, 0, 0
    for w in range(lo, hi + (1 if hi == W else 0)):
        prev = w >= 1 and high[w - 1]
        cur = w < W and high[w]
        if prev and not cur:
            if last < 0:
                open_end = w - 1
            else:
                span = _wrap((w - last) * reso)
                if span >= rl:
                    n_q, len_sum = n_q + 1, _wrap(len_sum + span)
        if cur and not prev:
            last = w
    return last, open_end, n_q, len_sum


def _combine(a, b, reso, rl):
    """Part a, then part b right after it (csrc/scan_chop.cu ``combine``)."""
    last = b[0] if b[0] >= 0 else a[0]
    open_end, n_q, len_sum = a[1], a[2] + b[2], _wrap(a[3] + b[3])
    if b[1] >= 0:
        if a[0] >= 0:
            span = _wrap((b[1] - a[0] + 1) * reso)
            if span >= rl:
                n_q, len_sum = n_q + 1, _wrap(len_sum + span)
        else:
            assert a[1] < 0  # after a's open end, a stays low
            open_end = b[1]
    return last, open_end, n_q, len_sum


def _carried_scan(high, lens_b, cuts, per_block, cfg):
    """repeat_scan of one row, part by part as the cluster regime runs it:
    each part's (a warp's) aggregate; each block's fold of its
    ``per_block`` parts from the identity; the fold of the blocks'
    aggregates, which gives each block its carry-in, and from it each
    part's; then a second walk of each part from its carry that writes
    its qualifying runs into their slots."""
    K, reso, rl, flank = cfg.K, cfg.reso, cfg.repeat_length, cfg.flank
    ident = (-1, -1, 0, 0)
    bounds = [0, *cuts, len(high)]
    parts = list(zip(bounds[:-1], bounds[1:]))
    aggs = [_part_agg(high, lo, hi, reso, rl) for lo, hi in parts]
    blocks = [aggs[i:i + per_block] for i in range(0, len(aggs), per_block)]
    blk_aggs = []
    for blk in blocks:
        t = ident
        for a in blk:
            t = _combine(t, a, reso, rl)
        blk_aggs.append(t)
    before, carries = ident, []
    for blk, t in zip(blocks, blk_aggs):
        inner = before
        for a in blk:
            carries.append(inner)
            inner = _combine(inner, a, reso, rl)
        before = _combine(before, t, reso, rl)
        assert inner == before  # the two folds agree
    assert before[1] == -1  # every run starts inside the row
    rep_s, rep_e = np.ones(K, np.int32), np.zeros(K, np.int32)
    W = len(high)
    for (lo, hi), (start, _, rank, _) in zip(parts, carries):
        for w in range(lo, hi + (1 if hi == W else 0)):
            prev = w >= 1 and high[w - 1]
            cur = w < W and high[w]
            if prev and not cur:
                span = _wrap((w - start) * reso)
                if span >= rl:
                    if rank < K:
                        rep_s[rank] = max(_wrap(start * reso - flank), 0)
                        rep_e[rank] = min(_wrap(w * reso + flank),
                                          int(lens_b))
                    rank += 1
            if cur and not prev:
                start = w
    return rep_s, rep_e, before[2], before[3]


@pytest.mark.parametrize("label,fields", PARAM_SETS,
                         ids=[p[0] for p in PARAM_SETS])
@pytest.mark.parametrize("seed", range(2))
def test_carry_model_matches_repeat_scan(seed, label, fields):
    """The cross-tile / cross-block carry of the kernel's cluster regime,
    modelled in numpy, equals ``engine_jax.repeat_scan`` (slots, rep_n,
    rep_len_sum) on rows of every kind cut into parts at random tile
    boundaries and at random windows, so that runs span whole parts and
    parts hold no boundary at all; the parts are grouped into blocks of
    one to three."""
    rng = np.random.default_rng(100 + seed)
    B, W = 12, 96 + 37 * seed
    cfg = _cfg(B, W, fields, "host")
    cfg = dataclasses.replace(cfg, K=min(cfg.K, 4 + seed))  # rep_n > K too
    cov, lens = _rows(rng, B, W, cfg)
    cov[1] = cfg.high_cov  # high throughout
    lens[1] = W * cfg.reso
    rep_s, rep_e, rep_n, rep_len_sum = (
        np.asarray(x) for x in ej.repeat_scan(jnp.asarray(cov),
                                              jnp.asarray(lens),
                                              _jax_cfg(cfg)))
    n_win = -(-lens.astype(np.int64) // cfg.reso)
    high = (cov >= cfg.high_cov) & (np.arange(W)[None, :] < n_win[:, None])
    for b in range(B):
        for tile in (1, 4, 16):
            n = int(rng.integers(0, W // tile + 1))
            cuts = sorted(set(int(c) * tile for c in
                              rng.integers(1, max(2, -(-W // tile)), n))
                          - {0, W})
            cuts = [c for c in cuts if c < W]
            got = _carried_scan(high[b], lens[b], cuts,
                                int(rng.integers(1, 4)), cfg)
            np.testing.assert_array_equal(got[0], rep_s[b], f"{b} {cuts}")
            np.testing.assert_array_equal(got[1], rep_e[b], f"{b} {cuts}")
            assert (got[2], got[3]) == (rep_n[b], rep_len_sum[b])


def test_scan_chop_wrapper_rejects_bad_inputs():
    """Wrong dtype, shape, device pairing, cov_out or an out-of-range
    parameter raise; a tensor that is neither CPU nor CUDA is refused
    rather than sent to the plain path."""
    cfg = et.derive_cfg(8, 64, 16, AlgoParams(est_cov=4))
    cov = torch.zeros((8, 64), dtype=torch.int32)
    lens = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        scan_chop_cuda.scan_chop(cov.to(torch.int64), lens, cfg)
    with pytest.raises(TypeError):
        scan_chop_cuda.scan_chop(cov, lens.to(torch.int16), cfg)
    with pytest.raises(ValueError):
        scan_chop_cuda.scan_chop(cov[:, :63], lens, cfg)
    with pytest.raises(ValueError):
        scan_chop_cuda.scan_chop(cov, lens[:7], cfg)
    with pytest.raises(ValueError, match="cov_out"):
        scan_chop_cuda.scan_chop(cov, lens,
                                 dataclasses.replace(cfg, cov_out="int4"))
    with pytest.raises(ValueError, match="int32"):
        scan_chop_cuda.scan_chop(cov, lens,
                                 dataclasses.replace(cfg, flank=2**31))
    with pytest.raises(ValueError, match="cov on"):
        scan_chop_cuda.scan_chop(cov, lens.to("meta"), cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        scan_chop_cuda.scan_chop(cov.to("meta"), lens.to("meta"), cfg)


def test_plain_path_launches_nothing():
    """CPU tensors run the plain twin and leave the launch count alone."""
    cfg = et.derive_cfg(8, 64, 16, AlgoParams(est_cov=4))
    before = _lib.launch_counts()
    scan_chop_cuda.scan_chop(torch.zeros((8, 64), dtype=torch.int32),
                             torch.zeros(8, dtype=torch.int32), cfg)
    assert set(_lib.launch_counts(before).values()) == {0}


@pytest.mark.parametrize("entry", sorted(_lib.ENTRY_POINTS))
def test_library_entry_points_match_the_sources(entry):
    """Each C entry point the one library declares exists in csrc/*.cu
    with the same arguments: a pointer (``void*``) where ctypes passes
    c_void_p, an ``int`` where it passes c_int."""
    import ctypes
    import re
    src = "".join(open(f).read() for f in _lib.sources())
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
             for a in m.group(1).split(",")]
    assert kinds == _lib.ENTRY_POINTS[entry]


@pytest.mark.cuda
def test_scan_chop_kernel_matches_plain_on_cuda():
    """The hand-written kernel against scan_chop_torch on the card, exact,
    on rows of every kind for every parameter set, in both modes, and at
    a width whose rows take more than one tile of markers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    for label, fields in PARAM_SETS:
        for W in (7, 64, 257, 4096):
            for mode in ("host", "diff8"):
                cfg = _cfg(24, W, fields, mode)
                cov, lens = _rows(rng, 24, W, cfg)
                cov_d, lens_d = _t(cov).cuda(), _t(lens).cuda()
                before = _lib.launch_counts()
                got = scan_chop_cuda.scan_chop(cov_d, lens_d, cfg)
                torch.cuda.synchronize()
                assert _lib.launch_counts(before) == {"pileup": 0,
                                                      "scan_chop": 1}
                want = scan_chop_cuda.scan_chop_torch(cov_d, lens_d, cfg)
                for k in want:
                    torch.testing.assert_close(got[k], want[k], rtol=0,
                                               atol=0, msg=f"{label} {W} {k}")
