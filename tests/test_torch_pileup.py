"""The pileup wrapper and its plain twin ``pileup_torch`` against the TPU
kernel (``pileup_pallas`` in interpret mode, as tests/test_pallas.py runs
it on the CPU) and against ``engine_jax.pileup_diff_scatter``, on the
shapes of tests/test_pallas.py; plus the kernel's build and dispatch
rules. Coverage is integer: the tolerance is exact equality."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raft_tpu import bucketing as jbucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.ops.pileup_pallas import EB, pileup_pallas  # noqa: E402
from raft_tpu.params import AlgoParams as JAlgoParams  # noqa: E402
from raft_tpu_torch import bucketing  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.ops import _lib, pileup_cuda  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402

PARAMS = AlgoParams(est_cov=10, reso=50)
JPARAMS = JAlgoParams(est_cov=10, reso=50)


def _wire(w0, w1, cfg):
    pk = et.pack_events(w0, w1, cfg)
    return torch.from_numpy(pk.view(np.int32) if pk.dtype == np.uint32
                            else pk)


def _jax_ref(rows, w0, w1, cfg):
    jcfg = ej.derive_cfg(cfg.B, cfg.W, cfg.E, JPARAMS)
    return np.asarray(ej.pileup_diff_scatter(
        jnp.asarray(rows), jnp.asarray(w0), jnp.asarray(w1), jcfg)[0]), jcfg


def _sorted_case(rng, n_reads, max_len):
    lens = rng.integers(1, max_len, n_reads).astype(np.int32)
    ev_read, ev_lo, ev_hi = [], [], []
    for r in range(n_reads):
        for _ in range(int(rng.integers(0, 40))):
            a = int(rng.integers(0, lens[r]))
            ev_read.append(r)
            ev_lo.append(a)
            ev_hi.append(int(rng.integers(a, lens[r] + 1)) - 1)
    ev_read = np.asarray(ev_read, dtype=np.int32)
    order = np.argsort(ev_read, kind="stable")
    return (lens, ev_read[order], np.asarray(ev_lo, np.int32)[order],
            np.asarray(ev_hi, np.int32)[order])


@pytest.mark.parametrize("seed", range(3))
def test_pileup_torch_multiblock(seed):
    """A dense 2-tile batch (several Pallas event blocks): pileup_torch ==
    pileup_pallas(interpret) == pileup_diff_scatter."""
    rng = np.random.default_rng(900 + seed)
    B, W, E = 256, 128, 4096
    cfg = et.derive_cfg(B, W, E, PARAMS)
    rows = np.sort(rng.integers(0, B, E)).astype(np.int32)
    w0 = rng.integers(0, W, E).astype(np.int32)
    w1 = (w0 + rng.integers(0, W - 1, E)).clip(max=W - 1).astype(np.int32)
    ev_off = torch.from_numpy(
        np.searchsorted(rows, np.arange(B + 1)).astype(np.int32))
    got = pileup_cuda.pileup_torch(ev_off, _wire(w0, w1, cfg), cfg)
    want, jcfg = _jax_ref(rows, w0, w1, cfg)
    pallas = np.asarray(pileup_pallas(jnp.asarray(rows), jnp.asarray(w0),
                                      jnp.asarray(w1), jcfg, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_reads,max_len", [(16, 8000), (130, 20000)])
def test_pileup_matches_pallas_and_scatter(seed, n_reads, max_len):
    """Every bucket through the wrapper (CPU tensors → pileup_torch) equals
    the scatter path; the Pallas-aligned ones equal the Pallas kernel."""
    rng = np.random.default_rng(seed)
    lens, ev_read, ev_lo, ev_hi = _sorted_case(rng, n_reads, max_len)
    for bk, jbk in zip(
            bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50),
            jbucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50),
            strict=True):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, PARAMS)
        _, ev_off, ev_pk = et.bucket_to_device(bk, cfg, "cpu")
        got = pileup_cuda.pileup(ev_off, ev_pk, cfg).numpy()
        want, jcfg = _jax_ref(jbk.ev_row, jbk.ev_w0, jbk.ev_w1, cfg)
        np.testing.assert_array_equal(got, want, err_msg=f"W={bk.W}")
        if bk.B % min(128, bk.B) or bk.W % 128:
            continue  # outside the Pallas kernel's tile constraints
        pallas = pileup_pallas(jnp.asarray(jbk.ev_row),
                               jnp.asarray(jbk.ev_w0),
                               jnp.asarray(jbk.ev_w1), jcfg, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas),
                                      err_msg=f"W={bk.W}")


@pytest.mark.parametrize("seed", range(2))
def test_pileup_matches_pallas_host_wrapper_path(seed):
    """Buckets quantized to the Pallas event block, Pallas tile edges taken
    from ev_off (its host-wrapper path): the port's pileup agrees."""
    rng = np.random.default_rng(300 + seed)
    lens, ev_read, ev_lo, ev_hi = _sorted_case(rng, 300, 20000)
    seen = False
    for bk, jbk in zip(
            bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50,
                                   e_quantum=EB),
            jbucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50,
                                    e_quantum=EB), strict=True):
        if bk.B % min(128, bk.B) or bk.W % 128:
            continue
        seen = True
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, PARAMS)
        _, ev_off, ev_pk = et.bucket_to_device(bk, cfg, "cpu")
        got = pileup_cuda.pileup(ev_off, ev_pk, cfg).numpy()
        jcfg = ej.derive_cfg(jbk.B, jbk.W, jbk.E, JPARAMS)
        pallas = pileup_pallas(jnp.asarray(jbk.ev_row),
                               jnp.asarray(jbk.ev_w0),
                               jnp.asarray(jbk.ev_w1), jcfg,
                               ev_off=jnp.asarray(jbk.ev_off), interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))
    assert seen


def _domain_ref(ev_off, w0, span, B, W):
    """Loop reference of the kernel's semantics: an event counts iff
    span >= 1 and 0 <= w0 < W; w1 = min(w0 + span - 1, W - 1)."""
    cov = np.zeros((B, W), dtype=np.int32)
    for b in range(B):
        for e in range(ev_off[b], ev_off[b + 1]):
            if span[e] >= 1 and 0 <= w0[e] < W:
                cov[b, w0[e]:min(w0[e] + span[e] - 1, W - 1) + 1] += 1
    return cov


@pytest.mark.parametrize("W", [64, 1 << 16])
def test_pileup_torch_kernel_domain(W):
    """Raw wire words outside what pack_events emits: spans past the row
    end clamp, w0 outside [0, W) (pairs) and span 0 drop, empty rows and
    padding after ev_off[B] contribute nothing — pack32 and pairs."""
    rng = np.random.default_rng(W)
    B, E = 8, 200
    counts = rng.integers(0, 40, B)
    counts[[1, 5]] = 0                                # empty rows
    ev_off = np.zeros(B + 1, dtype=np.int32)
    ev_off[1:] = np.cumsum(counts)
    assert ev_off[-1] < E                             # padding tail
    w0 = rng.integers(0, W, E).astype(np.int32)
    span = rng.integers(0, W // 2, E).astype(np.int32)
    span[::7] = 0
    cfg = et.derive_cfg(B, W, E, PARAMS)
    if cfg.ev_pack == 0:
        w0[::5] = rng.integers(-W, 2 * W, len(w0[::5]))
        pk = np.stack([w0, span], axis=1)
    else:
        k = int(W - 1).bit_length()
        pk = (w0.view(np.uint32) | (span.view(np.uint32) << np.uint32(k))
              ).view(np.int32)
    got = pileup_cuda.pileup(torch.from_numpy(ev_off),
                             torch.from_numpy(np.ascontiguousarray(pk)), cfg)
    np.testing.assert_array_equal(got.numpy(),
                                  _domain_ref(ev_off, w0, span, B, W))


def test_pileup_wrapper_rejects_bad_inputs():
    """Wrong dtype, shape or device raise; a tensor that is neither CPU
    nor CUDA is refused rather than sent to the plain path."""
    cfg = et.derive_cfg(8, 64, 16, PARAMS)
    off = torch.zeros(9, dtype=torch.int32)
    pk = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        pileup_cuda.pileup(off.to(torch.int16), pk, cfg)
    with pytest.raises(ValueError):
        pileup_cuda.pileup(off, torch.zeros(15, dtype=torch.int32), cfg)
    with pytest.raises(ValueError):
        pileup_cuda.pileup(off, torch.zeros(32, dtype=torch.int32)[::2], cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pileup_cuda.pileup(off.to("meta"), pk.to("meta"), cfg)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """With no nvcc the build raises a clear error, naming every kernel
    source of the one library, and produces nothing — it never hands back
    the plain version in the kernel's place."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_lib, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="nvcc not found") as e:
        _lib.build_kernels(build_dir=str(out))
    assert "pileup.cu, scan_chop.cu" in str(e.value)
    assert not out.exists()


# The 32k bench path's bucket shapes (PERF.md section 5) and widths at the
# edges of each regime and of the TMA store.
BUCKET_SHAPES = [(512, 128), (3072, 256), (4096, 512), (384, 512),
                 (4096, 1024), (384, 1024), (8, 2048)]
EDGE_SHAPES = [(1, 1), (5, 3), (9, 5), (33, 7), (3, 2049), (2, 3000),
               (2, 3628), (2, 3629), (3, 4096), (2, 65538), (2, 65540),
               (1, 100_001)]


def _plan_cover(plan, B, W):
    """How many times the kernels, indexed as csrc/pileup.cu indexes
    them, write each (row, window) under ``plan``."""
    cover = np.zeros((B, W), dtype=np.int32)
    if plan.regime == 1:
        warps = plan.block // 32
        step = plan.grid[0] * warps
        for first in range(step):                  # blockIdx.x * 8 + warp
            cover[first:B:step] += 1
        return cover
    share = plan.stripe // 32                      # one warp's windows
    for y in range(plan.grid[1]):
        s0 = y * plan.stripe
        n = min(W - s0, plan.stripe)
        for warp in range(32):
            lo = warp * share
            cover[:plan.grid[0], s0 + lo:s0 + lo + max(0, min(n - lo, share))
                  ] += 1
    return cover


@pytest.mark.parametrize("sms", [132, 114])
def test_launch_plan_covers_every_window_once(sms):
    """Every (row, window) of a bucket is written exactly once, shared
    memory stays within a block's 232,448 bytes, rows not 16-byte aligned
    (W % 4 != 0) take the int-store path, and the grid and stripe respect
    the kernels' assumptions; on the synthetic shapes of chip_smoke.py,
    the 32k bench path's buckets and the regime and alignment edges."""
    import chip_smoke
    shapes = ([(B, W) for B, W, _, _ in chip_smoke.KERNEL_CASES]
              + BUCKET_SHAPES + EDGE_SHAPES)
    regimes = set()
    for B, W in shapes:
        plan = pileup_cuda.launch_plan(B, W, sms)
        regimes.add(plan.regime)
        assert (_plan_cover(plan, B, W) == 1).all(), (B, W, plan)
        assert 0 < plan.smem <= pileup_cuda.SMEM_MAX, (B, W, plan)
        assert plan.tma_store == (W % 4 == 0), (B, W, plan)
        assert plan.smem % 16 == 0
        if plan.regime == 1:
            stride = plan.smem // (4 * 2 * pileup_cuda.R1_WARPS)
            assert stride >= W + 1 and stride % 4 == 0
            assert plan.block == 32 * pileup_cuda.R1_WARPS
            assert plan.grid[1] == 1 and plan.stripe == W
            assert plan.grid[0] <= sms * 64 // pileup_cuda.R1_WARPS
        else:
            assert plan.block == 1024 and plan.grid[0] == B
            assert plan.stripe % pileup_cuda.R2_ALIGN == 0
            assert plan.stripe <= pileup_cuda.STRIPE
            assert plan.smem >= (plan.stripe + 1) * 4
            assert (plan.smem + pileup_cuda.R2_STATIC_SMEM
                    <= pileup_cuda.SMEM_MAX)
            assert plan.grid[1] <= 65535
    assert regimes == {1, 2}
    for B, W in BUCKET_SHAPES:  # regime 2 only for a few wide rows
        plan = pileup_cuda.launch_plan(B, W, sms)
        assert plan.regime == (2 if B <= 8 and W >= 2048 else 1)


@pytest.mark.parametrize("sms", [1, 8, 16, 66, 78, 108, 132, 144])
@pytest.mark.parametrize("B,W", [(4096, 512), (384, 1024), (8, 2048), (5, 3),
                                 (33, 7), (8, 1 << 16), (2, 65538),
                                 (3, 100_001), (8, 1 << 20)])
def test_launch_plan_tuning_inputs_keep_the_cover(sms, B, W):
    """The plan's one tuning input, the card's SM count, keeps the cover:
    on cards from 1 to 144 SMs every window is written once, the grid
    stays within the resident blocks, and regime 2's stripes stay
    aligned, between MIN_STRIPE (or the whole row) and STRIPE."""
    plan = pileup_cuda.launch_plan(B, W, sms)
    assert (_plan_cover(plan, B, W) == 1).all(), (B, W, plan)
    assert plan.smem <= pileup_cuda.SMEM_MAX
    if plan.regime == 1:
        assert plan.grid[0] <= sms * pileup_cuda.R1_BLOCKS_PER_SM
    else:
        assert plan.stripe % pileup_cuda.R2_ALIGN == 0
        assert (min(pileup_cuda.MIN_STRIPE, -(-W // 128) * 128)
                <= plan.stripe <= pileup_cuda.STRIPE), (B, W, sms, plan)


def test_launch_plan_regime2_fills_the_card():
    """A wide bucket of few rows gets stripes narrow enough to give every
    SM a block, down to MIN_STRIPE; many rows keep the widest stripe."""
    p = pileup_cuda.launch_plan(8, 1 << 16, 132)
    assert p.regime == 2 and p.stripe == pileup_cuda.MIN_STRIPE
    p = pileup_cuda.launch_plan(8, 1 << 20, 132)
    assert p.stripe == pileup_cuda.STRIPE and 8 * p.grid[1] >= 132
    p = pileup_cuda.launch_plan(200, 1 << 16, 132)
    assert p.stripe == pileup_cuda.STRIPE


@pytest.mark.cuda
def test_pileup_kernel_matches_plain_on_cuda():
    """The hand-written kernel against pileup_torch on the card, exact:
    pack32 at a main-path shape, a W=64 tail, widths that take the int
    store (W % 4 != 0) in both regimes and a multi-stripe pairs tier,
    with empty rows, invalid events and padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    for B, W in ((384, 256), (8, 64), (33, 7), (3, 2049), (2, 65538),
                 (8, 1 << 16)):
        E = B * 40
        counts = rng.integers(0, 60, B)
        counts[::3] = 0
        counts = np.minimum(counts, (E - 1) // B)
        ev_off = np.zeros(B + 1, dtype=np.int32)
        ev_off[1:] = np.cumsum(counts)
        w0 = rng.integers(0, W, E)
        w1 = np.where(rng.random(E) < 0.1, -1, w0 + rng.integers(0, W, E))
        cfg = et.derive_cfg(B, W, E, PARAMS)
        off = torch.from_numpy(ev_off).cuda()
        pk = _wire(w0, w1, cfg).cuda()
        before = _lib.launch_counts()
        got = pileup_cuda.pileup(off, pk, cfg)
        torch.cuda.synchronize()
        assert _lib.launch_counts(before) == {"pileup": 1, "scan_chop": 0}
        torch.testing.assert_close(got, pileup_cuda.pileup_torch(off, pk, cfg),
                                   rtol=0, atol=0)

