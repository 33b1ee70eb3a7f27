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

from raft_tpu import bucketing  # noqa: E402
from raft_tpu import engine_jax as ej  # noqa: E402
from raft_tpu.ops.pileup_pallas import EB, pileup_pallas  # noqa: E402
from raft_tpu.params import AlgoParams  # noqa: E402
from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.ops import pileup_cuda  # noqa: E402

PARAMS = AlgoParams(est_cov=10, reso=50)


def _wire(w0, w1, cfg):
    pk = et.pack_events(w0, w1, cfg)
    return torch.from_numpy(pk.view(np.int32) if pk.dtype == np.uint32
                            else pk)


def _jax_ref(rows, w0, w1, cfg):
    jcfg = ej.derive_cfg(cfg.B, cfg.W, cfg.E, PARAMS)
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
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50):
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, PARAMS)
        _, ev_off, ev_pk = et.bucket_to_device(bk, cfg, "cpu")
        got = pileup_cuda.pileup(ev_off, ev_pk, cfg).numpy()
        want, jcfg = _jax_ref(bk.ev_row, bk.ev_w0, bk.ev_w1, cfg)
        np.testing.assert_array_equal(got, want, err_msg=f"W={bk.W}")
        if bk.B % min(128, bk.B) or bk.W % 128:
            continue  # outside the Pallas kernel's tile constraints
        pallas = pileup_pallas(jnp.asarray(bk.ev_row), jnp.asarray(bk.ev_w0),
                               jnp.asarray(bk.ev_w1), jcfg, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas),
                                      err_msg=f"W={bk.W}")


@pytest.mark.parametrize("seed", range(2))
def test_pileup_matches_pallas_host_wrapper_path(seed):
    """Buckets quantized to the Pallas event block, Pallas tile edges taken
    from ev_off (its host-wrapper path): the port's pileup agrees."""
    rng = np.random.default_rng(300 + seed)
    lens, ev_read, ev_lo, ev_hi = _sorted_case(rng, 300, 20000)
    seen = False
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50,
                                     e_quantum=EB):
        if bk.B % min(128, bk.B) or bk.W % 128:
            continue
        seen = True
        cfg = et.derive_cfg(bk.B, bk.W, bk.E, PARAMS)
        _, ev_off, ev_pk = et.bucket_to_device(bk, cfg, "cpu")
        got = pileup_cuda.pileup(ev_off, ev_pk, cfg).numpy()
        jcfg = ej.derive_cfg(bk.B, bk.W, bk.E, PARAMS)
        pallas = pileup_pallas(jnp.asarray(bk.ev_row), jnp.asarray(bk.ev_w0),
                               jnp.asarray(bk.ev_w1), jcfg,
                               ev_off=jnp.asarray(bk.ev_off), interpret=True)
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
    """With no nvcc the build raises a clear error and produces nothing —
    it never hands back the plain version in the kernel's place."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(pileup_cuda, "DEFAULT_CUDA_HOME",
                        str(tmp_path / "no-cuda"))
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pileup_cuda.build_kernels(build_dir=str(out))
    assert not out.exists()


@pytest.mark.cuda
def test_pileup_kernel_matches_plain_on_cuda():
    """The hand-written kernel against pileup_torch on the card, exact:
    pack32 at a main-path shape, a W=64 tail and a multi-stripe pairs
    tier, with empty rows, invalid events and padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    for B, W in ((384, 256), (8, 64), (8, 1 << 16)):
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
        before = pileup_cuda.launches
        got = pileup_cuda.pileup(off, pk, cfg)
        torch.cuda.synchronize()
        assert pileup_cuda.launches == before + 1
        torch.testing.assert_close(got, pileup_cuda.pileup_torch(off, pk, cfg),
                                   rtol=0, atol=0)

