"""The wide buckets of the corrected ultra-long ONT cell
(``perfbench/configs/ont_ul_human_30x.json``, ``ontul30x.whole``): at
8,192 reads its reads over 2,048 windows fill buckets of (2048, 4096),
(384, 8192) and (32, 32768), where the pileup takes its regime 2
(``pileup_stripes``) and ``scan_chop`` its cluster regime
(``scan_chop_cluster``) at the two widest. The launch plans pick those
regimes; ``compute_torch``'s ``engine.step`` span carries them; and on a
card both kernels equal their plain twins on buckets of those shapes,
with events drawn as the cell draws them. Imports nothing of JAX, so the
``cuda`` cases run on a card's machine."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raft_tpu_torch import engine_torch as et  # noqa: E402
from raft_tpu_torch.ops import _lib, pileup_cuda, scan_chop_cuda  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402

# the cell's flags: -r 50 -m 1.5 -p 10000 -l 20000 -f 1000 -v 500, -e 30
PARAMS = AlgoParams(est_cov=30, cov_mul=1.5, reso=50, repeat_length=10000,
                    interval_length=10000, read_length=20000,
                    flanking_length=1000, overlap_length=500)
# (B, W, reads used) of the cell's wide buckets; the 28 reads of the
# 16,384-window tier merge into the one read of 32,768 windows
WIDE_SHAPES = [(2048, 4096, 1579), (384, 8192, 331), (32, 32768, 29)]
# (pileup, scan_chop) regimes on a 132-SM H100
REGIMES = {(2048, 4096): (2, 1), (384, 8192): (2, 2), (32, 32768): (2, 2)}
MEDIAN, SIGMA, MEAN = 62_000, 0.70, 79_200   # the cell's read lengths
COVERAGE = 30


def wide_bucket(rng, B: int, W: int, used: int, params=PARAMS):
    """One wide bucket as the cell makes it: ``used`` reads whose windows
    fall in the tier (half the width to the width; a quarter for the
    merged widest), the rest padding. A read of length L gets
    Poisson(30 (L + mean) / mean) overlaps with reads of the cell's
    lengths, and one read in four a repeat of 10-50 kb with 2-10 copies'
    worth of extra overlaps: at 4,096 windows about 130 events a read,
    where the cell's generator gives 157 (median 84, 95th percentile
    433). Returns (cfg, lens int32 [B], ev_off int32 [B+1], packed
    events)."""
    reso = params.reso
    lo_w = W // 4 if W >= 32768 else W // 2
    lens = np.zeros(B, np.int32)
    lens[:used] = np.exp(rng.uniform(np.log(lo_w * reso + 1),
                                     np.log(W * reso), used))
    w0s, w1s, counts = [], [], np.zeros(B, np.int64)
    for r in range(used):
        L = int(lens[r])
        n = rng.poisson(COVERAGE * (L + MEAN) / MEAN)
        other = np.minimum(rng.lognormal(np.log(MEDIAN), SIGMA, n), 4 * L)
        t = rng.uniform(-other, L)
        lo = np.maximum(t, 0).astype(np.int64)
        hi = np.minimum(t + other, L).astype(np.int64) - 1
        if r % 4 == 0:
            u = int(rng.integers(10_000, 50_001))
            a = int(rng.integers(0, max(1, L - u)))
            k = COVERAGE * int(rng.integers(2, 11))
            lo = np.concatenate([lo, a + rng.integers(0, 500, k)])
            hi = np.concatenate(
                [hi, np.minimum(a + u - rng.integers(0, 500, k), L - 1)])
        keep = hi - lo >= 500
        w0s.append(lo[keep] // reso)
        w1s.append(hi[keep] // reso)
        counts[r] = keep.sum()
    tot = int(counts.sum())
    E = tot + 64                     # padding after ev_off[B], as buckets do
    w0 = np.zeros(E, np.int64)
    w1 = np.full(E, -1, np.int64)
    w0[:tot] = np.concatenate(w0s)
    w1[:tot] = np.concatenate(w1s)
    ev_off = np.zeros(B + 1, np.int32)
    ev_off[1:] = np.cumsum(counts)
    cfg = et.derive_cfg(B, W, E, params, cov_out="host")
    pk = et.pack_events(w0, w1, cfg)
    if pk.dtype == np.uint32:
        pk = pk.view(np.int32)
    return cfg, lens, ev_off, np.ascontiguousarray(pk)


@pytest.mark.parametrize("B,W,used", WIDE_SHAPES)
def test_launch_plans_of_the_cells_wide_buckets(B, W, used):
    cfg = et.derive_cfg(B, W, 64, PARAMS)
    got = (pileup_cuda.launch_plan(B, W, 132).regime,
           scan_chop_cuda.launch_plan(B, W, cfg.M, cfg.K, cfg.F, 132).regime)
    assert got == REGIMES[(B, W)]


def test_step_regime_attributes(monkeypatch):
    """``engine.step``'s regimes: the launch plans' for the card's SM
    count on a CUDA device, 0 on the CPU, where the plain twins run."""
    props = types.SimpleNamespace(multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    for (B, W), (pr, sr) in REGIMES.items():
        cfg = et.derive_cfg(B, W, 64, PARAMS)
        assert et._regimes(cfg, "cuda:0") == dict(pileup_regime=pr,
                                                  scan_chop_regime=sr)
        assert et._regimes(cfg, "cpu") == dict(pileup_regime=0,
                                               scan_chop_regime=0)


def test_drawn_bucket_is_cut_like_the_cells():
    """The drawn (384, 8192) bucket through the plain twins: repeats
    found, and most reads cut, several fragments each (the cell: 95% of
    reads cut, 4.46 fragments a read)."""
    B, W, used = WIDE_SHAPES[1]
    cfg, lens, ev_off, pk = wide_bucket(np.random.default_rng(1), B, W, used)
    out = et.unpack_out(et.device_step(
        torch.from_numpy(lens), torch.from_numpy(ev_off),
        torch.from_numpy(pk), cfg)["packed"].numpy(), cfg)
    assert out["rep_n"][:used].sum() > 0
    assert (out["n_frag"][:used] > 1).mean() > 0.9
    assert out["n_frag"][:used].mean() > 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,used", WIDE_SHAPES)
def test_wide_kernels_match_plain_on_cuda(B, W, used):
    """``pileup_stripes`` and ``scan_chop`` (its cluster regime at the two
    widest) against their plain twins on the card, exactly, on a bucket
    drawn like the cell's, in ``host`` and ``diff8`` mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, lens, ev_off, pk = wide_bucket(np.random.default_rng(B + W),
                                        B, W, used)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pileup_cuda.launch_plan(B, W, sms).regime == 2
    off_d, pk_d, lens_d = (torch.from_numpy(a).cuda()
                           for a in (ev_off, pk, lens))
    before = _lib.launch_counts()
    cov = pileup_cuda.pileup(off_d, pk_d, cfg)
    torch.cuda.synchronize()
    assert _lib.launch_counts(before) == {"pileup": 1, "scan_chop": 0}
    torch.testing.assert_close(cov, pileup_cuda.pileup_torch(off_d, pk_d,
                                                             cfg),
                               rtol=0, atol=0)
    for mode in ("host", "diff8"):
        c = dataclasses.replace(cfg, cov_out=mode)
        got = scan_chop_cuda.scan_chop(cov, lens_d, c)
        want = scan_chop_cuda.scan_chop_torch(cov, lens_d, c)
        torch.cuda.synchronize()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    out = et.unpack_out(got["packed"].cpu().numpy(), cfg)
    assert out["rep_n"].sum() > 0 and out["n_frag"][:used].mean() > 2
