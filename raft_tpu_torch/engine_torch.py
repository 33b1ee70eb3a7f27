"""PyTorch device engine: the three RAFT compute stages over dense
``[B, W]`` batches, the counterpart of ``raft_tpu/engine_jax.py``.

Every public stage keeps the JAX engine's name, argument order and
column layout, so each is held against its ``engine_jax`` twin on the
same inputs (``tests/test_torch_stages.py``). The stages are plain
PyTorch on tensors of any device; ``device_step`` routes the coverage
pileup through ``raft_tpu_torch.ops.pileup_cuda.pileup``, which launches
the hand-written Hopper kernel for CUDA tensors and runs its plain twin
for CPU tensors.

Semantics carried over from the JAX engine:

* ``.at[...](mode="drop")`` writes become scatters into a buffer with one
  extra sink slot that is sliced off — padding and non-qualifying entries
  land there instead of being dropped;
* every cumsum and sum pins ``dtype=torch.int32`` (PyTorch widens integer
  reductions to int64 by default; the packed layout is int32);
* the uint32 event wire word travels as an int32 tensor of the same bits
  and decodes in int64, since PyTorch's ``>>`` on int32 is arithmetic.

Three coverage return modes, as in the JAX engine (``cov_out``,
``RAFT_COV_OUT``): ``host`` (default) keeps the coverage matrix on the
device and ``.coverage.txt`` renders from the events on the host;
``diff8`` ships the int8 per-window diff and the host cumsums it,
rebuilding from the bucket's own events any row whose diff does not fit
in int8; ``cov`` ships the int32 matrix.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from raft_tpu import bucketing
from raft_tpu.io.fasta import ReadStore
from raft_tpu.io.paf import OverlapTable
from raft_tpu.params import AlgoParams
from raft_tpu.result import ComputeResult
from raft_tpu_torch.ops.pileup_cuda import decode_events, ev_bits_w0, pileup

I32 = torch.int32
COV_OUT_MODES = ("host", "diff8", "cov")


@dataclasses.dataclass(frozen=True)
class StaticCfg:
    """Per-bucket shapes and parameters (``engine_jax.StaticCfg`` without
    the Pallas switch)."""
    B: int
    W: int
    E: int
    M: int          # marker slots
    K: int          # repeat-interval slots (closed-form safe bound)
    F: int          # fragment slots
    reso: int
    high_cov: int
    repeat_length: int
    flank: int
    interval_length: int
    div: int
    overlap_length: int
    cov_out: str = "host"
    ev_pack: int = 32  # event wire format: 32 = one uint32 word, 0 = pairs


def default_cov_out() -> str:
    """Coverage return mode when the caller names none: ``RAFT_COV_OUT``,
    else ``host``."""
    return os.environ.get("RAFT_COV_OUT", "host")


def derive_cfg(B: int, W: int, E: int, params: AlgoParams,
               cov_out: str | None = None) -> StaticCfg:
    """Closed-form slot bounds, field for field those of
    ``engine_jax.derive_cfg``: no input can exceed M, K or F."""
    reso = params.reso
    il = params.interval_length
    rl = params.repeat_length
    M = (W * reso) // il + 2
    min_run = max(1, -(-rl // reso))
    K = (W + 1) // (min_run + 1) + 1
    F = M // max(params.div, 1) + 2
    return StaticCfg(B=B, W=W, E=E, M=M, K=K, F=F, reso=reso,
                     high_cov=params.high_cov, repeat_length=rl,
                     flank=params.flanking_length, interval_length=il,
                     div=params.div, overlap_length=params.overlap_length,
                     cov_out=cov_out or default_cov_out(),
                     ev_pack=event_pack_mode(W))


def event_pack_mode(W: int) -> int:
    """Event wire format: (w0, span) in 2k+1 bits with k = bit_length(W-1)
    — one uint32 word per event while that fits (W <= 32768), else int32
    (w0, span) pairs. The 16/24-bit packings of the JAX engine existed for
    a narrow host link and are not carried over."""
    return 32 if 2 * ev_bits_w0(W) + 1 <= 32 else 0


def pack_events(ev_w0, ev_w1, cfg: StaticCfg) -> np.ndarray:
    """Host side of the wire format: uint32 [E] words (pack32) or int32
    [E, 2] (w0, span) pairs. An event is valid iff ``w1 >= w0`` and
    ``0 <= w0 < W``; w1 clamps to W-1; an invalid event ships span 0."""
    W = cfg.W
    k = ev_bits_w0(W)
    w0 = np.asarray(ev_w0, dtype=np.int32)
    w1 = np.asarray(ev_w1, dtype=np.int32)
    valid = (w1 >= w0) & (w0 >= 0) & (w0 < W)
    span = np.where(valid, np.minimum(w1, W - 1) - w0 + 1, 0)
    w0c = np.where(valid, w0, 0)
    if cfg.ev_pack == 0:
        return np.stack([w0c, span], axis=1).astype(np.int32)
    return w0c.view(np.uint32) | (span.view(np.uint32) << np.uint32(k))


def bucket_to_device(bk: bucketing.Bucket, cfg: StaticCfg, device):
    """H2D of one bucket: (lens int32 [B], ev_off int32 [B+1], ev_pk).

    The int16 bucket columns widen to int32 in ``pack_events``; the uint32
    wire words travel as int32 tensors holding the same bits."""
    pk = pack_events(bk.ev_w0, bk.ev_w1, cfg)
    if pk.dtype == np.uint32:
        pk = pk.view(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(device) for a in (bk.lens, bk.ev_off, pk))


def unpack_events(ev_pk, cfg: StaticCfg):
    """Device side of the wire format → (ev_w0, ev_w1) int32 [E]. Span 0
    decodes to w1 = w0 - 1, which the pileup's ``w1 >= w0`` test drops."""
    w0, span = decode_events(ev_pk, cfg.W, cfg.ev_pack == 0)
    return w0.to(I32), (w0 + span - 1).to(I32)


# ---------------------------------------------------------------------------
# Stage 1: coverage pileup
# ---------------------------------------------------------------------------

def _sink(flat, n: int):
    """Route indices outside [0, n) to the sink slot n."""
    return torch.where((flat >= 0) & (flat < n), flat, n).to(torch.int64)


def rows_from_offsets(ev_off, cfg: StaticCfg):
    """[B+1] exclusive per-row event offsets → [E] int32 row ids (B for
    padding slots): a scatter-max of row ids at their offsets, then a
    cummax. Empty rows share an offset; the max resolves the tie to the
    row whose slab begins there."""
    B, E = cfg.B, cfg.E
    dev = ev_off.device
    marks = torch.full((E + 2,), -1, dtype=I32, device=dev)
    iota_b = torch.arange(B + 1, dtype=I32, device=dev)
    marks.scatter_reduce_(0, _sink(ev_off.to(torch.int64), E + 1), iota_b,
                          reduce="amax")
    return torch.cummax(marks[:E + 1], dim=0).values[:E]


def pileup_diff_scatter(ev_row, ev_w0, ev_w1, cfg: StaticCfg):
    """[E] window-binned events → (cov [B, W] int32, diff [B, W] int32):
    +1 at w0 and -1 after w1 in a row-strided diff buffer, then a row
    cumsum."""
    B, W = cfg.B, cfg.W
    w0 = ev_w0.to(torch.int64)
    w1 = ev_w1.to(torch.int64)
    row = ev_row.to(torch.int64)
    valid = (w1 >= w0) & (row < B)
    one = valid.to(I32)
    stride = W + 1
    n = B * stride
    base = row * stride
    flat0 = _sink(torch.where(valid, base + w0, n), n)
    flat1 = _sink(torch.where(valid, base + w1 + 1, n), n)
    diff = torch.zeros(n + 1, dtype=I32, device=ev_w0.device)
    diff.index_add_(0, flat0, one)
    diff.index_add_(0, flat1, -one)
    diff = diff[:n].reshape(B, stride)
    cov = torch.cumsum(diff, dim=1, dtype=I32)[:, :W]
    return cov, diff[:, :W]


# ---------------------------------------------------------------------------
# Stage 2: repeat run-length scan
# ---------------------------------------------------------------------------

def repeat_scan(cov, lens, cfg: StaticCfg):
    """[B, W] coverage → (rep_s, rep_e [B, K] flanked and clamped
    intervals, empty slots s=1 > e=0; rep_n [B]; rep_len_sum [B])."""
    B, W, K, reso = cfg.B, cfg.W, cfg.K, cfg.reso
    dev = cov.device
    n_win = -torch.div(-lens, reso, rounding_mode="floor")
    wi = torch.arange(W, dtype=I32, device=dev).expand(B, W)
    high = (cov >= cfg.high_cov) & (wi < n_win[:, None])

    low = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    prev_high = torch.cat([low, high[:, :-1]], dim=1)
    next_high = torch.cat([high[:, 1:], low], dim=1)
    run_start_mark = high & ~prev_high
    run_end_mark = high & ~next_high

    run_start = torch.cummax(
        torch.where(run_start_mark, wi, -1), dim=1).values
    run_nwin = wi - run_start + 1
    qualify = run_end_mark & (run_nwin * reso >= cfg.repeat_length)

    rep_len_sum = torch.where(qualify, run_nwin * reso, 0).sum(
        dim=1, dtype=I32)

    s = torch.clamp(run_start * reso - cfg.flank, min=0)
    e = torch.minimum((wi + 1) * reso + cfg.flank, lens[:, None])

    rank = torch.cumsum(qualify.to(I32), dim=1, dtype=I32) - 1
    row = torch.arange(B, dtype=I32, device=dev)[:, None]
    flat = _sink(torch.where(qualify & (rank < K), row * K + rank, B * K),
                 B * K).ravel()
    rep_s = torch.ones(B * K + 1, dtype=I32, device=dev)
    rep_s[flat] = s.ravel().to(I32)
    rep_e = torch.zeros(B * K + 1, dtype=I32, device=dev)
    rep_e[flat] = e.ravel().to(I32)
    rep_n = qualify.sum(dim=1, dtype=I32)
    return (rep_s[:B * K].reshape(B, K), rep_e[:B * K].reshape(B, K),
            rep_n, rep_len_sum)


# ---------------------------------------------------------------------------
# Stage 3: marker selection + fragment spans
# ---------------------------------------------------------------------------

def chop_markers(lens, rep_s, rep_e, cfg: StaticCfg):
    """Candidate markers → surviving markers → fragment span table;
    returns a dict of [B] / [B, F] tensors the host emitter consumes."""
    B, M, F = cfg.B, cfg.M, cfg.F
    il, div, ov = cfg.interval_length, cfg.div, cfg.overlap_length
    dev = lens.device

    parts = torch.div(lens, il, rounding_mode="floor")
    has_rem = torch.remainder(lens, il) != 0
    n_stars = parts + 1 + has_rem.to(I32)

    j = torch.arange(M, dtype=I32, device=dev)[None, :]
    star_val = torch.where(j <= parts[:, None], j * il, lens[:, None])
    valid_star = j < n_stars[:, None]

    # interval-stabbing deletion test against the [B, K] repeat slots
    inside = torch.any(
        (rep_s[:, None, :] <= star_val[:, :, None])
        & (star_val[:, :, None] <= rep_e[:, None, :]), dim=2)
    keep = valid_star & (
        (j == 0) | (j == (n_stars - 1)[:, None]) | ~inside)

    S = keep.sum(dim=1, dtype=I32)
    rank = torch.cumsum(keep.to(I32), dim=1, dtype=I32) - 1
    row = torch.arange(B, dtype=I32, device=dev)[:, None]
    flat = _sink(torch.where(keep, row * M + rank, B * M), B * M).ravel()
    stars_c = torch.zeros(B * M + 1, dtype=I32, device=dev)
    stars_c[flat] = star_val.ravel().to(I32)
    stars_c = stars_c[:B * M].reshape(B, M)

    whole = S <= (div + 1)
    extra = S - (div + 1)
    n_frag = torch.where(
        whole, 1,
        1 + torch.div(extra, div, rounding_mode="floor")
        + (torch.remainder(extra, div) != 0).to(I32)).to(I32)

    fi = torch.arange(F, dtype=I32, device=dev)[None, :]
    pos = fi * div

    def gather(idx):
        idx = torch.clamp(idx, 0, M - 1).to(torch.int64).expand(B, -1)
        return torch.gather(stars_c, 1, idx)

    star_f = gather(pos)
    last_star = gather(torch.clamp(S - 1, 0, M - 1)[:, None])  # [B, 1]
    is_last = fi == (n_frag - 1)[:, None]
    last_f = torch.where(is_last, last_star, gather(pos + div))
    ov_f = (fi != 0).to(I32) * ov

    whole_b = whole[:, None]
    char_start = torch.where(whole_b, 0, star_f - ov_f).to(I32)
    char_len = torch.where(whole_b, lens[:, None],
                           last_f - star_f + ov_f).to(I32)
    return dict(n_frag=n_frag, whole=whole, char_start=char_start,
                char_len=char_len)


# ---------------------------------------------------------------------------
# Fused device step
# ---------------------------------------------------------------------------

# Packed-output column layout (engine_jax): every small per-read result
# travels in ONE int32 [B, 2K+2F+5] array, so a bucket's D2H is one copy.
PACKED_SCALARS = 5  # rep_n, rep_len_sum, n_frag, whole, ok8


def packed_width(cfg: StaticCfg) -> int:
    return 2 * cfg.K + 2 * cfg.F + PACKED_SCALARS


def unpack_out(packed: np.ndarray, cfg: StaticCfg) -> dict:
    """Host-side view split of the packed [B, …] int32 array."""
    K, F = cfg.K, cfg.F
    base = 2 * K + 2 * F
    return dict(
        rep_s=packed[:, :K], rep_e=packed[:, K:2 * K],
        char_start=packed[:, 2 * K:2 * K + F],
        char_len=packed[:, 2 * K + F:base],
        rep_n=packed[:, base], rep_len_sum=packed[:, base + 1],
        n_frag=packed[:, base + 2],
        whole=packed[:, base + 3] != 0,
        ok8=packed[:, base + 4] != 0)


def device_step(lens, ev_off, ev_pk, cfg: StaticCfg) -> dict:
    """Full per-bucket pipeline: pileup → repeat scan → chop, on the
    inputs' device; the dict of ``engine_jax.device_step_impl``.

    ``packed`` is the ``[B, 2K+2F+5]`` int32 per-read array. By
    ``cfg.cov_out``: ``diff8`` adds the int8 ``[B, W]`` per-window diff,
    with ``ok8`` 0 on rows where a window gains or loses more than int8
    holds (the cast wraps there, as JAX's does; the host rebuilds those
    rows); ``cov`` adds the int32 ``[B, W]`` coverage; ``host`` adds
    nothing. ``ok8`` is 1 on every row outside ``diff8``."""
    cov = pileup(ev_off, ev_pk, cfg)
    rep_s, rep_e, rep_n, rep_len_sum = repeat_scan(cov, lens, cfg)
    frags = chop_markers(lens, rep_s, rep_e, cfg)
    out = {}
    if cfg.cov_out == "diff8":
        diff = torch.diff(cov, dim=1,
                          prepend=torch.zeros_like(cov[:, :1]))
        ok8 = (diff.amax(dim=1) <= 127) & (diff.amin(dim=1) >= -128)
        out["diff8"] = diff.to(torch.int8)
    else:
        ok8 = torch.ones(cfg.B, dtype=torch.bool, device=lens.device)
        if cfg.cov_out == "cov":
            out["cov"] = cov
    out["packed"] = torch.cat(
        [rep_s, rep_e, frags["char_start"], frags["char_len"],
         rep_n[:, None], rep_len_sum[:, None], frags["n_frag"][:, None],
         frags["whole"][:, None].to(I32), ok8[:, None].to(I32)], dim=1)
    return out


# ---------------------------------------------------------------------------
# Host loop: buckets in, per-read results out
# ---------------------------------------------------------------------------

def _cumsum0(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


def _slab_copy_idx(cnt: np.ndarray, src_start: np.ndarray,
                   dst_start: np.ndarray):
    """Vectorized variable-length slab copy index arrays: returns
    (src_idx, dst_idx) such that dst[dst_idx] = src[src_idx] copies
    cnt[i] consecutive items from src_start[i] to dst_start[i]."""
    tot = int(cnt.sum())
    if tot == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    off = _cumsum0(cnt)
    within = np.arange(tot, dtype=np.int64) - np.repeat(off[:-1], cnt)
    return (np.repeat(np.asarray(src_start, np.int64), cnt) + within,
            np.repeat(np.asarray(dst_start, np.int64), cnt) + within)


def _validate_events(lens, ev_read, ev_lo, ev_hi, reso):
    ok = len(ev_read) == 0 or (
        (ev_lo >= 0).all()
        and (ev_hi < lens.astype(np.int64)[ev_read]).all())
    if not ok:
        raise ValueError(
            "overlap interval exceeds read bounds (reference RAFT has an "
            "unchecked buffer overrun here, repeat.hpp:69-73); "
            "fix the PAF or run with --no-strict")


def compute_torch(store: ReadStore, table: OverlapTable, params: AlgoParams,
                  strict: bool = True, cov_out: str | None = None,
                  on_cov_events=None,
                  timers_out: dict | None = None,
                  grouped=None, device="cpu",
                  on_bucket=None) -> ComputeResult:
    """Torch engine: buckets through ``device_step`` on ``device``, flat
    ComputeResult out — the counterpart of ``engine_jax.compute_jax``.

    Each bucket is one H2D copy, one ``device_step`` on the current
    stream and its D2H copies: the packed array alone in ``host`` mode,
    plus the ``[B, W]`` diff or coverage in ``diff8`` / ``cov`` mode
    (``cov_out``, default ``RAFT_COV_OUT`` or ``host``). In ``host`` mode
    ``.coverage.txt`` renders from the window-binned events, which
    ``on_cov_events`` receives before any device work; in the other two
    it never fires, and the result carries ``cov_flat``.
    ``timers_out`` receives the stage seconds that ``RAFT_TIMERS=1``
    prints on stderr; ``grouped`` is an already-computed
    ``events_grouped`` triple (``--auto-e`` reuses its pass).
    ``on_bucket(cfg, lens, ev_off, ev_pk)`` sees each bucket's device
    inputs after the H2D, before its ``device_step``."""
    mode = cov_out or default_cov_out()
    if mode not in COV_OUT_MODES:
        raise ValueError(f"cov_out={mode!r}: must be one of "
                         f"{', '.join(COV_OUT_MODES)}")
    ev_backed = mode == "host"
    device = torch.device(device)
    timers: dict = {}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        t = time.perf_counter()
        timers[name] = timers.get(name, 0.0) + (t - t0)
        t0 = t

    n = store.n_reads
    lens = store.lens.astype(np.int32)
    reso = params.reso
    nw_all = -(-lens.astype(np.int64) // reso)

    if grouped is None:
        eg = getattr(table, "events_grouped", None)
        if eg is not None:
            grouped = eg(n, lens, reso, strict=strict)
    if grouped is not None:
        ev_off_g, w0s, w1s = grouped
        ev_read = ev_lo = ev_hi = None
        mark("events")
    else:
        ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
        if strict:
            _validate_events(lens, ev_read, ev_lo, ev_hi, reso)
        mark("events")
        order = np.argsort(ev_read, kind="stable")
        ev_read = ev_read[order]
        ev_lo = ev_lo[order]
        ev_hi = ev_hi[order]
        mark("sort")
    prebinned = (ev_off_g, w0s, w1s) if grouped is not None else None

    cov_off = _cumsum0(nw_all)
    if ev_backed:
        # event-backed coverage: everything .coverage.txt needs is known
        # now; Σcov is closed-form with the renderer's clamp semantics
        if grouped is not None:
            nwr = np.repeat(nw_all, np.diff(ev_off_g))
        else:
            w0s = (ev_lo.astype(np.int64) // reso).astype(np.int32)
            w1s = np.where(ev_hi < 0, -1,
                           ev_hi.astype(np.int64) // reso).astype(np.int32)
            ev_off_g = np.searchsorted(ev_read,
                                       np.arange(n + 1)).astype(np.int64)
            nwr = nw_all[ev_read]
        valid = (w1s >= w0s) & (w0s >= 0) & (w0s < nwr)
        total_cov = int(np.where(
            valid, np.minimum(w1s.astype(np.int64), nwr - 1) - w0s + 1,
            0).sum())
        cov_flat = None
        if on_cov_events is not None:
            z32 = np.empty(0, np.int32)
            z64 = np.empty(0, np.int64)
            on_cov_events(ComputeResult(
                n_reads=n, cov_flat=None, cov_off=cov_off,
                rep_s=z32, rep_e=z32, rep_off=np.zeros(n + 1, np.int64),
                frag_read=z32, frag_char_start=z64, frag_char_len=z64,
                frag_whole=np.empty(0, bool),
                total_coverage=total_cov, total_windows=int(nw_all.sum()),
                cov_ev_w0=w0s, cov_ev_w1=w1s, cov_ev_off=ev_off_g))
        mark("cov_events")
    else:
        w0s = w1s = ev_off_g = None
        cov_flat = np.empty(int(cov_off[-1]), dtype=np.int32)

    outs = []
    for bk in bucketing.iter_buckets(lens, ev_read, ev_lo, ev_hi, reso,
                                     presorted=True, prebinned=prebinned):
        cfg = derive_cfg(bk.B, bk.W, bk.E, params, cov_out=mode)
        mark("bucket_prep")
        args = bucket_to_device(bk, cfg, device)
        mark("h2d")
        if on_bucket is not None:
            on_bucket(cfg, *args)
        dev_out = device_step(*args, cfg=cfg)
        out = unpack_out(dev_out["packed"].cpu().numpy(), cfg)
        if "diff8" in dev_out:
            cov = np.cumsum(dev_out["diff8"].cpu().numpy(), axis=1,
                            dtype=np.int32)
            bad = np.nonzero(~out["ok8"])[0]
            if len(bad):
                # a window gained or lost more than int8 holds, so the
                # diff wrapped on these rows: rebuild them exactly from
                # the bucket's own events
                _host_cov_rows(bk, 1, bad, cov)
            out["cov"] = cov
        elif "cov" in dev_out:
            out["cov"] = dev_out["cov"].cpu().numpy()
        mark("step")
        outs.append((bk, out))

    # global offsets in read-id order
    rep_n_all = np.zeros(n, dtype=np.int64)
    frag_n_all = np.zeros(n, dtype=np.int64)
    total_rep_len = 0
    for bk, out in outs:
        nu = bk.n_used
        rep_n_all[bk.read_ids] = out["rep_n"][:nu]
        frag_n_all[bk.read_ids] = out["n_frag"][:nu]
        total_rep_len += int(out["rep_len_sum"][:nu].astype(np.int64).sum())
    rep_off = _cumsum0(rep_n_all)
    frag_off = _cumsum0(frag_n_all)

    rep_s = np.empty(int(rep_off[-1]), dtype=np.int32)
    rep_e = np.empty(int(rep_off[-1]), dtype=np.int32)
    n_frags = int(frag_off[-1])
    frag_read = np.empty(n_frags, dtype=np.int32)
    frag_cs = np.empty(n_frags, dtype=np.int64)
    frag_cl = np.empty(n_frags, dtype=np.int64)
    frag_wh = np.empty(n_frags, dtype=bool)

    for bk, out in outs:
        nu = bk.n_used
        rid = bk.read_ids
        rows = np.arange(nu, dtype=np.int64)
        if not ev_backed:
            W = out["cov"].shape[1]
            s_idx, d_idx = _slab_copy_idx(nw_all[rid], rows * W,
                                          cov_off[rid])
            cov_flat[d_idx] = out["cov"].ravel()[s_idx]

        K = out["rep_s"].shape[1]
        s_idx, d_idx = _slab_copy_idx(rep_n_all[rid], rows * K, rep_off[rid])
        rep_s[d_idx] = out["rep_s"].ravel()[s_idx]
        rep_e[d_idx] = out["rep_e"].ravel()[s_idx]

        F = out["char_start"].shape[1]
        cnt = frag_n_all[rid]
        s_idx, d_idx = _slab_copy_idx(cnt, rows * F, frag_off[rid])
        frag_cs[d_idx] = out["char_start"].ravel()[s_idx]
        frag_cl[d_idx] = out["char_len"].ravel()[s_idx]
        frag_read[d_idx] = np.repeat(rid, cnt)
        frag_wh[d_idx] = np.repeat(out["whole"][:nu], cnt)

    mark("integrate")
    if timers_out is not None:
        timers_out.update(timers)
    if os.environ.get("RAFT_TIMERS"):
        print("compute_torch timers: " + ", ".join(
            f"{k}={v:.3f}s" for k, v in timers.items()), file=sys.stderr)
    return ComputeResult(
        n_reads=n,
        cov_flat=cov_flat, cov_off=cov_off,
        rep_s=rep_s, rep_e=rep_e, rep_off=rep_off,
        frag_read=frag_read, frag_char_start=frag_cs,
        frag_char_len=frag_cl, frag_whole=frag_wh,
        total_coverage=(total_cov if ev_backed
                        else int(cov_flat.sum(dtype=np.int64))),
        total_windows=int(nw_all.sum()),
        total_repeat_length=total_rep_len,
        total_read_length=int(lens.astype(np.int64).sum()),
        cov_ev_w0=w0s, cov_ev_w1=w1s, cov_ev_off=ev_off_g,
    )


def _bucket_global_rows(bk, n_shards: int) -> np.ndarray:
    """Event → global bucket row. Sharded buckets store shard-local row
    ids per event slab; map them back (pad sentinel → bk.B)."""
    rows = np.asarray(bk.ev_row, dtype=np.int64)
    if n_shards > 1:
        B_local = bk.B // n_shards
        E_s = bk.E // n_shards
        slab = np.arange(len(rows), dtype=np.int64) // E_s
        rows = np.where(rows >= B_local, bk.B, slab * B_local + rows)
    return rows


def _host_cov_rows(bk, n_shards: int, bad: np.ndarray,
                   cov: np.ndarray) -> None:
    """Recompute int32 coverage for rows ``bad`` of a bucket from its own
    events (the same diff+cumsum the device runs, repeat.hpp:62-77
    semantics) and write them into ``cov`` in place."""
    W = cov.shape[1]
    rows = _bucket_global_rows(bk, n_shards)
    w0 = np.asarray(bk.ev_w0, dtype=np.int64)
    w1 = np.asarray(bk.ev_w1, dtype=np.int64)
    sel = (np.isin(rows, bad) & (w1 >= w0)
           & (w0 >= 0) & (w0 <= W) & (w1 + 1 <= W))
    remap = np.full(int(bk.B) + 1, -1, dtype=np.int64)
    remap[bad] = np.arange(len(bad))
    r = remap[rows[sel]]
    d = np.zeros((len(bad), W + 1), dtype=np.int32)
    np.add.at(d, (r, w0[sel]), 1)
    np.add.at(d, (r, w1[sel] + 1), -1)
    cov[bad] = np.cumsum(d[:, :W], axis=1)
