"""PyTorch device engine: the three RAFT compute stages over dense
``[B, W]`` batches, the counterpart of ``raft_tpu/engine_jax.py``.

Every public stage keeps the JAX engine's name, argument order and
column layout, so each is held against its ``engine_jax`` twin on the
same inputs (``tests/test_torch_stages.py``). The stages are plain
PyTorch on tensors of any device. ``device_step`` runs two wrappers, each
of which launches a hand-written Hopper kernel for CUDA tensors and runs
its plain twin for CPU tensors: ``ops.pileup_cuda.pileup`` for the
coverage, then ``ops.scan_chop_cuda.scan_chop`` for the repeat scan, the
markers and fragments, the ``diff8`` diff and the packing, whose twin is
this module's ``repeat_scan`` and ``chop_markers``. So on a card no
plain-torch stage runs in the step.

Semantics carried over from the JAX engine:

* ``.at[...](mode="drop")`` writes become scatters into a buffer with one
  extra sink slot that is sliced off — padding and non-qualifying entries
  land there instead of being dropped;
* every cumsum and sum pins ``dtype=torch.int32`` (PyTorch widens integer
  reductions to int64 by default; the packed layout is int32);
* the uint32 event wire word travels as an int32 tensor of the same bits
  and decodes in int64, since PyTorch's ``>>`` on int32 is arithmetic.

One coverage path: ``compute_torch`` keeps the coverage matrix on the
device, and ``.coverage.txt`` renders on the host from the window-binned
events, which it hands over before any device work. ``StaticCfg.cov_out``
keeps the JAX engine's three return modes for ``device_step`` alone,
which is held against ``engine_jax.device_step_impl`` in each: ``diff8``
adds the int8 per-window diff, ``cov`` the int32 matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch import bucketing, profiling
from raft_tpu_torch.io.fasta import ReadStore
from raft_tpu_torch.io.paf import OverlapTable
from raft_tpu_torch.params import AlgoParams
from raft_tpu_torch.result import ComputeResult
from raft_tpu_torch.ops import gather_cuda, pileup_cuda, scan_chop_cuda
from raft_tpu_torch.ops.pileup_cuda import decode_events, ev_bits_w0, pileup
from raft_tpu_torch.ops.scan_chop_cuda import scan_chop

I32 = torch.int32
COV_OUT_MODES = ("host", "diff8", "cov")
# A bucket wider than this many windows is "wide" for the engine.wide.*
# counters: the widest tier that the pileup's regime 1 holds.
WIDE_W = 2048
WIDE_COUNTS = ("buckets", "reads", "windows", "events", "repeats",
               "fragments")


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


def derive_cfg(B: int, W: int, E: int, params: AlgoParams,
               cov_out: str | None = None) -> StaticCfg:
    """Closed-form slot bounds, field for field those of
    ``engine_jax.derive_cfg``: no input can exceed M, K or F. ``cov_out``
    None is ``host``."""
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
                     cov_out=cov_out or "host",
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


def host_inputs(bk: bucketing.Bucket, cfg: StaticCfg):
    """One bucket's device inputs on the host: (lens int32 [B], ev_off
    int32 [B+1], ev_pk).

    The int16 bucket columns widen to int32 in ``pack_events``; the uint32
    wire words travel as int32 holding the same bits."""
    pk = pack_events(bk.ev_w0, bk.ev_w1, cfg)
    if pk.dtype == np.uint32:
        pk = pk.view(np.int32)
    return tuple(np.ascontiguousarray(a, dtype=np.int32)
                 for a in (bk.lens, bk.ev_off, pk))


def bucket_to_device(bk: bucketing.Bucket, cfg: StaticCfg, device):
    """H2D of one bucket: ``host_inputs`` as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in host_inputs(bk, cfg))


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


def rep_len_sum_col(cfg: StaticCfg) -> int:
    """Column of ``rep_len_sum`` in the packed array."""
    return 2 * cfg.K + 2 * cfg.F + 1


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
    inputs' device; the dict of ``engine_jax.device_step_impl``. Two
    kernels on a card: the pileup, then ``scan_chop`` for the rest.

    ``packed`` is the ``[B, 2K+2F+5]`` int32 per-read array. By
    ``cfg.cov_out``: ``diff8`` adds the int8 ``[B, W]`` per-window diff,
    with ``ok8`` 0 on rows where a window gains or loses more than int8
    holds (the cast wraps there, as JAX's does); ``cov`` adds the int32
    ``[B, W]`` coverage; ``host``, the mode ``compute_torch`` runs, adds
    nothing. ``ok8`` is 1 on every row outside ``diff8``."""
    cov = pileup(ev_off, ev_pk, cfg)
    out = scan_chop(cov, lens, cfg)
    if cfg.cov_out == "cov":
        out["cov"] = cov
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


def _group_events(ev_read, ev_lo, ev_hi, n: int, reso: int):
    """Ungrouped events → the read-grouped, window-binned triple of
    ``OverlapTable.events_grouped`` (ev_off int64 [n+1], w0, w1 int32
    [m]), by a stable sort on the read ids: what the native counting sort
    gives, where it is missing."""
    order = np.argsort(ev_read, kind="stable")
    ev_read = ev_read[order]
    ev_lo = ev_lo[order]
    ev_hi = ev_hi[order]
    return (np.searchsorted(ev_read, np.arange(n + 1)).astype(np.int64),
            (ev_lo.astype(np.int64) // reso).astype(np.int32),
            np.where(ev_hi < 0, -1,
                     ev_hi.astype(np.int64) // reso).astype(np.int32))


def cov_sum(ev_off, w0, w1, lens, reso: int) -> int:
    """Σcov, the coverage summed over every window, from read-grouped
    window-binned events with the coverage renderer's clamp semantics (an
    event counts iff w1 >= w0 and 0 <= w0 < its read's windows, w1
    clamped to the last window): one native pass (``native.cov_sum``),
    else numpy's closed form, where the native library is missing."""
    from raft_tpu_torch.io import native
    total = native.cov_sum(w0, w1, ev_off, lens, reso)
    if total is not None:
        return total
    nwr = np.repeat(-(-np.asarray(lens, np.int64) // reso), np.diff(ev_off))
    valid = (w1 >= w0) & (w0 >= 0) & (w0 < nwr)
    return int(np.where(
        valid, np.minimum(w1.astype(np.int64), nwr - 1) - w0 + 1, 0).sum())


def plan_steps(lens: np.ndarray, ev_counts: np.ndarray, params: AlgoParams,
               n_shards: int = 1):
    """The device steps of a pass, from the read lengths and per-read
    event counts alone: for each bucket of ``bucketing.plan_buckets``, its
    ``BucketShape``, the ``StaticCfg`` of one shard and per shard
    (``parallel.mesh.shard_rows``' layout where ``n_shards`` > 1) the
    ``gather_cuda.Step`` whose gathered inputs equal ``host_inputs`` of
    ``iter_buckets``' bucket (``shard_bucket``'s shard)."""
    from raft_tpu_torch.parallel.mesh import shard_rows
    for shape in bucketing.plan_buckets(lens, ev_counts, params.reso):
        rows = (shard_rows(shape.read_ids, shape.B,
                           ev_counts[shape.read_ids], n_shards)
                if n_shards > 1 else [(shape.read_ids, shape.B, shape.E)])
        cfg = derive_cfg(rows[0][1], shape.W, rows[0][2], params)
        trunc16 = bucketing.event_dtype(shape.B, shape.W) == np.int16
        yield shape, cfg, [
            gather_cuda.Step(rids, B, E, cfg.W, cfg.ev_pack == 0, trunc16)
            for rids, B, E in rows]


def compute_torch(store: ReadStore, table: OverlapTable, params: AlgoParams,
                  strict: bool = True, on_cov_events=None,
                  timers_out: dict | None = None,
                  grouped=None, device="cuda",
                  on_bucket=None, devices=None) -> ComputeResult:
    """Torch engine: buckets through ``device_step`` on ``device``, flat
    ComputeResult out — the counterpart of ``engine_jax.compute_jax``.

    The events come read-grouped and window-binned (the native counting
    sort of ``OverlapTable.events_grouped``, else a sort here). The host
    partitions the reads into buckets from the read lengths and per-read
    event counts alone (``bucketing.plan_buckets``), copies the grouped
    table to the device once, and one gather (``ops.gather_cuda``: the
    kernel on a card, its plain twin on the CPU) writes every bucket's
    device inputs there, the arrays ``host_inputs`` would build. Each
    bucket is then one ``device_step`` on the current stream and the D2H
    copy of its packed array. The coverage stays on the device:
    ``.coverage.txt`` renders from the window-binned events, which
    ``on_cov_events`` receives with Σcov before any device work (the
    native grouping's ``cov_sum``, else ``cov_sum`` here), and which the
    result carries as ``cov_ev_*`` with ``cov_flat`` None.

    ``devices`` (a list of torch devices, the counterpart of ``mesh=``)
    shards every bucket over them as contiguous row ranges
    (``parallel.mesh.shard_rows``, ``shard_bucket``'s layout) and takes
    the place of ``device``; the result is the same. Each distinct device
    gets its own copy of the table and gathers its own shards, in one
    launch; ``parallel.mesh.run_shards`` runs each bucket's shards.

    The host stages are back-to-back spans ``engine.<stage>``, children of
    the caller's open span (``profiling.Marks``): ``events`` (``sort``
    where the events come ungrouped), ``cov_events``, ``bucket_prep``
    (the partition; attribute ``buckets``), ``h2d`` (attribute ``table``
    = 1: the table's copies and the gather's launch), then per bucket
    ``step`` (attributes ``B``, ``W``, ``E``, and ``pileup_regime`` and
    ``scan_chop_regime``: the launch plans' regimes, 0 where the plain
    twins run: the device steps and their D2H), then ``integrate``; with
    the counters ``engine.events``, ``engine.windows``, ``engine.buckets``
    (device steps, one per bucket and shard), ``engine.table_bytes`` (the
    table's copies), ``engine.h2d_bytes`` (every H2D byte: the table and
    the gather's plan), ``engine.gather.buckets`` (device steps whose
    inputs the gather wrote), ``engine.gather.bytes`` (those inputs'
    bytes), ``engine.d2h_bytes``, ``engine.fragments``,
    ``engine.cut_reads`` (reads cut into more than one fragment) and
    ``engine.repeats``, and over the buckets wider than ``WIDE_W``
    windows (``_wide_counts``) ``engine.wide.buckets`` (device steps),
    ``.reads``, ``.windows``, ``.events``, ``.repeats`` and
    ``.fragments``.
    ``timers_out`` receives those spans' seconds summed by stage;
    ``grouped`` is an already-computed ``events_grouped`` triple
    (``--auto-e`` reuses its pass).
    ``on_bucket(cfg, lens, ev_off, ev_pk)`` sees each bucket's device
    inputs after the gather, before its ``device_step``; with ``devices``
    it sees each shard's, with the per-shard ``cfg``, so it fires once
    per pileup launch."""
    marks = profiling.Marks("engine.", want=timers_out is not None)
    mark = marks.mark

    n = store.n_reads
    lens = store.lens.astype(np.int32)
    reso = params.reso
    nw_all = -(-lens.astype(np.int64) // reso)

    if grouped is None:
        eg = getattr(table, "events_grouped", None)
        if eg is not None:
            grouped = eg(n, lens, reso, strict=strict)
    if grouped is not None:
        mark("events")
    else:
        ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
        if strict:
            _validate_events(lens, ev_read, ev_lo, ev_hi, reso)
        mark("events")
        grouped = _group_events(ev_read, ev_lo, ev_hi, n, reso)
        mark("sort")
    ev_off_g, w0s, w1s = grouped
    profiling.count("engine.events", len(w0s))
    profiling.count("engine.windows", int(nw_all.sum()))

    cov_off = _cumsum0(nw_all)
    # everything .coverage.txt needs is known now, Σcov included (the
    # native grouping's, else one pass here)
    total_cov = getattr(grouped, "cov_sum", None)
    if total_cov is None:
        total_cov = cov_sum(ev_off_g, w0s, w1s, lens, reso)
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

    from raft_tpu_torch.parallel.mesh import run_shards
    devices = [torch.device(d) for d in (devices or [device])]
    n_shards = len(devices)
    # the partition on the host, from n-sized arrays; each device's steps
    # (a bucket, or its shard there) for the gather
    buckets = []
    steps: dict = {d: [] for d in devices}
    for shape, cfg, shard_steps in plan_steps(
            lens, np.diff(ev_off_g), params, n_shards):
        where = []
        for dev, st in zip(devices, shard_steps):
            where.append((dev, len(steps[dev])))
            steps[dev].append(st)
        buckets.append((shape, cfg, where))
    mark("bucket_prep", buckets=len(buckets))

    # one copy of the table per device, one gather launch per device
    gathered = {}
    for dev, dev_steps in steps.items():
        if not dev_steps:
            continue
        tab, nbytes = gather_cuda.upload_table(ev_off_g, w0s, w1s, lens, dev)
        plan = gather_cuda.GatherPlan(dev_steps)
        gathered[dev] = (gather_cuda.gather(tab, plan), plan, tab)
        profiling.count("engine.table_bytes", nbytes)
        profiling.count("engine.h2d_bytes", nbytes + plan.meta.nbytes)
        profiling.count("engine.gather.buckets", len(dev_steps))
        profiling.count("engine.gather.bytes", sum(
            plan.out_bytes(i) for i in range(len(dev_steps))))
    mark("h2d", table=1)

    # what only the recording reads is worked out only while it records
    recording = profiling.recording() is not None
    wide = dict.fromkeys(WIDE_COUNTS, 0) if recording else None
    outs = []
    for shape, cfg, where in buckets:
        host = run_shards([gather_cuda.views(*gathered[dev][:2], i)
                           for dev, i in where], cfg, on_bucket)
        profiling.count("engine.buckets", n_shards)
        profiling.count("engine.d2h_bytes", host["packed"].nbytes)
        out = unpack_out(host["packed"], cfg)
        if recording and shape.W > WIDE_W:
            for k, v in _wide_counts(shape, n_shards, out, nw_all,
                                     grouped).items():
                wide[k] += v
        mark("step", B=cfg.B, W=cfg.W, E=cfg.E,
             **(_regimes(cfg, devices[0]) if recording else {}))
        outs.append((shape, out))

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
    if recording:
        profiling.count("engine.fragments", n_frags)
        profiling.count("engine.cut_reads", int((frag_n_all > 1).sum()))
        profiling.count("engine.repeats", int(rep_off[-1]))
        for k, v in wide.items():
            profiling.count("engine.wide." + k, v)
    if timers_out is not None:
        timers_out.update(marks.seconds())
    return ComputeResult(
        n_reads=n,
        cov_flat=None, cov_off=cov_off,
        rep_s=rep_s, rep_e=rep_e, rep_off=rep_off,
        frag_read=frag_read, frag_char_start=frag_cs,
        frag_char_len=frag_cl, frag_whole=frag_wh,
        total_coverage=total_cov,
        total_windows=int(nw_all.sum()),
        total_repeat_length=total_rep_len,
        total_read_length=int(lens.astype(np.int64).sum()),
        cov_ev_w0=w0s, cov_ev_w1=w1s, cov_ev_off=ev_off_g,
    )


def _regimes(cfg: StaticCfg, device) -> dict:
    """The ``engine.step`` span's regime attributes: the regimes of the
    two kernels' launch plans for ``cfg`` on ``device``, 0 off the card,
    where the plain twins run."""
    device = torch.device(device)
    if device.type != "cuda":
        return dict(pileup_regime=0, scan_chop_regime=0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dict(
        pileup_regime=pileup_cuda.launch_plan(cfg.B, cfg.W, sms).regime,
        scan_chop_regime=scan_chop_cuda.launch_plan(
            cfg.B, cfg.W, cfg.M, cfg.K, cfg.F, sms).regime)


def _wide_counts(shape: bucketing.BucketShape, n_shards: int, out: dict,
                 nw_all: np.ndarray, grouped) -> dict:
    """A wide bucket's share of the ``engine.wide.*`` counters, from its
    reads, not its padded shape: device steps, reads, their windows
    (ceil(length / r) each), the valid events it ships (``pack_events``'
    rule, on the events as its int16 or int32 columns hold them), and the
    repeats and fragments read back from its packed rows."""
    ev_off, w0s, w1s = grouped
    rids = np.asarray(shape.read_ids)
    start = ev_off[rids]
    cnt = ev_off[rids + 1] - start
    src, _ = _slab_copy_idx(cnt, start, _cumsum0(cnt)[:-1])
    dt = bucketing.event_dtype(shape.B, shape.W)
    w0 = w0s[src].astype(dt).astype(np.int64)
    w1 = w1s[src].astype(dt).astype(np.int64)
    nu = shape.n_used
    return {"buckets": n_shards, "reads": nu,
            "windows": int(nw_all[rids].sum()),
            "events": int(((w1 >= w0) & (w0 >= 0) & (w0 < shape.W)).sum()),
            "repeats": int(out["rep_n"][:nu].astype(np.int64).sum()),
            "fragments": int(out["n_frag"][:nu].astype(np.int64).sum())}
