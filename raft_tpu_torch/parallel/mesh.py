"""Read sharding over several torch devices: the counterpart of
``raft_tpu/parallel/mesh.py``.

Reads are the only parallel axis. Each bucket is re-laid as contiguous row
ranges, one per device (``shard_rows``' layout; ``shard_bucket``'s arrays
are ``raft_tpu``'s); every overlap event is routed to its owner read's
shard, so the device step needs no collective. ``raft_tpu`` runs the shards under
``shard_map`` and ``psum``s the global repeat length; here each shard is
an ordinary ``device_step`` on its own device, all launched from the
calling thread before the first D2H, and the global repeat length is a
host sum over the gathered packed rows. The engine gathers each device's
shards on that device from its own copy of the event table
(``ops.gather_cuda``); ``sharded_device_step`` runs ``shard_bucket``'s
host arrays, the path the tests hold against ``raft_tpu``'s.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raft_tpu_torch import bucketing
from raft_tpu_torch.engine_torch import StaticCfg, device_step, rep_len_sum_col


def make_devices(n: int | None = None,
                 device: str = "cuda") -> list[torch.device]:
    """The devices to shard over: the counterpart of ``make_mesh``.

    ``cuda``: the first ``min(n, torch.cuda.device_count())`` cards (all
    of them when ``n`` is None), a line on stderr when fewer than ``n``
    exist. A process sees only its own cards (``CUDA_VISIBLE_DEVICES``),
    so this is also ``make_mesh(local=True)``. ``cpu``: ``n`` shards on
    the CPU (one when ``n`` is None), which is what the CPU tests shard
    over."""
    if n is not None and n < 1:
        raise ValueError(f"--devices must be at least 1 (got {n})")
    if device == "cpu":
        return [torch.device("cpu")] * (n or 1)
    if device != "cuda":
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("no CUDA device is available")
    used = count if n is None else min(n, count)
    if used < (n or 0):
        print(f"INFO, --devices {n}: only {count} CUDA device(s); "
              f"sharding over {used}", file=sys.stderr)
    return [torch.device("cuda", i) for i in range(used)]


def shard_rows(read_ids: np.ndarray, B: int, row_events: np.ndarray,
               n_shards: int) -> list:
    """A bucket's layout over ``n_shards`` contiguous row ranges, from its
    ``B`` rows, the reads in its first rows (``read_ids``) and their event
    counts (``row_events``, per row): per shard, its reads, rows
    ``B_local`` and event slots ``E_s``, the same for every shard (rows
    pad to a multiple of n_shards, events to the largest shard's slab).
    ``shard_bucket`` lays a bucket's arrays out by it; the engine gathers
    each shard's inputs by it."""
    B_local = -(-B // n_shards)
    starts = range(0, n_shards * B_local, B_local)
    per = max(int(row_events[a:a + B_local].sum()) for a in starts)
    E_s = bucketing._next_size(max(per, 1), lo=64)
    return [(read_ids[a:a + B_local], B_local, E_s) for a in starts]


def shard_bucket(bk: bucketing.Bucket, n_shards: int) -> bucketing.Bucket:
    """Re-lay a bucket for ``n_shards`` contiguous row ranges
    (``shard_rows``' layout).

    Each shard's events are made row-local and padded to a common
    per-shard slab so ``shard_map`` can split every array with ``P('r')``.
    Read order is unchanged, so global fragment numbering survives.
    """
    valid = bk.ev_row < bk.B
    ev_row = bk.ev_row[valid]
    ev_w0 = bk.ev_w0[valid]
    ev_w1 = bk.ev_w1[valid]
    (_, B_local, E_s), *_ = shard_rows(
        bk.read_ids, bk.B, np.bincount(ev_row, minlength=bk.B), n_shards)
    B = B_local * n_shards
    lens = np.zeros(B, dtype=np.int32)
    lens[:bk.B] = bk.lens
    # events are already laid out in row order by make_buckets
    cuts = np.searchsorted(ev_row, np.arange(0, B + B_local, B_local))

    dt = bk.ev_row.dtype
    r = np.full(n_shards * E_s, B_local, dtype=dt)
    w0 = np.zeros(n_shards * E_s, dtype=dt)
    w1 = np.full(n_shards * E_s, -1, dtype=dt)
    # per-shard slab-local offset tables ([B_local+1] each, concatenated)
    off = np.empty(n_shards * (B_local + 1), dtype=np.int32)
    for s in range(n_shards):
        a, b = cuts[s], cuts[s + 1]
        o = s * E_s
        r[o:o + (b - a)] = ev_row[a:b] - s * B_local
        w0[o:o + (b - a)] = ev_w0[a:b]
        w1[o:o + (b - a)] = ev_w1[a:b]
        off[s * (B_local + 1):(s + 1) * (B_local + 1)] = (
            np.searchsorted(ev_row[a:b],
                            np.arange(s * B_local, (s + 1) * B_local + 1))
            .astype(np.int32))

    return bucketing.Bucket(
        read_ids=bk.read_ids, B=B, W=bk.W, E=n_shards * E_s,
        lens=lens, ev_row=r, ev_w0=w0, ev_w1=w1, ev_off=off,
        n_used=bk.n_used)


def run_shards(shards, cfg: StaticCfg, on_bucket=None) -> dict:
    """``device_step`` on each shard's device inputs (``shards``: per
    device a (lens, ev_off, ev_pk) tuple of tensors on it; ``cfg``
    describes ONE shard), every shard launched before the first D2H.
    ``on_bucket(cfg, lens, ev_off, ev_pk)`` sees each shard's inputs
    before its step. Returns the outputs on the host, concatenated in
    shard order, plus ``global_rep_len``: the sum of every row's
    ``rep_len_sum``, the host sum that replaces ``raft_tpu``'s ``psum``."""
    outs = []
    for args in shards:
        if on_bucket is not None:
            on_bucket(cfg, *args)
        outs.append(device_step(*args, cfg=cfg))
    host = {k: (np.concatenate([o[k].cpu().numpy() for o in outs])
                if len(outs) > 1 else outs[0][k].cpu().numpy())
            for k in outs[0]}
    host["global_rep_len"] = int(
        host["packed"][:, rep_len_sum_col(cfg)].sum(dtype=np.int64))
    return host


def sharded_device_step(devices):
    """The device step over ``devices``, one shard each, from host arrays.

    ``step(lens, ev_off, ev_pk, *, cfg, on_bucket=None)`` takes a sharded
    bucket's host arrays in ``shard_bucket``'s layout — int32 ``lens``
    ``[n·B]``, ``ev_off`` ``[n·(B+1)]`` and ``ev_pk`` ``[n·E]`` (pack32)
    or ``[n·E, 2]`` (pairs) — with ``cfg`` describing ONE shard (B, E per
    shard). Each shard's slices go to its device, on a card as fresh
    allocations (the pairs kernel needs 8-byte-aligned events), and
    ``run_shards`` runs them. Over one device this is the unsharded step:
    one H2D, one ``device_step``, its D2H. The engine gathers its inputs
    on the device instead (``ops.gather_cuda``) and calls ``run_shards``
    itself."""
    devices = [torch.device(d) for d in devices]

    def step(lens, ev_off, ev_pk, *, cfg: StaticCfg,
             on_bucket=None) -> dict:
        shards = [tuple(
            torch.from_numpy(np.ascontiguousarray(a[s * m:(s + 1) * m]))
            .to(dev)
            for a, m in ((lens, cfg.B), (ev_off, cfg.B + 1), (ev_pk, cfg.E)))
            for s, dev in enumerate(devices)]
        return run_shards(shards, cfg, on_bucket)

    return step
