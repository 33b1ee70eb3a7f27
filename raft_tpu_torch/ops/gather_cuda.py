"""The device inputs of every bucket, gathered on the card: the wrapper
around the hand-written CUDA kernel ``raft_tpu_torch/csrc/gather.cu`` and
its plain PyTorch twin.

``gather(table, plan)`` turns one upload of the read-grouped event table
(``upload_table``: ``ev_off`` int64 [n+1], ``w0``, ``w1`` int32 [m],
``lens`` int32 [n]) into every device step's inputs at once: for each
step of ``plan`` (``GatherPlan``: a bucket, or one shard of it), its
``lens`` [B], ``ev_off`` [B+1] and packed events ``ev_pk`` [E] (pack32)
or [E, 2] (pairs), in one int32 arena; ``views`` cuts a step's three
arrays out of it. They are, element for element, what
``engine_torch.host_inputs`` builds on the host from
``bucketing.iter_buckets``' bucket (``parallel.mesh.shard_bucket``'s
shard): padded rows with ``ev_off`` at the step's event total, padded
event slots of span 0, events whose window indices wrap in the bucket's
int16 columns wrapped the same way (``bucketing.event_dtype``).

It replaces no TPU kernel: ``raft_tpu`` gathers and packs each bucket on
the host (``bucketing.iter_buckets``, ``engine_jax.pack_events``) and
copies it over the link. On a card the host's per-event passes and a
pageable copy per array of every bucket cost far more than the bytes they
move, so the card does that work from one copy of the table.

For CPU tensors the wrapper runs ``gather_torch``; for CUDA tensors it
launches the kernel or raises — there is no fallback. The kernel builds
with the port's other kernels into one library at first use
(``ops/_lib.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.ops import _lib
from raft_tpu_torch.ops.pileup_cuda import ev_bits_w0

# The kernel's name as a profiler trace shows it.
KERNEL_NAMES = ("gather_rows",)

ROWS = 256    # rows of a step per block: one thread each in the row scan
ALIGN = 128   # each array of the arena starts on a 512-byte boundary
# A step's fields in the plan's int64 metadata, in this order (mirrors
# csrc/gather.cu).
FIELDS = ("rid0", "n_used", "B", "E", "W", "k", "pairs", "trunc16",
          "lens_at", "off_at", "ev_at")
NF = len(FIELDS)


class Step(NamedTuple):
    """One device step's inputs to gather: the reads of its rows
    (``read_ids``, ``n_used`` of the ``B`` rows hold one), its ``E``
    event slots, the bucket's ``W``, the wire format (``pairs``, else
    pack32, w0 in ``ev_bits_w0(W)`` bits) and ``trunc16``: the bucket's
    event columns are int16 (``bucketing.event_dtype``)."""
    read_ids: np.ndarray
    B: int
    E: int
    W: int
    pairs: bool
    trunc16: bool


def _up(x: int) -> int:
    return -(-x // ALIGN) * ALIGN


class GatherPlan:
    """The steps of one device, laid out: ``meta`` (int64: the steps'
    ``FIELDS``, then each block's (step, first row), then the steps' read
    ids), ``n_blocks`` blocks of ``ROWS`` rows, and the arena's ``words``.
    ``at[i]`` is step i's (lens, ev_off, ev_pk) word offsets."""

    def __init__(self, steps: list[Step]):
        self.steps = steps
        rows, blocks, self.at = [], [], []
        rid0 = words = 0
        for i, st in enumerate(steps):
            la = words
            oa = _up(la + st.B)
            ea = _up(oa + st.B + 1)
            words = _up(ea + st.E * (2 if st.pairs else 1))
            self.at.append((la, oa, ea))
            rows.append((rid0, len(st.read_ids), st.B, st.E, st.W,
                         ev_bits_w0(st.W), int(st.pairs), int(st.trunc16),
                         la, oa, ea))
            blocks += [(i, r0) for r0 in range(0, st.B, ROWS)]
            rid0 += len(st.read_ids)
        self.words = words
        self.n_blocks = len(blocks)
        self.blocks_at = NF * len(steps)
        self.rids_at = self.blocks_at + 2 * len(blocks)
        self.meta = np.concatenate([
            np.asarray(rows, np.int64).reshape(-1),
            np.asarray(blocks, np.int64).reshape(-1),
            *(np.asarray(st.read_ids, np.int64) for st in steps)])

    def out_bytes(self, i: int) -> int:
        """Bytes of step i's three arrays."""
        st = self.steps[i]
        return 4 * (2 * st.B + 1 + st.E * (2 if st.pairs else 1))


def upload_table(ev_off, w0, w1, lens, device):
    """The read-grouped event table on ``device``: four copies, the only
    ones the steps' inputs take. Returns the tensors and their bytes."""
    arrs = (np.ascontiguousarray(ev_off, np.int64),
            np.ascontiguousarray(w0, np.int32),
            np.ascontiguousarray(w1, np.int32),
            np.ascontiguousarray(lens, np.int32))
    return (tuple(torch.from_numpy(a).to(device) for a in arrs),
            sum(a.nbytes for a in arrs))


def views(arena, plan: GatherPlan, i: int):
    """Step i's (lens [B], ev_off [B+1], ev_pk [E] or [E, 2]): views of
    the arena."""
    st = plan.steps[i]
    la, oa, ea = plan.at[i]
    pk = arena[ea:ea + st.E * (2 if st.pairs else 1)]
    return (arena[la:la + st.B], arena[oa:oa + st.B + 1],
            pk.view(st.E, 2) if st.pairs else pk)


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def gather_torch(table, meta, plan: GatherPlan):
    """Plain PyTorch twin of the kernel, from the same table and metadata.
    Step by step: each row's slab of the table (its read's events, in
    table order) lands after the slabs of the rows before it, each event
    packed as ``engine_torch.pack_events`` packs it (valid iff w1 >= w0
    and 0 <= w0 < W, w1 clamped to W-1, span 0 and w0 0 otherwise) after
    the int16 wrap where ``trunc16``; padded rows hold length 0 and the
    step's event total as offset, padded slots 0."""
    off_g, w0s, w1s, lens_g = table
    dev = w0s.device
    arena = torch.zeros(plan.words, dtype=torch.int32, device=dev)
    m = meta.cpu().numpy()
    i64 = torch.int64
    for i in range(len(plan.steps)):
        rid0, n_used, B, E, W, k, pairs, t16, la, oa, ea = (
            int(v) for v in m[NF * i:NF * (i + 1)])
        rids = meta[plan.rids_at + rid0:plan.rids_at + rid0 + n_used]
        start = off_g[rids]
        cnt = off_g[rids + 1] - start
        ends = torch.cumsum(cnt, 0)
        tot = int(ends[-1]) if n_used else 0
        arena[la:la + n_used] = lens_g[rids]
        off = torch.full((B + 1,), tot, dtype=i64, device=dev)
        off[0] = 0
        off[1:n_used + 1] = ends
        arena[oa:oa + B + 1] = off.to(torch.int32)
        src = (torch.repeat_interleave(start, cnt)
               + torch.arange(tot, dtype=i64, device=dev)
               - torch.repeat_interleave(off[:n_used], cnt))
        a = w0s[src].to(i64)
        b = w1s[src].to(i64)
        if t16:
            a, b = _wrap16(a), _wrap16(b)
        ok = (b >= a) & (a >= 0) & (a < W)
        span = torch.where(ok, torch.clamp(b, max=W - 1) - a + 1, 0)
        a = torch.where(ok, a, 0)
        if pairs:
            arena[ea:ea + 2 * tot] = torch.stack(
                [a, span], dim=1).reshape(-1).to(torch.int32)
        else:
            v = a | (span << k)
            arena[ea:ea + tot] = torch.where(
                v >= 2**31, v - 2**32, v).to(torch.int32)
    return arena


def gather(table, plan: GatherPlan):
    """Every step's inputs of ``plan`` from ``table`` (``upload_table``'s
    tensors, on one device), in one int32 arena (``views`` cuts it). CPU
    tensors take ``gather_torch``; CUDA tensors launch the kernel once on
    the current stream, ``plan.n_blocks`` blocks of ``ROWS`` threads.
    Arena words between the arrays are left undefined."""
    off_g, w0s, w1s, lens_g = table
    for name, t, dt in (("ev_off", off_g, torch.int64),
                        ("w0", w0s, torch.int32), ("w1", w1s, torch.int32),
                        ("lens", lens_g, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dt}, got {t.dtype}")
        if t.device != w0s.device:
            raise ValueError(f"{name} on {t.device}, w0 on {w0s.device}")
    dev = w0s.device
    meta = torch.from_numpy(plan.meta).to(dev)
    if dev.type == "cpu":
        return gather_torch(table, meta, plan)
    if dev.type != "cuda":
        raise ValueError(f"gather runs on cpu or cuda tensors, not {dev}")
    arena = torch.empty(plan.words, dtype=torch.int32, device=dev)
    if plan.n_blocks:
        lib = _lib.get_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.raft_gather(off_g.data_ptr(), w0s.data_ptr(),
                                  w1s.data_ptr(), lens_g.data_ptr(),
                                  meta.data_ptr(), arena.data_ptr(),
                                  plan.n_blocks, plan.blocks_at,
                                  plan.rids_at, stream)
        if err:
            raise RuntimeError(
                f"gather kernel launch failed: CUDA error {err}")
        _lib.launches["gather"] += 1
    return arena
