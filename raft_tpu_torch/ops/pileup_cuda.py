"""Coverage pileup on Hopper: the wrapper around the hand-written CUDA
kernel ``raft_tpu_torch/csrc/pileup.cu`` and its plain PyTorch twin.

``pileup(ev_off, ev_pk, cfg)`` maps one bucket's event slabs to int32
coverage ``[B, W]``. It replaces the TPU's Pallas kernel
(``raft_tpu/ops/pileup_pallas.py``) and the XLA scatter path
(``engine_jax.pileup_diff_scatter``) for every bucket shape, and it reads
the ``[B+1]`` offsets and the packed events directly, so the row rebuild
and the event decode of ``engine_jax`` happen inside it.

The event wire format is defined here, beside the kernel that reads it:
``ev_bits_w0`` and ``decode_events`` are what ``engine_torch`` packs and
unpacks with.

For a CPU tensor the wrapper runs ``pileup_torch``; for a CUDA tensor it
launches the kernel or raises — there is no fallback. The kernel is built
with the port's other kernels into one library at first use
(``ops/_lib.py``).

``launch_plan`` picks the kernel's regime and launch shape from (B, W) in
Python, where the CPU tests can check it: warp-per-row blocks for rows
whose double-buffered shared-memory rows fit (every width of the bench
paths), block-per-(row, stripe) for wider ones. ``csrc/pileup.cu`` says
why.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

from raft_tpu_torch.ops import _lib

if TYPE_CHECKING:
    from raft_tpu_torch.engine_torch import StaticCfg

# The kernels' names as a profiler trace shows them.
KERNEL_NAMES = ("pileup_rows", "pileup_stripes")

# Launch plan constants (sm_90). A block may opt into 232,448 bytes of
# dynamic shared memory; an SM holds 233,472, less 1 KB reserved per block.
SMEM_MAX = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
H100_SMS = 132
R1_WARPS = 8           # regime 1: warps (rows in flight) per block
R1_BLOCKS_PER_SM = 8   # regime 1: grid cap, blocks per SM (at most 64 warps)
R2_FEW_ROWS_W = 2048   # B <= R1_WARPS rows this wide take regime 2
R2_THREADS = 1024      # regime 2: threads per (row, stripe) block
R2_STATIC_SMEM = 128   # regime 2: its static shared memory (32 warp sums)
R2_ALIGN = 32 * 4      # a stripe gives each warp a 16-byte aligned share
STRIPE = 24576         # regime 2: most windows per block (best at W=2^20)
MIN_STRIPE = 4096      # regime 2: fewest windows per block of a wide row


class LaunchPlan(NamedTuple):
    """How ``raft_pileup`` launches: ``regime`` 1 (a warp per row, blocks
    of ``R1_WARPS`` warps looping over rows) or 2 (a block per (row,
    stripe of ``stripe`` windows)); ``grid`` (x, y); threads per
    ``block``; dynamic shared memory ``smem`` bytes; ``tma_store``: rows
    leave by TMA bulk store (W % 4 == 0, so rows are 16-byte aligned),
    else by coalesced int stores."""
    regime: int
    grid: tuple[int, int]
    block: int
    stripe: int
    smem: int
    tma_store: bool


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_plan(B: int, W: int, sms: int = H100_SMS) -> LaunchPlan:
    """The launch of one bucket ``[B, W]`` on a card with ``sms`` SMs.

    Regime 1 whenever ``R1_WARPS`` double-buffered rows fit in a block's
    shared memory (W <= 2048 among powers of two), except for at most
    ``R1_WARPS`` rows of ``R2_FEW_ROWS_W`` windows or more, which one warp
    per row scans too slowly. Its grid is the rows over ``R1_WARPS``,
    capped at ``R1_BLOCKS_PER_SM`` resident blocks per SM. Else regime 2,
    a block per (row, stripe): the stripe is at most ``STRIPE`` windows,
    and narrower (down to ``MIN_STRIPE``) when that many would leave SMs
    without a block. Stripes are multiples of ``R2_ALIGN``."""
    tma = W % 4 == 0
    stride = (W + 4) // 4 * 4  # ints per row buffer: W, the sink, alignment
    smem = 2 * R1_WARPS * stride * 4
    if smem <= SMEM_MAX and not (B <= R1_WARPS and W >= R2_FEW_ROWS_W):
        fit = min(SMEM_PER_SM // (smem + SMEM_RESERVED), 64 // R1_WARPS)
        grid = min(-(-B // R1_WARPS), sms * min(R1_BLOCKS_PER_SM, fit))
        return LaunchPlan(1, (grid, 1), 32 * R1_WARPS, W, smem, tma)
    s = min(STRIPE, _round_up(W, R2_ALIGN))
    per_row = -(-sms // max(B, 1))  # stripes per row: a block on every SM
    if -(-W // s) < per_row:
        s = min(max(MIN_STRIPE, _round_up(-(-W // per_row), R2_ALIGN)), s)
    return LaunchPlan(2, (B, -(-W // s)), R2_THREADS, s, (s + 4) * 4, tma)


def ev_bits_w0(W: int) -> int:
    """Bits for a window index in [0, W): the pack32 word holds w0 in its
    low ``k`` bits and the span above them."""
    return max(int(W - 1).bit_length(), 1)


def decode_events(ev_pk, W: int, pairs: bool):
    """Wire events → (w0, span) int64 [E]. ``ev_pk`` is int32 [E] holding
    the uint32 pack32 words (decoded in int64, since PyTorch's ``>>`` on
    int32 is arithmetic) or int32 [E, 2] (w0, span) pairs. Span 0 marks an
    invalid or padding event."""
    if pairs:
        return ev_pk[:, 0].to(torch.int64), ev_pk[:, 1].to(torch.int64)
    k = ev_bits_w0(W)
    v = ev_pk.to(torch.int64) & 0xFFFFFFFF
    return v & ((1 << k) - 1), v >> k


def pileup_torch(ev_off, ev_pk, cfg: StaticCfg):
    """Plain PyTorch twin of the kernel, with the kernel's semantics: event
    ``e`` belongs to the row ``b`` with ``ev_off[b] <= e < ev_off[b+1]``
    (padding otherwise) and counts iff span >= 1 and 0 <= w0 < W, with w1
    clamped to W-1. +1 at w0 and -1 after w1 go into a ``[B*(W+1)+1]``
    buffer whose last slot is the sink for everything that does not count;
    a row cumsum in int32 gives the coverage."""
    B, W, E = cfg.B, cfg.W, cfg.E
    dev = ev_pk.device
    e = torch.arange(E, dtype=torch.int32, device=dev)
    row = torch.searchsorted(ev_off, e, right=True).to(torch.int64) - 1
    w0, span = decode_events(ev_pk, W, cfg.ev_pack == 0)
    ok = (row >= 0) & (row < B) & (span >= 1) & (w0 >= 0) & (w0 < W)
    w1 = torch.clamp(w0 + span - 1, max=W - 1)
    stride = W + 1
    n = B * stride
    base = row * stride
    one = torch.ones(E, dtype=torch.int32, device=dev)
    diff = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    diff.index_add_(0, torch.where(ok, base + w0, n), one)
    diff.index_add_(0, torch.where(ok, base + w1 + 1, n), -one)
    return torch.cumsum(diff[:n].view(B, stride), dim=1,
                        dtype=torch.int32)[:, :W]


def _check(ev_off, ev_pk, cfg: StaticCfg) -> None:
    if cfg.ev_pack not in (0, 32):
        raise ValueError(f"event wire format {cfg.ev_pack} is not pack32 "
                         "or pairs")
    want = (cfg.E,) if cfg.ev_pack == 32 else (cfg.E, 2)
    for name, t, shape in (("ev_off", ev_off, (cfg.B + 1,)),
                           ("ev_pk", ev_pk, want)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ev_off.device != ev_pk.device:
        raise ValueError(f"ev_off on {ev_off.device}, ev_pk on "
                         f"{ev_pk.device}")


def pileup(ev_off, ev_pk, cfg: StaticCfg):
    """One bucket's coverage ``[B, W]`` int32.

    ``ev_off``: int32 [B+1] exclusive per-row event offsets (row-major
    slabs, padding after ``ev_off[B]``). ``ev_pk``: int32 [E] holding the
    uint32 pack32 words, or int32 [E, 2] (w0, span) pairs — the output of
    ``engine_torch.pack_events``. CPU tensors take ``pileup_torch``; CUDA
    tensors launch the kernel on the current stream."""
    _check(ev_off, ev_pk, cfg)
    dev = ev_pk.device
    if dev.type == "cpu":
        return pileup_torch(ev_off, ev_pk, cfg)
    if dev.type != "cuda":
        raise ValueError(f"pileup runs on cpu or cuda tensors, not {dev}")
    pairs = cfg.ev_pack == 0
    if pairs and ev_pk.data_ptr() % 8:
        raise ValueError("ev_pk pairs must be 8-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(cfg.B, cfg.W, sms)
    k = 0 if pairs else ev_bits_w0(cfg.W)
    lib = _lib.get_lib()
    cov = torch.empty((cfg.B, cfg.W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raft_pileup(ev_off.data_ptr(), ev_pk.data_ptr(),
                              cov.data_ptr(), cfg.B, cfg.W, cfg.E, k,
                              int(pairs), plan.regime, *plan.grid,
                              plan.block, plan.stripe, plan.smem,
                              int(plan.tma_store), stream)
    if err:
        raise RuntimeError(f"pileup kernel launch failed: CUDA error {err}")
    _lib.launches["pileup"] += 1
    return cov
