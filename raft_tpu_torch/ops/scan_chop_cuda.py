"""The device step after the pileup on Hopper: the wrapper around the
hand-written CUDA kernel ``raft_tpu_torch/csrc/scan_chop.cu`` and its
plain PyTorch twin.

``scan_chop(cov, lens, cfg)`` maps one bucket's int32 coverage ``[B, W]``
and read lengths ``[B]`` to the dict of ``engine_jax.device_step_impl``
less the coverage: ``packed``, the int32 ``[B, 2K+2F+5]`` per-read array
(``engine_torch.unpack_out``'s columns), and in ``diff8`` mode
``diff8``, the int8 ``[B, W]`` per-window coverage diff. It replaces
``engine_jax.repeat_scan``, ``chop_markers``, the ``diff8`` branch and
the packing, which XLA fused into one program with the pileup on the
TPU.

For a CPU tensor the wrapper runs ``scan_chop_torch``, the plain stages
of ``engine_torch``; for a CUDA tensor it launches the kernel or raises —
there is no fallback. The kernel is built with the port's other kernels
into one library at first use (``ops/_lib.py``).

``launch_plan`` picks the regime and the launch from (B, W, M, K, F) in
Python, where the CPU tests can check it: a warp per row for the bench
path's widths and flags, a thread-block cluster per row for few very
wide rows and for rows with many slots or markers (``csrc/scan_chop.cu``
says why), and in the cluster regime whether the slots and the
surviving markers fit in shared memory or take the global-memory
branch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

from raft_tpu_torch.ops import _lib

if TYPE_CHECKING:
    from raft_tpu_torch.engine_torch import StaticCfg

# The kernels' names as a profiler trace shows them.
KERNEL_NAMES = ("scan_chop_rows", "scan_chop_cluster")

INT32_MAX = 2**31 - 1
# Launch plan constants; they mirror csrc/scan_chop.cu.
SMEM_MAX = 232_448     # dynamic shared memory a block may opt into (sm_90)
H100_SMS = 132
TILE = 128             # windows of one 16-byte load per lane of a warp
STEP = 4 * TILE        # windows a warp loads at once (four tiles in flight)
ROWS_WARPS = 8         # regime 1: rows (warps) per block
NARROW_W = 8192        # regime 1 up to this width ...
FEW_ROWS_W = 4096      # ... but rows at least this wide take regime 2
ROWS_PER_SM = 4        # ... when fewer than this many an SM,
ROWS_MAX_M = 256       # ... as do rows with more markers (32 a warp step)
ROWS_SMEM = 96 * 1024  # ... or whose slices do not fit in this much
WIDE_WARPS = 16        # regime 2: most warps per block
WALK_STEPS = 2         # regime 2: steps a warp walks, where the row allows
MARKER_TILES = 2       # regime 2: candidates per thread, where warps allow
MAX_CLUSTER = 16       # regime 2: most blocks per row (16 is non-portable)
WIDE_FIXED = 512       # regime 2: ints of the kernel's own bookkeeping
WIDE_SMEM = 48 * 1024  # regime 2: shared memory a block takes at most
STARS_CAP = 4096       # regime 2: most survivors a block keeps on chip


class LaunchPlan(NamedTuple):
    """How ``raft_scan_chop`` launches. ``regime`` 1: a warp per row,
    ``rows_per_block`` rows a block, each warp's packed row and survivors
    in a ``slice`` of shared memory (ints). ``regime`` 2: a cluster of
    ``cluster`` blocks per row, each warp ``seg`` windows of it; a block
    copies up to ``slot_cap`` slots to shared memory (more are searched
    in global memory) and takes ``mc`` marker candidates, whose survivors
    stay in shared memory if ``stars_smem`` (else a [B, M] scratch). A
    warp walks ``tile`` windows at a time; ``smem`` is the dynamic shared
    memory in bytes; ``vec``: the rows are read with 16-byte loads (W % 4
    == 0)."""
    regime: int
    grid: int
    block: int
    rows_per_block: int
    cluster: int
    tile: int
    seg: int
    smem: int
    slice: int
    slot_cap: int
    mc: int
    stars_smem: bool
    vec: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(B: int, W: int, M: int, K: int, F: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The launch of one bucket: ``B`` rows of ``W`` windows with ``M``
    marker, ``K`` repeat and ``F`` fragment slots, on a card with ``sms``
    SMs.

    Regime 1 up to ``NARROW_W`` windows, for at most ``ROWS_MAX_M``
    markers and slices (2K+2F+5+M ints) of which ``ROWS_WARPS`` fit in
    ``ROWS_SMEM`` bytes; but fewer than ``ROWS_PER_SM`` rows an SM of
    ``FEW_ROWS_W`` or more windows, which a warp each would walk alone,
    take regime 2, like every other bucket.

    Regime 2: blocks per row double (up to ``MAX_CLUSTER``) while the
    grid holds fewer than two blocks an SM and each block keeps at least
    two steps of windows. Within ``WIDE_SMEM`` bytes: the block's
    survivors if at most ``STARS_CAP``, then up to K slot pairs. Warps
    per block (up to ``WIDE_WARPS``): enough that each walks
    ``WALK_STEPS`` steps, or more where the block's marker candidates
    ask for them; segments are whole tiles."""
    vec = W % 4 == 0
    slice_ = 2 * K + 2 * F + 5 + M
    if (W <= NARROW_W and M <= ROWS_MAX_M
            and ROWS_WARPS * slice_ * 4 <= ROWS_SMEM
            and (W < FEW_ROWS_W or B >= ROWS_PER_SM * sms)):
        return LaunchPlan(1, _cdiv(B, ROWS_WARPS), 32 * ROWS_WARPS,
                          ROWS_WARPS, 1, STEP, _cdiv(W, TILE) * TILE,
                          ROWS_WARPS * slice_ * 4, slice_, 0, 0, True, vec)
    C = 1
    while C < MAX_CLUSTER and B * C < 2 * sms and W >= 4 * C * STEP:
        C *= 2
    mc = _cdiv(M, C)
    stars_smem = mc <= STARS_CAP
    room = WIDE_SMEM // 4 - WIDE_FIXED - (mc if stars_smem else 0)
    slot_cap = min(K, room // 2)
    nw = min(WIDE_WARPS, max(_cdiv(W, C * WALK_STEPS * STEP),
                             _cdiv(mc, 32 * MARKER_TILES), 1))
    seg = _cdiv(W, C * nw * TILE) * TILE
    smem = 4 * (WIDE_FIXED + 2 * slot_cap + (mc if stars_smem else 0))
    return LaunchPlan(2, B * C, 32 * nw, 1, C, STEP, seg, smem, 0, slot_cap,
                      mc, stars_smem, vec)


def scan_chop_torch(cov, lens, cfg: StaticCfg) -> dict:
    """Plain PyTorch twin of the kernel: ``engine_torch.repeat_scan``,
    ``chop_markers``, ``torch.diff`` for ``diff8`` and the packing
    concatenate, as ``engine_jax.device_step_impl`` runs them."""
    from raft_tpu_torch import engine_torch as et  # it imports this module
    I32 = torch.int32
    rep_s, rep_e, rep_n, rep_len_sum = et.repeat_scan(cov, lens, cfg)
    frags = et.chop_markers(lens, rep_s, rep_e, cfg)
    out = {}
    if cfg.cov_out == "diff8":
        diff = torch.diff(cov, dim=1, prepend=torch.zeros_like(cov[:, :1]))
        ok8 = (diff.amax(dim=1) <= 127) & (diff.amin(dim=1) >= -128)
        out["diff8"] = diff.to(torch.int8)
    else:
        ok8 = torch.ones(cfg.B, dtype=torch.bool, device=lens.device)
    out["packed"] = torch.cat(
        [rep_s, rep_e, frags["char_start"], frags["char_len"],
         rep_n[:, None], rep_len_sum[:, None], frags["n_frag"][:, None],
         frags["whole"][:, None].to(I32), ok8[:, None].to(I32)], dim=1)
    return out


_PARAMS = ("reso", "high_cov", "repeat_length", "flank", "interval_length",
           "div", "overlap_length")


def _check(cov, lens, cfg: StaticCfg) -> None:
    from raft_tpu_torch.engine_torch import COV_OUT_MODES
    if cfg.cov_out not in COV_OUT_MODES:
        raise ValueError(f"cov_out={cfg.cov_out!r}: must be one of "
                         f"{', '.join(COV_OUT_MODES)}")
    for name, t, shape in (("cov", cov, (cfg.B, cfg.W)),
                           ("lens", lens, (cfg.B,))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if cov.device != lens.device:
        raise ValueError(f"cov on {cov.device}, lens on {lens.device}")
    for name in _PARAMS:
        v = getattr(cfg, name)
        if not -INT32_MAX - 1 <= v <= INT32_MAX:
            raise ValueError(f"{name}={v} does not fit in int32")
    if cfg.reso < 1 or cfg.interval_length < 1 or cfg.div < 1:
        raise ValueError("reso, interval_length and div must be >= 1")


def scan_chop(cov, lens, cfg: StaticCfg) -> dict:
    """One bucket's ``{"packed"}`` (plus ``"diff8"`` in ``diff8`` mode)
    from its coverage ``cov`` int32 [B, W] and ``lens`` int32 [B]. CPU
    tensors take ``scan_chop_torch``; CUDA tensors launch the kernel on
    the current stream."""
    from raft_tpu_torch.engine_torch import packed_width
    _check(cov, lens, cfg)
    dev = cov.device
    if dev.type == "cpu":
        return scan_chop_torch(cov, lens, cfg)
    if dev.type != "cuda":
        raise ValueError(f"scan_chop runs on cpu or cuda tensors, not {dev}")
    if not (cov.is_contiguous() and lens.is_contiguous()):
        raise ValueError("the kernel takes contiguous cov and lens")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(cfg.B, cfg.W, cfg.M, cfg.K, cfg.F, sms)
    diff8 = cfg.cov_out == "diff8"
    lib = _lib.get_lib()
    out = {"packed": torch.empty((cfg.B, packed_width(cfg)),
                                 dtype=torch.int32, device=dev)}
    if diff8:
        out["diff8"] = torch.empty((cfg.B, cfg.W), dtype=torch.int8,
                                   device=dev)
    # survivors that do not fit in shared memory go to a [B, M] scratch
    stars = (None if plan.stars_smem else
             torch.empty((cfg.B, cfg.M), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raft_scan_chop(
            cov.data_ptr(), lens.data_ptr(), out["packed"].data_ptr(),
            out["diff8"].data_ptr() if diff8 else None,
            None if stars is None else stars.data_ptr(),
            cfg.B, cfg.W, cfg.M, cfg.K, cfg.F,
            *(getattr(cfg, n) for n in _PARAMS), int(diff8), plan.regime,
            plan.grid, plan.block, plan.cluster, plan.seg, plan.slice,
            plan.slot_cap, plan.mc, int(plan.stars_smem), plan.smem,
            int(plan.vec and cov.data_ptr() % 16 == 0), stream)
    if err:
        raise RuntimeError(f"scan_chop kernel launch failed: CUDA error "
                           f"{err}")
    _lib.launches["scan_chop"] += 1
    return out
