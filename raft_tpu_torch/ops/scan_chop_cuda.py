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

``launch_plan`` picks the block size and each thread's chunk of windows
from (B, W, M) in Python, where the CPU tests can check it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

from raft_tpu_torch.ops import _lib

if TYPE_CHECKING:
    from raft_tpu_torch.engine_torch import StaticCfg

# The kernel's name as a profiler trace shows it.
KERNEL_NAMES = ("scan_chop",)

MAX_THREADS = 1024
MIN_CHUNK = 4  # fewest windows a thread scans, while the row allows
INT32_MAX = 2**31 - 1


class LaunchPlan(NamedTuple):
    """How ``raft_scan_chop`` launches: one block of ``block`` threads per
    row (``grid`` blocks); thread t scans windows ``[t*chunk,
    (t+1)*chunk)`` of its row."""
    grid: int
    block: int
    chunk: int


def launch_plan(B: int, W: int, M: int) -> LaunchPlan:
    """A block per row, with one thread per ``MIN_CHUNK`` windows or per
    marker candidate, whichever asks for more, in whole warps, at most
    ``MAX_THREADS``; each thread scans ``ceil(W / block)`` windows."""
    want = max(-(-W // MIN_CHUNK), M, 1)
    block = min(MAX_THREADS, -(-want // 32) * 32)
    return LaunchPlan(B, block, max(-(-W // block), 1))


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
    plan = launch_plan(cfg.B, cfg.W, cfg.M)
    diff8 = cfg.cov_out == "diff8"
    lib = _lib.get_lib()
    out = {"packed": torch.empty((cfg.B, packed_width(cfg)),
                                 dtype=torch.int32, device=dev)}
    if diff8:
        out["diff8"] = torch.empty((cfg.B, cfg.W), dtype=torch.int8,
                                   device=dev)
    stars = torch.empty((cfg.B, cfg.M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raft_scan_chop(
            cov.data_ptr(), lens.data_ptr(), out["packed"].data_ptr(),
            out["diff8"].data_ptr() if diff8 else None, stars.data_ptr(),
            cfg.B, cfg.W, cfg.M, cfg.K, cfg.F,
            *(getattr(cfg, n) for n in _PARAMS), int(diff8), plan.block,
            plan.chunk, stream)
    if err:
        raise RuntimeError(f"scan_chop kernel launch failed: CUDA error "
                           f"{err}")
    _lib.launches["scan_chop"] += 1
    return out
