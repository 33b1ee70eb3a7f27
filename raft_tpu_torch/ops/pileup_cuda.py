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
with ``nvcc`` from ``csrc/*.cu`` into ``_build/`` at first use, and again
whenever a source is newer than the library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from raft_tpu_torch.engine_torch import StaticCfg

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libraft_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's install prefix
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches (CUDA tensors only); a caller resets it to 0 before the
# run it wants to count.
launches = 0

_lib = None
_lock = threading.Lock()


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"),
              os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    return None


def build_kernels(build_dir: str = BUILD_DIR,
                  force: bool = False) -> tuple[str, str]:
    """Compile ``csrc/*.cu`` into ``build_dir/libraft_kernels.so`` when it
    is missing or older than a source (or ``force``). Returns the library
    path and the compiler's output ("" when nothing was built). Raises
    RuntimeError when nvcc is missing or fails."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    so = os.path.join(build_dir, LIB_NAME)
    if (not force and os.path.exists(so) and os.path.getmtime(so)
            >= max(os.path.getmtime(s) for s in srcs)):
        return so, ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA pileup kernel: nvcc not found (set "
            "CUDA_HOME or put nvcc on PATH); CUDA tensors have no other "
            "pileup path")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building the pileup kernel "
                           f"(rc {res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build_kernels()
            lib = ctypes.CDLL(so)
            lib.raft_pileup.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
            lib.raft_pileup.restype = ctypes.c_int
            _lib = lib
    return _lib


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
    global launches
    _check(ev_off, ev_pk, cfg)
    dev = ev_pk.device
    if dev.type == "cpu":
        return pileup_torch(ev_off, ev_pk, cfg)
    if dev.type != "cuda":
        raise ValueError(f"pileup runs on cpu or cuda tensors, not {dev}")
    pairs = cfg.ev_pack == 0
    if pairs and ev_pk.data_ptr() % 8:
        raise ValueError("ev_pk pairs must be 8-byte aligned")
    k = 0 if pairs else ev_bits_w0(cfg.W)
    lib = _get_lib()
    cov = torch.empty((cfg.B, cfg.W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raft_pileup(ev_off.data_ptr(), ev_pk.data_ptr(),
                              cov.data_ptr(), cfg.B, cfg.W, cfg.E, k,
                              int(pairs), stream)
    if err:
        raise RuntimeError(f"pileup kernel launch failed: CUDA error {err}")
    launches += 1
    return cov
