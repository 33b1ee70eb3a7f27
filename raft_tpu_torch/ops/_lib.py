"""The port's CUDA kernel library: every ``csrc/*.cu`` compiled by ``nvcc``
(one process per source, all started together) and linked into one
``_build/libraft_kernels.so`` with a plain C interface, loaded with
ctypes, for the wrappers ``ops/pileup_cuda.py`` (``raft_pileup``),
``ops/scan_chop_cuda.py`` (``raft_scan_chop``) and ``ops/gather_cuda.py``
(``raft_gather``).

The build runs at the first CUDA call, never at import, and again
whenever a source is newer than the library.

``launches`` counts each kernel's launches: its wrapper adds one where it
launches, and nowhere else. A caller zeroes the counts
(``zero_launches``) just before the run it wants to count, or takes a
snapshot (``launch_counts``) and later the counts since it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libraft_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's install prefix
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each C entry point's arguments: device pointers, ints, the cudaStream_t.
ENTRY_POINTS = {
    "raft_pileup": [_P] * 3 + [_I] * 12 + [_P],
    "raft_scan_chop": [_P] * 5 + [_I] * 24 + [_P],
    "raft_gather": [_P] * 6 + [_I] * 3 + [_P],
}

# The kernels by the names their wrappers count launches under.
KERNELS = ("pileup", "scan_chop", "gather")
launches = dict.fromkeys(KERNELS, 0)

_lib = None
_lock = threading.Lock()


def zero_launches() -> None:
    for k in launches:
        launches[k] = 0


def launch_counts(since: dict | None = None) -> dict:
    """Each kernel's launches, less those of the snapshot ``since``."""
    return {k: n - (since or {}).get(k, 0) for k, n in launches.items()}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


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
    srcs = sources()
    names = ", ".join(os.path.basename(s) for s in srcs)
    so = os.path.join(build_dir, LIB_NAME)
    if (not force and os.path.exists(so) and os.path.getmtime(so)
            >= max(os.path.getmtime(s) for s in srcs)):
        return so, ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernels ({names}): nvcc not found (set "
            "CUDA_HOME or put nvcc on PATH); CUDA tensors have no other "
            "path")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [os.path.join(build_dir, f"{os.path.basename(src)}.{os.getpid()}"
                         ".o") for src in srcs]  # nvcc goes by the suffix
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for src, obj in zip(srcs, objs)]
    outs = [p.communicate() for p in procs]
    log = "".join(out + err for out, err in outs)
    try:
        for src, p, (_, err) in zip(srcs, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building the CUDA kernels ({names}) on "
                    f"{os.path.basename(src)} (rc {p.returncode}):\n{err}")
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed linking the CUDA kernels "
                               f"({names}) (rc {res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    return so, log + res.stdout + res.stderr


def get_lib():
    """The loaded library, built first if needed, with every entry point's
    ``argtypes`` declared; each returns ``cudaGetLastError()`` as int."""
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build_kernels()
            lib = ctypes.CDLL(so)
            for name, args in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
