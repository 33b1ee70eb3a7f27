"""ctypes bridge to the native C++ I/O library
(``raft_tpu_torch/_native/raftio.cpp``).

raft_tpu_torch's copy of ``raft_tpu/io/native.py``, unchanged apart from
its import paths, the emitters' spans and stats array (``_emit_native``)
and its build: the library is ``libraftio_torch.so`` in
the git-ignored ``raft_tpu_torch/_build/``, compiled by calling g++ with
fixed flags (``BUILD_CMD``) and no ``CXX``/``CXXFLAGS``/``LDFLAGS`` from
the environment. ``ctypes.CDLL`` loads it with ``RTLD_LOCAL``, so a
process that also loads ``raft_tpu`` holds two independent libraries; a
``_native_handle`` from one must never reach the other.

The native library provides streaming gz-aware FASTA/FASTQ + PAF parsing
and output emission at memory bandwidth — the reference's wall time is
dominated by parse+emit (SURVEY.md §6 Amdahl note), so this is the
critical host component. Built on demand with the toolchain in the image;
if the build fails every entry point returns ``None`` and callers fall
back to the pure-Python parsers (same semantics, slower).
"""

from __future__ import annotations

import ctypes as C
import fcntl
import os
import stat
import subprocess
import threading

import numpy as np

from raft_tpu_torch import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "_native", "raftio.cpp")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libraftio_torch.so")
BUILD_CMD = ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", _SRC, "-shared",
             "-lz"]
_lock = threading.Lock()
_lib = None
# the slots of the emitters' stats array (raftio.cpp, kEmitStats)
EMIT_STATS = ("count_ns", "render_ns", "write_ns", "write_calls", "shards",
              "bytes")
_NATIVE_SPAN = {f: f"emit.{f}.native" for f in ("fasta", "coverage",
                                                "repeats", "bed")}
_PREP_SPAN = {f: f"emit.{f}.prep" for f in _NATIVE_SPAN}
_build_failed = False


def _stale() -> bool:
    return (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC))


def _build() -> bool:
    """Compile ``_SO`` from ``_SRC`` when it is missing or older; one
    process at a time (a file lock), each writing a temporary file that
    replaces the library atomically. Returns False when g++ fails."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(_SO + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale():
            return True
        tmp = f"{_SO}.tmp{os.getpid()}"
        try:
            res = subprocess.run([*BUILD_CMD, "-o", tmp],
                                 capture_output=True, text=True)
        except OSError:
            return False
        if res.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if _stale() and not _build():
            _build_failed = True
            return None
        try:
            lib = C.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        _configure(lib)
        _lib = lib
        return _lib


def _configure(lib):
    P = C.POINTER
    lib.raftio_load_fasta.restype = C.c_void_p
    lib.raftio_load_fasta.argtypes = [C.c_char_p]
    lib.raftio_free_fasta.argtypes = [C.c_void_p]
    lib.rf_n_reads.restype = C.c_int64
    lib.rf_n_reads.argtypes = [C.c_void_p]
    lib.rf_real_reads.restype = C.c_int
    lib.rf_real_reads.argtypes = [C.c_void_p]
    lib.rf_name_blob.restype = C.c_void_p
    lib.rf_name_blob.argtypes = [C.c_void_p]
    lib.rf_name_blob_size.restype = C.c_int64
    lib.rf_name_blob_size.argtypes = [C.c_void_p]
    lib.rf_seq_blob.restype = C.c_void_p
    lib.rf_seq_blob.argtypes = [C.c_void_p]
    lib.rf_seq_off.restype = P(C.c_int64)
    lib.rf_seq_off.argtypes = [C.c_void_p]
    lib.rf_lens.restype = P(C.c_int64)
    lib.rf_lens.argtypes = [C.c_void_p]
    lib.rf_zero_copy.restype = C.c_int
    lib.rf_zero_copy.argtypes = [C.c_void_p]
    lib.raftio_index_fasta.restype = C.c_void_p
    lib.raftio_index_fasta.argtypes = [C.c_char_p]
    lib.raftio_index_fastx.restype = C.c_void_p
    lib.raftio_index_fastx.argtypes = [C.c_char_p]
    lib.rf_decomp_path.restype = C.c_char_p
    lib.rf_decomp_path.argtypes = [C.c_void_p]
    lib.rf_has_fastq.restype = C.c_int
    lib.rf_has_fastq.argtypes = [C.c_void_p]
    lib.raftio_load_fasta_range.restype = C.c_void_p
    lib.raftio_load_fasta_range.argtypes = [C.c_char_p, C.c_int64, C.c_int64]
    lib.raftio_load_fastx_range.restype = C.c_void_p
    lib.raftio_load_fastx_range.argtypes = [C.c_char_p, C.c_int64,
                                            C.c_int64, C.c_int]
    lib.rf_rec_off.restype = P(C.c_int64)
    lib.rf_rec_off.argtypes = [C.c_void_p]

    lib.raftio_load_paf.restype = C.c_void_p
    lib.raftio_load_paf.argtypes = [C.c_char_p, C.c_void_p]
    lib.raftio_free_paf.argtypes = [C.c_void_p]
    lib.raftio_preparse_paf.restype = C.c_void_p
    lib.raftio_preparse_paf.argtypes = [C.c_char_p]
    lib.raftio_free_pafpre.argtypes = [C.c_void_p]
    lib.raftio_resolve_paf.restype = C.c_void_p
    lib.raftio_resolve_paf.argtypes = [C.c_void_p, C.c_void_p]
    lib.rp_n_rows.restype = C.c_int64
    lib.rp_n_rows.argtypes = [C.c_void_p]
    lib.rp_symmetric.restype = C.c_int
    lib.rp_symmetric.argtypes = [C.c_void_p]
    lib.rp_n_names.restype = C.c_int64
    lib.rp_n_names.argtypes = [C.c_void_p]
    for col in ("a_id", "b_id", "a_s", "a_e", "b_s", "b_e"):
        fn = getattr(lib, f"rp_{col}")
        fn.restype = P(C.c_int32)
        fn.argtypes = [C.c_void_p]

    lib.raftio_paf_bin_events.restype = C.c_void_p
    lib.raftio_paf_bin_events.argtypes = [
        C.c_char_p, C.c_void_p, C.c_int64, C.c_int64, C.c_char_p, C.c_char_p]
    lib.raftio_free_pafbins.argtypes = [C.c_void_p]
    lib.rpb_n_rows.restype = C.c_int64
    lib.rpb_n_rows.argtypes = [C.c_void_p]
    lib.rpb_symmetric.restype = C.c_int
    lib.rpb_symmetric.argtypes = [C.c_void_p]
    lib.rpb_n_unknown.restype = C.c_int64
    lib.rpb_n_unknown.argtypes = [C.c_void_p]
    lib.rpb_n_bins.restype = C.c_int64
    lib.rpb_n_bins.argtypes = [C.c_void_p]
    lib.rpb_a_off.restype = P(C.c_int64)
    lib.rpb_a_off.argtypes = [C.c_void_p]
    lib.rpb_b_off.restype = P(C.c_int64)
    lib.rpb_b_off.argtypes = [C.c_void_p]

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.raftio_group_events.restype = C.c_void_p
    lib.raftio_group_events.argtypes = [
        i32p, i32p, i32p, i32p, i32p, i32p,   # six PAF columns
        C.c_int64, C.c_int,                    # n_rows, symmetric
        C.c_int64, i64p, C.c_int32]            # n_reads, lens, reso
    lib.raftio_free_grouped.argtypes = [C.c_void_p]
    for nm, rt in (("rge_n", C.c_int64), ("rge_off", P(C.c_int64)),
                   ("rge_w0", P(C.c_int32)), ("rge_w1", P(C.c_int32)),
                   ("rge_n_unknown", C.c_int64), ("rge_n_oob", C.c_int64)):
        getattr(lib, nm).restype = rt
        getattr(lib, nm).argtypes = [C.c_void_p]
    lib.raftio_bgzf_file.restype = C.c_int
    lib.raftio_bgzf_file.argtypes = [C.c_char_p, C.c_char_p]
    lib.raftio_cov_hist.restype = C.c_int
    lib.raftio_cov_hist.argtypes = [
        i32p, i32p, i64p, i64p,        # w0, w1, ev_off, lens
        C.c_int64, C.c_int32,          # n_reads, reso
        i64p, C.c_int64]               # hist out, hist_len
    lib.raftio_emit_frags_full.restype = C.c_int
    lib.raftio_emit_frags_full.argtypes = [
        C.c_char_p,              # path
        C.c_void_p, i64p,        # seq blob + offsets
        C.c_int64, i32p, i64p, i64p, u8p,   # frags
        C.c_int,                 # real_reads
        C.c_char_p, i64p,        # name blob + offsets (NUL-terminated names)
        C.c_void_p, C.c_void_p, C.c_void_p,   # align_code, start, end
        C.c_char_p, C.c_void_p,  # align blob + off
        C.c_char_p, C.c_void_p,  # suffix blob + off
        C.c_int64, C.c_int,      # first_read_num, append
        C.c_int, C.c_int,        # reserved, gz
        C.c_void_p]              # stats (int64 [6] or NULL)
    lib.raftio_reserve.restype = C.c_int
    lib.raftio_reserve.argtypes = [C.c_char_p, C.c_int64]
    lib.raftio_cov_sum.restype = C.c_int64
    lib.raftio_cov_sum.argtypes = [
        i32p, i32p, i64p, i64p,        # w0, w1, ev_off, lens
        C.c_int64, C.c_int32]          # n_reads, reso
    lib.rge_export.restype = C.c_int64
    lib.rge_export.argtypes = [
        C.c_void_p, i64p, C.c_int32,   # grouping, lens, reso
        i64p, i32p, i32p]              # off, w0, w1 out
    lib.raftio_emit_coverage.restype = C.c_int
    lib.raftio_emit_coverage.argtypes = [
        C.c_char_p, i32p, i64p, C.c_int64, C.c_int32, C.c_int64, C.c_int,
        C.c_int, C.c_void_p]
    lib.raftio_emit_coverage_events.restype = C.c_int
    lib.raftio_emit_coverage_events.argtypes = [
        C.c_char_p, i32p, i32p, i64p, i64p, C.c_int64, C.c_int32,
        C.c_int64, C.c_int, C.c_int, C.c_void_p]
    lib.raftio_emit_repeats.restype = C.c_int
    lib.raftio_emit_repeats.argtypes = [
        C.c_char_p, i32p, i32p, i64p, C.c_int64, C.c_int64, C.c_int,
        C.c_int, C.c_void_p]
    lib.raftio_emit_bed.restype = C.c_int
    lib.raftio_emit_bed.argtypes = [
        C.c_char_p, i32p, i32p, i64p, C.c_int64,
        C.c_void_p, C.c_void_p, C.c_void_p,   # align_code, start, end
        C.c_void_p, C.c_void_p,               # chrom blob + off
        C.c_int, C.c_int, C.c_void_p]

    lib.rf_name_off.restype = P(C.c_int64)
    lib.rf_name_off.argtypes = [C.c_void_p]
    lib.raftio_sim_meta.restype = C.c_void_p
    lib.raftio_sim_meta.argtypes = [C.c_void_p, C.c_void_p, C.c_int64]
    lib.raftio_free_sim_meta.argtypes = [C.c_void_p]
    for nm in ("rsm_start", "rsm_end", "rsm_align_code", "rsm_align_blob",
               "rsm_align_off", "rsm_suffix_blob", "rsm_suffix_off",
               "rsm_chrom_blob", "rsm_chrom_off"):
        fn = getattr(lib, nm)
        fn.restype = C.c_void_p
        fn.argtypes = [C.c_void_p]


class _FastaHandle:
    """Owns the C-side store; numpy views below keep a reference to it."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        if self._ptr:
            self._lib.raftio_free_fasta(self._ptr)
            self._ptr = None


class _PafHandle:
    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        if self._ptr:
            self._lib.raftio_free_paf(self._ptr)
            self._ptr = None


def attach_sim_meta(store) -> bool:
    """Parse simulated-read metadata in one native pass over the name blob
    (chop.hpp:25-70 contract) and cache it on the store: sets
    ``start_pos``/``end_pos`` (if not already set) and the contiguous
    align/suffix/chrom blob tables the native emitters consume.
    ``store.align``/``store.chrom`` stay None — python fallbacks
    materialize them lazily via ``ReadStore.ensure_sim_lists``. Returns
    False (caller uses the per-name python parse) when the library is
    missing or a name lacks the expected delimiters."""
    if getattr(store, "_sim_native", None) is not None:
        return True
    lib = _get_lib()
    if lib is None:
        return False
    n = store.n_reads
    h = getattr(store, "_native_handle", None)
    if h is not None and h._ptr is not None:
        nb_ptr = lib.rf_name_blob(h._ptr)
        no_ptr = lib.rf_name_off(h._ptr)
        keep = None
    else:
        blob, off = _name_blob0(store)
        keep = (blob, off)  # pin until the C call returns
        nb_ptr = C.cast(C.c_char_p(blob), C.c_void_p)
        no_ptr = off.ctypes.data
    ptr = lib.raftio_sim_meta(nb_ptr, no_ptr, n)
    del keep
    if not ptr:
        return False
    try:
        def _i64(fn, m):
            return _as_array(fn(ptr), m, np.int64).copy()

        align_off = _i64(lib.rsm_align_off, n + 1)
        suffix_off = _i64(lib.rsm_suffix_off, n + 1)
        chrom_off = _i64(lib.rsm_chrom_off, n + 1)

        def _blob(fn, size):
            return C.string_at(fn(ptr), size) if size else b""

        meta = {
            "start": _i64(lib.rsm_start, n),
            "end": _i64(lib.rsm_end, n),
            "align_code": _as_array(lib.rsm_align_code(ptr), n,
                                    np.uint8).copy(),
            "align_off": align_off, "suffix_off": suffix_off,
            "chrom_off": chrom_off,
            "align_blob": _blob(lib.rsm_align_blob, int(align_off[-1])),
            "suffix_blob": _blob(lib.rsm_suffix_blob, int(suffix_off[-1])),
            "chrom_blob": _blob(lib.rsm_chrom_blob, int(chrom_off[-1])),
        }
    finally:
        lib.raftio_free_sim_meta(ptr)
    if getattr(store, "start_pos", None) is None:
        store.start_pos = meta["start"]
        store.end_pos = meta["end"]
    store._sim_native = meta
    return True


def _as_array(ptr, n, dtype):
    """Zero-copy numpy view of C memory. Lifetime: the owning handle is
    attached to the ReadStore/OverlapTable that carries these views —
    don't let a view outlive its parent object."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    ct = {np.int64: C.c_int64, np.int32: C.c_int32,
          np.uint8: C.c_uint8}[dtype]
    arr = np.ctypeslib.as_array(C.cast(ptr, C.POINTER(ct)), shape=(int(n),))
    arr.flags.writeable = False
    return arr


def load_reads(path: str):
    from raft_tpu_torch.io.fasta import (ReadStore, parse_sim_align, parse_sim_chr,
                                   parse_sim_end_pos, parse_sim_start_pos)
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.raftio_load_fasta(path.encode())
    if not ptr:
        return None
    h = _FastaHandle(lib, ptr)
    n = lib.rf_n_reads(ptr)
    real = bool(lib.rf_real_reads(ptr))
    nb_size = lib.rf_name_blob_size(ptr)
    if nb_size:
        name_blob = C.string_at(lib.rf_name_blob(ptr), nb_size)
        names = name_blob[:-1].decode("ascii", errors="replace").split("\0") \
            if n else []
    else:
        names = []
    seq_off = _as_array(lib.rf_seq_off(ptr), n + 1, np.int64).copy()
    # zero-copy mode: seq bytes stay in the source buffer the handle
    # owns; seq_off are absolute offsets and seq_off[-1] = source size
    seq_blob = _as_array(lib.rf_seq_blob(ptr),
                         int(seq_off[-1]) if n else 0, np.uint8)
    lens = _as_array(lib.rf_lens(ptr), n, np.int64).astype(np.int32)

    store = ReadStore(names=names, seq_blob=seq_blob, seq_off=seq_off,
                      lens=lens, real_reads=real, name_to_id={})
    store._native_handle = h  # keep C store alive with the store
    if not real and not attach_sim_meta(store):
        store.start_pos = np.asarray(
            [parse_sim_start_pos(nm) for nm in names], dtype=np.int64)
        store.end_pos = np.asarray(
            [parse_sim_end_pos(nm) for nm in names], dtype=np.int64)
        store.align = [parse_sim_align(nm) for nm in names]
        store.chrom = [parse_sim_chr(nm) for nm in names]
    return store


def load_paf(path: str, store):
    from raft_tpu_torch.io.paf import OverlapTable
    lib = _get_lib()
    if lib is None:
        return None
    h = getattr(store, "_native_handle", None)
    if h is None or h._ptr is None:
        return None  # store came from the python parser; use python PAF
    ptr = lib.raftio_load_paf(path.encode(), h._ptr)
    if not ptr:
        return None
    ph = _PafHandle(lib, ptr)
    nrows = lib.rp_n_rows(ptr)
    cols = {}
    for col in ("a_id", "b_id", "a_s", "a_e", "b_s", "b_e"):
        cols[col] = _as_array(getattr(lib, f"rp_{col}")(ptr), nrows,
                              np.int32)
    tab = OverlapTable(
        a_id=cols["a_id"], b_id=cols["b_id"],
        a_start=cols["a_s"], a_end=cols["a_e"],
        b_start=cols["b_s"], b_end=cols["b_e"],
        symmetric=bool(lib.rp_symmetric(ptr)),
        n_names=int(lib.rp_n_names(ptr)))
    tab._native_handle = ph  # pin the C store to the table's lifetime
    return tab


class _PafPreHandle:
    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        self.close()

    def close(self):
        if self._ptr:
            self._lib.raftio_free_pafpre(self._ptr)
            self._ptr = None


def preparse_paf(path: str):
    """Phase 1 of the two-phase PAF load: tokenize + thread-local
    interning, with NO dependency on the FASTA parse — run it
    concurrently with ``load_reads`` and pass the handle to
    :func:`resolve_paf`. Returns None when the native layer is
    unavailable (caller uses ``load_paf``)."""
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.raftio_preparse_paf(path.encode())
    if not ptr:
        return None
    return _PafPreHandle(lib, ptr)


def resolve_paf(pre, store):
    """Phase 2: map the preparse's distinct local names onto the global
    interner (unknown names intern in file first-seen order, the
    reference's create_pileup behavior) and return the OverlapTable."""
    from raft_tpu_torch.io.paf import OverlapTable
    lib = _get_lib()
    if lib is None or pre is None or pre._ptr is None:
        return None
    h = getattr(store, "_native_handle", None)
    if h is None or h._ptr is None:
        return None
    ptr = lib.raftio_resolve_paf(pre._ptr, h._ptr)
    pre.close()
    if not ptr:
        return None
    ph = _PafHandle(lib, ptr)
    nrows = lib.rp_n_rows(ptr)
    cols = {}
    for col in ("a_id", "b_id", "a_s", "a_e", "b_s", "b_e"):
        cols[col] = _as_array(getattr(lib, f"rp_{col}")(ptr), nrows,
                              np.int32)
    tab = OverlapTable(
        a_id=cols["a_id"], b_id=cols["b_id"],
        a_start=cols["a_s"], a_end=cols["a_e"],
        b_start=cols["b_s"], b_end=cols["b_e"],
        symmetric=bool(lib.rp_symmetric(ptr)),
        n_names=int(lib.rp_n_names(ptr)))
    tab._native_handle = ph
    return tab


def emit_available() -> bool:
    return _get_lib() is not None


def group_events(table, n_reads: int, lens: np.ndarray, reso: int):
    """Read-grouped, window-binned coverage events from an OverlapTable's
    columns in one native counting-sort pass (replaces events() +
    argsort + binning on the hot path). Returns
    (ev_off int64 [n+1], w0 int32 [m], w1 int32 [m], n_unknown, n_oob,
    cov_sum) or None when the native library is unavailable; ``cov_sum``
    is Σcov (``cov_sum``'s), summed as the arrays are copied out."""
    lib = _get_lib()
    if lib is None:
        return None
    cols = [np.ascontiguousarray(c, dtype=np.int32)
            for c in (table.a_id, table.b_id, table.a_start, table.a_end,
                      table.b_start, table.b_end)]
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    ptr = lib.raftio_group_events(
        *cols, int(len(cols[0])), int(table.symmetric),
        int(n_reads), lens64, int(reso))
    if not ptr:
        return None
    try:
        m = int(lib.rge_n(ptr))
        # copies: the views must not outlive the C allocation (the result
        # arrays travel in ComputeResult past this scope)
        off = np.empty(n_reads + 1, np.int64)
        w0 = np.empty(m, np.int32)
        w1 = np.empty(m, np.int32)
        cov = int(lib.rge_export(ptr, lens64, int(reso), off, w0, w1))
        return (off, w0, w1, int(lib.rge_n_unknown(ptr)),
                int(lib.rge_n_oob(ptr)), cov)
    finally:
        lib.raftio_free_grouped(ptr)


def bgzf_compress_file(src: str, dst: str) -> bool:
    """bgzip-equivalent: BGZF-compress ``src`` into ``dst`` with the
    block-parallel deflate (RAFT_GZ_LEVEL honored). False when the
    native library is unavailable or the compression failed."""
    lib = _get_lib()
    if lib is None:
        return False
    return lib.raftio_bgzf_file(src.encode(), dst.encode()) == 0


def cov_hist(w0: np.ndarray, w1: np.ndarray, ev_off: np.ndarray,
             lens: np.ndarray, reso: int, hist_len: int = 65536):
    """Per-window coverage histogram from read-grouped window-binned
    events (one threaded native pass; the coverage array itself is never
    materialized). Returns int64 [hist_len] with the top bin clamped, or
    None when the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    w0 = np.ascontiguousarray(w0, dtype=np.int32)
    w1 = np.ascontiguousarray(w1, dtype=np.int32)
    ev_off = np.ascontiguousarray(ev_off, dtype=np.int64)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    n = len(lens64)
    hist = np.zeros(hist_len, dtype=np.int64)
    rc = lib.raftio_cov_hist(w0, w1, ev_off, lens64, int(n), int(reso),
                             hist, int(hist_len))
    return hist if rc == 0 else None


def cov_sum(w0: np.ndarray, w1: np.ndarray, ev_off: np.ndarray,
            lens: np.ndarray, reso: int) -> int | None:
    """Σcov, the coverage summed over every window of every read, from
    read-grouped window-binned events in one native pass
    (``raftio_cov_sum``: the coverage renderer's clamp semantics), or
    None when the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    return int(lib.raftio_cov_sum(
        np.ascontiguousarray(w0, dtype=np.int32),
        np.ascontiguousarray(w1, dtype=np.int32),
        np.ascontiguousarray(ev_off, dtype=np.int64), lens64,
        len(lens64), int(reso)))


class PafBins:
    """Coverage events spilled to disk, grouped by owner-read chunk.

    Produced by the native two-pass PAF binner: bin ``k`` owns reads
    ``[k*chunk, (k+1)*chunk)``; each event is ``(read_id, start,
    end_inclusive)`` as 3x int32. A-side and B-side events live in two
    spill files; B-side events are discarded at load time when the PAF
    turned out to be symmetric (reference rule ``repeat.hpp:54-58``:
    the FINAL symmetric flag gates B-side contribution).
    """

    def __init__(self, handle, lib, a_path, b_path, chunk):
        self._h = handle
        self._lib = lib
        self.a_path = a_path
        self.b_path = b_path
        self.chunk = int(chunk)
        self.n_rows = int(lib.rpb_n_rows(handle))
        self.symmetric = bool(lib.rpb_symmetric(handle))
        self.n_unknown = int(lib.rpb_n_unknown(handle))
        self.n_bins = int(lib.rpb_n_bins(handle))
        self.a_off = _as_array(lib.rpb_a_off(handle), self.n_bins + 1,
                               np.int64).copy()
        self.b_off = _as_array(lib.rpb_b_off(handle), self.n_bins + 1,
                               np.int64).copy()

    def events_for_bin(self, k: int):
        """(ev_read, ev_lo, ev_hi) for bin ``k``, global read ids."""
        parts = [(self.a_path, self.a_off)]
        if not self.symmetric:
            parts.append((self.b_path, self.b_off))
        cols = [[], [], []]
        for path, off in parts:
            n_ev = int(off[k + 1] - off[k])
            if n_ev == 0:
                continue
            flat = np.fromfile(path, dtype=np.int32, count=3 * n_ev,
                               offset=int(off[k]) * 12).reshape(-1, 3)
            cols[0].append(flat[:, 0])
            cols[1].append(flat[:, 1])
            cols[2].append(flat[:, 2])
        if not cols[0]:
            z = np.empty(0, dtype=np.int32)
            return z, z.copy(), z.copy()
        return tuple(np.ascontiguousarray(np.concatenate(c)) for c in cols)

    def close(self):
        if self._h:
            self._lib.raftio_free_pafbins(self._h)
            self._h = None
        for p in (self.a_path, self.b_path):
            try:
                os.unlink(p)
            except OSError:
                pass

    def __del__(self):
        self.close()


def bin_paf_events(path: str, store, n_reads: int, chunk: int,
                   spill_dir: str | None = None):
    """Two-pass native PAF parse spilling per-bin coverage events to disk.

    ``store`` must carry a native FASTA handle (interner). Returns a
    :class:`PafBins` or None when the native layer is unavailable.
    Unknown read names are counted (``n_unknown``) and dropped — the
    caller decides whether that is an error (strict mode).
    """
    lib = _get_lib()
    if lib is None:
        return None
    h = getattr(store, "_native_handle", None)
    if isinstance(store, dict):  # index_reads() result
        h = store.get("handle")
    if h is None or h._ptr is None:
        return None
    import tempfile
    d = spill_dir or tempfile.gettempdir()
    fd_a, a_path = tempfile.mkstemp(prefix="raft_eva_", suffix=".bin", dir=d)
    fd_b, b_path = tempfile.mkstemp(prefix="raft_evb_", suffix=".bin", dir=d)
    os.close(fd_a)
    os.close(fd_b)
    ptr = lib.raftio_paf_bin_events(path.encode(), h._ptr, n_reads, chunk,
                                    a_path.encode(), b_path.encode())
    if not ptr:
        for p in (a_path, b_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        return None
    return PafBins(ptr, lib, a_path, b_path, chunk)


def index_reads(path: str):
    """Name + byte-offset index over any supported input (plain FASTA,
    FASTQ, gz of either): first pass of the streaming pipeline. For gz
    inputs the decompressed bytes spill to a temp file the handle owns;
    ``data_path`` is where ``load_reads_range`` must read chunk byte
    ranges from (the temp file for gz, the input itself otherwise).
    Returns None when the native layer is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.raftio_index_fastx(path.encode())
    if not ptr:
        return None
    h = _FastaHandle(lib, ptr)
    n = int(lib.rf_n_reads(ptr))
    nb_size = lib.rf_name_blob_size(ptr)
    name_blob = C.string_at(lib.rf_name_blob(ptr), nb_size) if nb_size else b""
    names = (name_blob[:-1].decode("ascii", errors="replace").split("\0")
             if n else [])
    rec_off = _as_array(lib.rf_rec_off(ptr), n + 1, np.int64).copy()
    # per-read sequence lengths ride along with the index scan (free:
    # the pass walks every sequence line anyway); they feed the
    # whole-input native event grouping in the chunked pipeline
    lens = (_as_array(lib.rf_lens(ptr), n, np.int64).copy()
            if n else np.empty(0, np.int64))
    decomp = lib.rf_decomp_path(ptr)
    decomp = decomp.decode() if decomp else ""
    return {"handle": h, "n": n, "names": names, "rec_off": rec_off,
            "lens": lens,
            "real_reads": bool(lib.rf_real_reads(ptr)),
            "data_path": decomp or path,
            "fastq": bool(lib.rf_has_fastq(ptr))}


def load_reads_range(path: str, byte_lo: int, byte_hi: int,
                     fastq: bool = False):
    """Parse only the records in a byte range (streaming chunk load).
    ``fastq`` routes to the sequential fastx parser (FASTQ/mixed files);
    plain-FASTA ranges use the threaded two-pass parser."""
    from raft_tpu_torch.io.fasta import ReadStore
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.raftio_load_fastx_range(path.encode(), byte_lo, byte_hi,
                                      int(fastq))
    if not ptr:
        return None
    h = _FastaHandle(lib, ptr)
    n = int(lib.rf_n_reads(ptr))
    nb_size = lib.rf_name_blob_size(ptr)
    name_blob = C.string_at(lib.rf_name_blob(ptr), nb_size) if nb_size else b""
    names = (name_blob[:-1].decode("ascii", errors="replace").split("\0")
             if n else [])
    seq_off = _as_array(lib.rf_seq_off(ptr), n + 1, np.int64).copy()
    seq_blob = _as_array(lib.rf_seq_blob(ptr),
                         int(seq_off[-1]) if n else 0, np.uint8)
    store = ReadStore(names=names, seq_blob=seq_blob, seq_off=seq_off,
                      lens=_as_array(lib.rf_lens(ptr), n,
                                     np.int64).astype(np.int32),
                      real_reads=True, name_to_id={})
    store._native_handle = h
    return store


def _name_blob0(store):
    """NUL-terminated joined name blob + [n+1] offsets (cached).

    For natively-loaded stores this reuses the C-side layout; for
    Python-loaded stores it is built once with a single join.
    """
    blob = getattr(store, "_name_blob0", None)
    if blob is None:
        blob = ("\0".join(store.names) + "\0").encode("ascii") \
            if store.names else b""
        store._name_blob0 = blob
    arr = np.frombuffer(blob, dtype=np.uint8)
    off = np.zeros(len(store.names) + 1, dtype=np.int64)
    if len(blob):
        off[1:] = np.flatnonzero(arr == 0) + 1
    return blob, off


def _seq_ptr(lib, store):
    h = getattr(store, "_native_handle", None)
    if h is not None and h._ptr is not None:
        return lib.rf_seq_blob(h._ptr)
    blob = store.seq_blob
    if isinstance(blob, np.ndarray):
        return blob.ctypes.data
    return C.cast(C.c_char_p(blob), C.c_void_p)


def _append_base(path: str, append: bool):
    """Pre-call file length, recorded only in append mode (for
    ``_restore_on_fail``)."""
    if not append:
        return None
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _restore_on_fail(rc: int, path: str, base_size) -> bool:
    """Shared failure recovery for ALL five native emitters (each goes
    through ``emit_sharded``, raftio.cpp parallel-emit failure path):
    rc=-1 means the C++ side already restored the pre-call length;
    rc=-2 means that restore itself failed and partial shard bytes
    remain in the file — truncate here so a caller's append-mode
    fallback writer continues from clean pre-call state either way."""
    if rc != 0 and base_size is not None:
        try:
            os.truncate(path, base_size)
        except OSError:
            pass
    return rc == 0


def _emit_native(file: str, fn, *args) -> int:
    """One native emitter call for output ``file`` (``fasta``,
    ``coverage``, ``repeats``, ``bed``). When the run records spans, it
    runs inside the span ``emit.<file>.native`` with a stats array, whose
    slots (``EMIT_STATS``) become the counters ``emit.<file>.<slot>``;
    otherwise the stats pointer is NULL and the emitter reads no clock."""
    if profiling.recording() is None:
        return fn(*args, None)
    st = np.zeros(len(EMIT_STATS), dtype=np.int64)
    with profiling.span(_NATIVE_SPAN[file]):
        rc = fn(*args, st.ctypes.data)
    for slot, v in zip(EMIT_STATS, st.tolist()):
        profiling.count(f"emit.{file}.{slot}", v)
    return rc


def reserve(path: str, nbytes: int) -> int:
    """Reserve the first ``nbytes`` of the plain output file ``path``
    ahead of its writer: truncate it and allocate the range with
    ``fallocate(2)`` (``raftio_reserve``), so that the writer's calls find
    its pages allocated (``emit_frags_full(reserved=True)``). Engages only
    where ``path``, links followed, is absent or a regular file: a FIFO, a
    device or a terminal is never opened. Returns the bytes reserved, 0
    where it did not engage; raises ``OSError`` where the allocation
    failed (``ENOSPC``, ``EOPNOTSUPP``, ...), nothing left reserved."""
    lib = _get_lib()
    if lib is None or nbytes <= 0:
        return 0
    try:
        if not stat.S_ISREG(os.stat(path).st_mode):
            return 0
    except FileNotFoundError:
        pass
    rc = lib.raftio_reserve(path.encode(), nbytes)
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)
    return nbytes


def emit_frags_full(path: str, store, res, first_read_num: int = 1,
                    append: bool = False, gz: bool = False,
                    reserved: bool = False) -> bool:
    """Native fragment-FASTA writer with in-C++ header rendering.
    ``reserved``: ``reserve`` allocated the plain file's extent, so the
    writer keeps it and cuts the file to the output's size."""
    lib = _get_lib()
    if lib is None:
        return False
    with profiling.span(_PREP_SPAN["fasta"]):
        name_blob, name_off = _name_blob0(store)
        seq_off = np.ascontiguousarray(store.seq_off, dtype=np.int64)
        whole_u8 = np.ascontiguousarray(res.frag_whole, dtype=np.uint8)

        if store.real_reads:
            align_code = start = end = align_off = suffix_off = None
            align_blob = suffix_blob = b""
            ac_ptr = sp_ptr = ep_ptr = ao_ptr = so_ptr = None
        else:
            sim = _sim_blobs(store)
            align_code, align_blob, align_off, suffix_blob, suffix_off = sim
            start = np.ascontiguousarray(store.start_pos, dtype=np.int64)
            end = np.ascontiguousarray(store.end_pos, dtype=np.int64)
            ac_ptr = align_code.ctypes.data
            sp_ptr = start.ctypes.data
            ep_ptr = end.ctypes.data
            ao_ptr = align_off.ctypes.data
            so_ptr = suffix_off.ctypes.data

        base_size = _append_base(path, append)
        args = (path.encode(), _seq_ptr(lib, store), seq_off,
                res.n_frags,
                np.ascontiguousarray(res.frag_read, dtype=np.int32),
                np.ascontiguousarray(res.frag_char_start, dtype=np.int64),
                np.ascontiguousarray(res.frag_char_len, dtype=np.int64),
                whole_u8, int(store.real_reads),
                name_blob, name_off,
                ac_ptr, sp_ptr, ep_ptr,
                align_blob, ao_ptr, suffix_blob, so_ptr, first_read_num,
                int(append), int(reserved), int(gz))
    rc = _emit_native("fasta", lib.raftio_emit_frags_full, *args)
    return _restore_on_fail(rc, path, base_size)


def _sim_blobs(store):
    """Per-read align-text and header-suffix blobs for simulated mode
    (cached on the store; prefers the native one-pass parse, python loop
    only as fallback for degenerate names)."""
    cached = getattr(store, "_sim_blobs", None)
    if cached is not None:
        return cached
    if attach_sim_meta(store):
        m = store._sim_native
        out = (m["align_code"], m["align_blob"], m["align_off"],
               m["suffix_blob"], m["suffix_off"])
        store._sim_blobs = out
        return out
    store.ensure_sim_lists()
    n = store.n_reads
    align_code = np.empty(n, dtype=np.uint8)
    align_off = np.zeros(n + 1, dtype=np.int64)
    suffix_off = np.zeros(n + 1, dtype=np.int64)
    align_parts = []
    suffix_parts = []
    for i, nm in enumerate(store.names):
        al = store.align[i]
        align_code[i] = 0 if al == "forward" else 1 if al == "reverse" else 2
        align_parts.append(al)
        align_off[i + 1] = align_off[i] + len(al)
        sfx = nm[nm.rfind(","):]
        suffix_parts.append(sfx)
        suffix_off[i + 1] = suffix_off[i] + len(sfx)
    out = (align_code, "".join(align_parts).encode("ascii"), align_off,
           "".join(suffix_parts).encode("ascii"), suffix_off)
    store._sim_blobs = out
    return out


def emit_bed(path: str, store, res, append: bool = False,
             gz: bool = False) -> bool:
    """Native ``.long_repeats.bed`` writer (repeat.hpp:187-199 format).
    Real-reads mode creates/truncates the file and writes nothing,
    matching the reference's unconditional ofstream open."""
    lib = _get_lib()
    if lib is None:
        return False
    with profiling.span(_PREP_SPAN["bed"]):
        base_size = _append_base(path, append)
        if store.real_reads:
            ze = np.empty(0, dtype=np.int32)
            args = (path.encode(), ze, ze, np.zeros(1, dtype=np.int64), 0,
                    None, None, None, None, None, int(append), int(gz))
        elif not attach_sim_meta(store):
            return False
        else:
            m = store._sim_native
            start = np.ascontiguousarray(store.start_pos, dtype=np.int64)
            end = np.ascontiguousarray(store.end_pos, dtype=np.int64)
            args = (path.encode(),
                    np.ascontiguousarray(res.rep_s, dtype=np.int32),
                    np.ascontiguousarray(res.rep_e, dtype=np.int32),
                    np.ascontiguousarray(res.rep_off, dtype=np.int64),
                    res.n_reads,
                    m["align_code"].ctypes.data, start.ctypes.data,
                    end.ctypes.data,
                    C.cast(C.c_char_p(m["chrom_blob"]), C.c_void_p),
                    m["chrom_off"].ctypes.data, int(append), int(gz))
    rc = _emit_native("bed", lib.raftio_emit_bed, *args)
    return _restore_on_fail(rc, path, base_size)


def emit_coverage(path: str, cov_flat: np.ndarray, cov_off: np.ndarray,
                  n_reads: int, reso: int,
                  first_read_index: int = 0, append: bool = False,
                  gz: bool = False) -> bool:
    lib = _get_lib()
    if lib is None:
        return False
    with profiling.span(_PREP_SPAN["coverage"]):
        base_size = _append_base(path, append)
        args = (path.encode(),
                np.ascontiguousarray(cov_flat, dtype=np.int32),
                np.ascontiguousarray(cov_off, dtype=np.int64), n_reads,
                reso, first_read_index, int(append), int(gz))
    rc = _emit_native("coverage", lib.raftio_emit_coverage, *args)
    return _restore_on_fail(rc, path, base_size)


def emit_coverage_events(path: str, w0: np.ndarray, w1: np.ndarray,
                         ev_off: np.ndarray, cov_off: np.ndarray,
                         n_reads: int, reso: int,
                         first_read_index: int = 0, append: bool = False,
                         gz: bool = False) -> bool:
    """coverage.txt straight from window-binned events (no materialized
    coverage array)."""
    lib = _get_lib()
    if lib is None:
        return False
    with profiling.span(_PREP_SPAN["coverage"]):
        base_size = _append_base(path, append)
        args = (path.encode(), np.ascontiguousarray(w0, dtype=np.int32),
                np.ascontiguousarray(w1, dtype=np.int32),
                np.ascontiguousarray(ev_off, dtype=np.int64),
                np.ascontiguousarray(cov_off, dtype=np.int64), n_reads,
                reso, first_read_index, int(append), int(gz))
    rc = _emit_native("coverage", lib.raftio_emit_coverage_events, *args)
    return _restore_on_fail(rc, path, base_size)


def emit_repeats(path: str, rep_s: np.ndarray, rep_e: np.ndarray,
                 rep_off: np.ndarray, n_reads: int,
                 first_read_index: int = 0, append: bool = False,
                 gz: bool = False) -> bool:
    lib = _get_lib()
    if lib is None:
        return False
    with profiling.span(_PREP_SPAN["repeats"]):
        base_size = _append_base(path, append)
        args = (path.encode(), np.ascontiguousarray(rep_s, dtype=np.int32),
                np.ascontiguousarray(rep_e, dtype=np.int32),
                np.ascontiguousarray(rep_off, dtype=np.int64), n_reads,
                first_read_index, int(append), int(gz))
    rc = _emit_native("repeats", lib.raftio_emit_repeats, *args)
    return _restore_on_fail(rc, path, base_size)
