"""Byte-exact output emission for the four RAFT output files.

raft_tpu_torch's copy of ``raft_tpu/emit.py``, unchanged apart from
its import paths and the fragment FASTA's ``Reservation``.

Formats (verified against the reference):

* ``<prefix>.reads.fasta``  — ``chop.hpp:250-321``: one header line + the
  whole fragment sequence on ONE line (no wrapping). Global fragment
  numbering ``read=1,2,3,...`` is a strict sequential counter across all
  reads in id order (``chop.hpp:195,319``).
* ``<prefix>.coverage.txt`` — ``repeat.hpp:105-108``:
  ``read {i} `` then ``{winStart},{cov} `` per window, newline.
* ``<prefix>.long_repeats.txt`` — ``repeat.hpp:182-185``:
  ``read {i}, `` then ``{s},{e}    `` (four trailing spaces) per interval.
* ``<prefix>.long_repeats.bed`` — ``repeat.hpp:187-199``: simulated mode
  only; genome coordinates with the reverse-strand flip.

All writers consume the flat-array ``ComputeResult`` (read-id order) and
prefer the native C++ emitters (header rendering included); pure-Python
fallbacks keep identical bytes.
"""

from __future__ import annotations

import errno
import os
import sys

from raft_tpu_torch import profiling
from raft_tpu_torch.io.fasta import ReadStore
from raft_tpu_torch.result import ComputeResult
from raft_tpu_torch.params import AlgoParams


def _open_text(path: str, append: bool, gz: bool):
    """Python-fallback writer handle; gz appends a new gzip member
    (decompressed bytes identical to the plain file)."""
    mode = "a" if append else "w"
    if gz:
        import gzip
        return gzip.open(path, mode + "t")
    return open(path, mode, buffering=1 << 20)


def write_coverage(path: str, reso: int, res: ComputeResult,
                   use_native: bool = True,
                   first_read_index: int = 0,
                   append: bool = False, gz: bool = False) -> None:
    from raft_tpu_torch.io import native
    if use_native and res.cov_flat is None and res.cov_ev_w0 is not None:
        if native.emit_coverage_events(
                path, res.cov_ev_w0, res.cov_ev_w1, res.cov_ev_off,
                res.cov_off, res.n_reads, reso, first_read_index, append,
                gz):
            return
    if use_native and native.emit_coverage(path, res.ensure_cov(),
                                           res.cov_off, res.n_reads, reso,
                                           first_read_index, append, gz):
        return
    with _open_text(path, append, gz) as f:
        for i in range(res.n_reads):
            cov = res.cov(i)
            parts = [f"read {first_read_index + i} "]
            parts += [f"{j * reso},{int(c)} " for j, c in enumerate(cov)]
            parts.append("\n")
            f.write("".join(parts))


def write_long_repeats(path: str, res: ComputeResult,
                       use_native: bool = True,
                       first_read_index: int = 0,
                       append: bool = False, gz: bool = False) -> None:
    from raft_tpu_torch.io import native
    if use_native and native.emit_repeats(path, res.rep_s, res.rep_e,
                                          res.rep_off, res.n_reads,
                                          first_read_index, append, gz):
        return
    with _open_text(path, append, gz) as f:
        for i in range(res.n_reads):
            parts = [f"read {first_read_index + i}, "]
            parts += [f"{s},{e}    " for (s, e) in res.repeats(i)]
            parts.append("\n")
            f.write("".join(parts))


def write_long_repeats_bed(path: str, store: ReadStore,
                           res: ComputeResult,
                           use_native: bool = True,
                           append: bool = False, gz: bool = False) -> None:
    """Simulated mode only: genome-coordinate BED with reverse-strand flip
    (``repeat.hpp:187-199``). In real-reads mode the reference still
    creates the file but never writes to it."""
    from raft_tpu_torch.io import native
    if use_native and native.emit_bed(path, store, res, append, gz):
        return
    store.ensure_sim_lists()
    with _open_text(path, append, gz) as f:
        if store.real_reads:
            return
        for i in range(res.n_reads):
            lo, hi = int(res.rep_off[i]), int(res.rep_off[i + 1])
            if lo == hi:
                continue
            al = store.align[i]
            ch = store.chrom[i]
            sp = int(store.start_pos[i])
            ep = int(store.end_pos[i])
            for k in range(lo, hi):
                s, e = int(res.rep_s[k]), int(res.rep_e[k])
                if al == "forward":
                    f.write(f"{ch}\t{sp + s}\t{sp + e}\n")
                elif al == "reverse":
                    f.write(f"{ch}\t{ep - e}\t{ep - s}\n")


def fragment_header(read_num: int, store: ReadStore, i: int,
                    char_start: int, char_len: int,
                    whole: bool) -> str | None:
    """Header for one fragment. All fields derive from char_start/char_len
    (see result.py derivation notes). Returns None when the reference
    writes no header (simulated mode, alignment neither forward nor
    reverse, non-whole branch: chop.hpp:293-311)."""
    name = store.names[i]
    if store.real_reads:
        return (f">read={read_num},{name},pos_on_original_read="
                f"{char_start}-{char_start + char_len}")
    al = store.align[i]
    sp = int(store.start_pos[i])
    ep = int(store.end_pos[i])
    suffix = name[name.rfind(","):]  # includes the comma (chop.hpp:257)
    if whole:
        return (f">read={read_num},{al},position={sp}-{ep}"
                f",length={char_len}{suffix}")
    if al == "forward":
        return (f">read={read_num},{al},position="
                f"{sp + char_start}-{sp + char_start + char_len}"
                f",length={char_len}{suffix}")
    if al == "reverse":
        return (f">read={read_num},{al},position="
                f"{ep - char_start - char_len}-{ep - char_start}"
                f",length={char_len}{suffix}")
    return None


def _reserve(path: str, nbytes: int, verbose: bool) -> int:
    from raft_tpu_torch.io import native
    try:
        return native.reserve(path, nbytes)
    except OSError as e:
        # a full disk shows now, while the run computes; the writer meets
        # it again and fails as it would have
        if verbose and e.errno in (errno.ENOSPC, errno.EDQUOT):
            print(f"WARNING, cannot reserve {nbytes} bytes for {path}: "
                  f"{e.strerror}", file=sys.stderr)
        return 0


class Reservation:
    """A plain output file's extent, reserved on a pool thread (span
    ``emit.reserve``, attribute ``early``; ``native.reserve``) while the
    run parses and computes, so that its writer's calls only copy.
    ``nbytes`` need only be close: the writer cuts the file to the
    output's size, and writes past the reserved range allocate as they
    would have. The writer takes it (``claim``: the bytes reserved, 0
    where nothing was) and from then on leaves no reserved byte behind,
    written or failed; ``release``, in the run's cleanup, undoes a
    reservation no writer took, so a run that fails before its writer
    leaves no file of NULs: a file the reservation created is removed,
    one it found is cut to 0 bytes."""

    def __init__(self, pool, path: str, nbytes: int, verbose: bool,
                 early: bool = False):
        self.path = path
        self.claimed = False
        self.created = not os.path.lexists(path)
        self._fut = pool.submit(
            profiling.bind(_reserve, "emit.reserve", early=int(early)),
            path, nbytes, verbose)

    def claim(self) -> int:
        self.claimed = True
        return self._fut.result()

    def release(self) -> None:
        if self.claimed:
            return
        reserved = self._fut.result()
        if self.created:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        elif reserved:
            os.truncate(self.path, 0)


def write_fragments_fasta(path: str, store: ReadStore, params: AlgoParams,
                          res: ComputeResult,
                          use_native: bool = True,
                          first_read_num: int = 1,
                          append: bool = False, gz: bool = False,
                          reservation: Reservation | None = None) -> int:
    """Emit the fragmented FASTA; returns the number of fragments.
    ``reservation`` (a plain whole-file output) is waited for first
    (span ``emit.fasta.reserve_wait``, counter
    ``emit.fasta.reserved_bytes``)."""
    from raft_tpu_torch.io import native
    reserved = 0
    if reservation is not None:
        with profiling.span("emit.fasta.reserve_wait"):
            reserved = reservation.claim()
        profiling.count("emit.fasta.reserved_bytes", reserved)
    if use_native and native.emit_frags_full(path, store, res,
                                             first_read_num, append, gz,
                                             reserved=reserved > 0):
        return res.n_frags

    store.ensure_sim_lists()  # python header rendering needs the lists
    blob = store.seq_blob
    off = store.seq_off
    if gz:
        import gzip
        _opener = lambda: gzip.open(path, "ab" if append else "wb")
    else:
        _opener = lambda: open(path, "ab" if append else "wb",
                               buffering=1 << 22)
    with _opener() as f:
        for j in range(res.n_frags):
            i = int(res.frag_read[j])
            cs = int(res.frag_char_start[j])
            cl = int(res.frag_char_len[j])
            hdr = fragment_header(first_read_num + j, store, i, cs, cl,
                                  bool(res.frag_whole[j]))
            if hdr is not None:
                f.write(hdr.encode("ascii"))
                f.write(b"\n")
            s = int(off[i]) + cs
            f.write(blob[s:s + cl])
            f.write(b"\n")
    return res.n_frags
