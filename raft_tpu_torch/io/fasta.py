"""FASTA/FASTQ read loading into a columnar (structure-of-arrays) store.

raft_tpu_torch's copy of ``raft_tpu/io/fasta.py``, unchanged apart from
its import paths.

Equivalent of the reference's ``loadFASTA`` + ``Read`` + name interning
(``/root/reference/chop.hpp:73-131``, ``read.hpp:10-32``), redesigned as a
columnar store: one contiguous base blob plus int64 offsets, so downstream
fragment emission is pure pointer arithmetic and the device pipeline gets
dense integer arrays instead of per-read heap objects.

Parsing semantics follow the reference's kseq exactly
(``/root/reference/kseq.h:240-298``):

* records start at ``>`` (FASTA) or ``@`` (FASTQ);
* the name is the first whitespace-delimited token after the marker,
  the rest of the line is a comment and is dropped;
* sequence lines up to the next record marker (or ``+``) are concatenated
  verbatim; CRLF line endings are stripped;
* FASTQ quality lines are skipped (length-matched against the sequence).

Simulated-read detection mirrors ``chop.hpp:99-105``: the regex gate is
applied to the FIRST record's name only, and flips the whole run into
"simulated" mode, in which per-read genome coordinates are parsed out of
every read name (``chop.hpp:25-70``).
"""

from __future__ import annotations

import dataclasses
import gzip
import re

import numpy as np

# Reference regex (chop.hpp:101), anchored both ends like std::regex_match.
_SIM_RE = re.compile(r"read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,length=[0-9]+,(.*)")

_ATOI_RE = re.compile(r"[+-]?[0-9]*")


def _atoi(s: str) -> int:
    """C ``atoi``: parse the leading integer, 0 if none."""
    m = _ATOI_RE.match(s)
    tok = m.group(0) if m else ""
    try:
        return int(tok)
    except ValueError:
        return 0


def parse_sim_start_pos(name: str) -> int:
    """``get_start_pos_from_string`` (chop.hpp:25-35): int after the first
    ``=`` that follows the first ``,``, up to the next ``-``."""
    c = name.find(",")
    e = name.find("=", c)
    return _atoi(name[e + 1:])


def parse_sim_end_pos(name: str) -> int:
    """``get_end_pos_from_string`` (chop.hpp:37-47): int after the first
    ``-`` in the whole name, up to the next ``,``."""
    d = name.find("-")
    return _atoi(name[d + 1:])


def parse_sim_align(name: str) -> str:
    """``get_alignment_from_string`` (chop.hpp:49-59): text between the
    first and second ``,``."""
    c0 = name.find(",") + 1
    c1 = name.find(",", c0)
    return name[c0:c1]


def parse_sim_chr(name: str) -> str:
    """``get_chr_from_string`` (chop.hpp:61-70): text after the LAST ``,``."""
    return name[name.rfind(",") + 1:]


@dataclasses.dataclass
class ReadStore:
    """Columnar read store (SoA replacement for ``std::vector<Read*>``).

    ``seq_blob`` holds every base of every read contiguously;
    read ``i`` spans ``seq_blob[seq_off[i]:seq_off[i+1]]``.
    Read ids equal load order, matching the reference's first-seen-order
    interning (``chop.hpp:73-85`` — reads are interned before any PAF name).
    """

    names: list[str]
    seq_blob: bytes
    seq_off: np.ndarray          # int64 [n+1]
    lens: np.ndarray             # int32 [n]
    real_reads: bool
    # Simulated-read metadata (only meaningful when not real_reads):
    start_pos: np.ndarray | None = None   # int64 [n]
    end_pos: np.ndarray | None = None     # int64 [n]
    align: list[str] | None = None        # "forward"/"reverse"/other
    chrom: list[str] | None = None
    name_to_id: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def n_reads(self) -> int:
        return len(self.names)

    def seq(self, i: int) -> bytes:
        # read i spans lens[i] bytes from seq_off[i]; under the native
        # zero-copy layout seq_off[i+1] is the NEXT record's start in the
        # source file (headers between), so never slice off[i]:off[i+1]
        s = int(self.seq_off[i])
        return self.seq_blob[s:s + int(self.lens[i])]

    def ensure_sim_lists(self) -> None:
        """Materialize the per-read ``align``/``chrom`` python lists from
        the names. The native load path leaves them None (it parses sim
        metadata in C and caches blob tables instead); only python
        fallback emitters need the list form."""
        if self.real_reads or self.align is not None:
            return
        self.align = [parse_sim_align(nm) for nm in self.names]
        self.chrom = [parse_sim_chr(nm) for nm in self.names]


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fastx(path: str):
    """Yield ``(name, seq_bytes)`` records with kseq-equivalent parsing."""
    with _open_maybe_gz(path) as f:
        name = None
        chunks: list[bytes] = []
        in_fastq = False
        qual_len = 0
        seq_len = 0
        skipping_qual = False
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if skipping_qual:
                qual_len += len(line)
                if qual_len >= seq_len:
                    skipping_qual = False
                continue
            if line.startswith(b">") or line.startswith(b"@"):
                if name is not None:
                    yield name, b"".join(chunks)
                header = line[1:].decode("ascii", errors="replace")
                # kseq: name = first whitespace-delimited token
                name = header.split()[0] if header.split() else ""
                chunks = []
                in_fastq = line.startswith(b"@")
            elif line.startswith(b"+") and in_fastq:
                seq_len = sum(len(c) for c in chunks)
                qual_len = 0
                skipping_qual = seq_len > 0
                if name is not None and not skipping_qual:
                    yield name, b""
                    name = None
            elif line:
                if name is not None:
                    chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def load_reads(path: str, use_native: bool | None = None) -> ReadStore:
    """Load all reads. Tries the native C++ parser first (if built), falls
    back to the pure-Python path. Reference: ``loadFASTA`` (chop.hpp:88-131).
    """
    if use_native is not False:
        try:
            from raft_tpu_torch.io import native
            st = native.load_reads(path)
            if st is not None:
                return st
        except Exception:
            if use_native:
                raise
    return _load_reads_py(path)


def _load_reads_py(path: str) -> ReadStore:
    names: list[str] = []
    blobs: list[bytes] = []
    offs = [0]
    real_reads = True
    name_to_id: dict[str, int] = {}

    for num, (name, seq) in enumerate(iter_fastx(path)):
        if num == 0 and _SIM_RE.fullmatch(name):
            real_reads = False
        if name not in name_to_id:
            name_to_id[name] = len(name_to_id)
        names.append(name)
        blobs.append(seq)
        offs.append(offs[-1] + len(seq))

    seq_blob = b"".join(blobs)
    n = len(names)
    seq_off = np.asarray(offs, dtype=np.int64)
    lens = np.diff(seq_off).astype(np.int32)

    store = ReadStore(
        names=names, seq_blob=seq_blob, seq_off=seq_off, lens=lens,
        real_reads=real_reads, name_to_id=name_to_id)

    if not real_reads:
        store.start_pos = np.asarray(
            [parse_sim_start_pos(nm) for nm in names], dtype=np.int64)
        store.end_pos = np.asarray(
            [parse_sim_end_pos(nm) for nm in names], dtype=np.int64)
        store.align = [parse_sim_align(nm) for nm in names]
        store.chrom = [parse_sim_chr(nm) for nm in names]
    return store
