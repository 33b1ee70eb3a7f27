"""PAF overlap loading into columnar int32 arrays.

raft_tpu_torch's copy of ``raft_tpu/io/paf.py``, unchanged apart from
its import paths and ``GroupedEvents``: ``events_grouped``' triple also
carries the native grouping's Σcov.

Equivalent of the reference PAF reader + pileup builder
(``/root/reference/paf.hpp:50-100``, ``chop.hpp:133-191``), redesigned:
instead of per-row heap ``Overlap`` objects pushed into per-read vectors,
we build six int32 columns (a_id, b_id, a_start, a_end, b_start, b_end).
The device pipeline turns these into coverage *events* with plain numpy
vector ops — no pileup pointer structure is ever materialized.

Reference semantics preserved exactly:

* rows with fewer than 10 tab-separated columns are skipped
  (``paf_parse``: ``if (t < 10) return -1`` at paf.hpp:84-86);
* names are interned continuing the FASTA-order map (``chop.hpp:162-163``);
* symmetric-PAF auto-detection: scanning in file order, if any later row is
  the exact mirror of row 0 (ids and both coordinate pairs swapped,
  ``chop.hpp:175-184``), the whole run flips to symmetric mode, in which
  B-side intervals never contribute coverage (``repeat.hpp:54-58``);
* strand / match-length / block-length columns are parsed but unused
  (the reference ignores strand entirely — PAF coordinates are already on
  each read's forward strand).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raft_tpu_torch.io.fasta import ReadStore, _open_maybe_gz


@dataclasses.dataclass
class OverlapTable:
    """Columnar overlap table (SoA replacement for ``Overlap`` objects)."""

    a_id: np.ndarray     # int32 [n_rows]
    b_id: np.ndarray     # int32
    a_start: np.ndarray  # int32
    a_end: np.ndarray    # int32
    b_start: np.ndarray  # int32
    b_end: np.ndarray    # int32
    symmetric: bool      # final symmetric_overlaps flag
    n_names: int         # total interned names (>= n_reads if PAF adds new)

    @property
    def n_rows(self) -> int:
        return int(self.a_id.shape[0])

    def events(self, n_reads: int, strict: bool = True):
        """Build coverage events ``(read_id, start, end_inclusive)``.

        A-side: every row contributes (a_id, a_start, a_end-1)
        (``repeat.hpp:50-53``). B-side: only when not symmetric and
        a_id != b_id (``chop.hpp:166-169`` + ``repeat.hpp:54-58``).

        Rows naming reads absent from the FASTA are undefined behavior in
        the reference (out-of-bounds pileup write, ``chop.hpp:165`` vs
        sizing at ``chop.hpp:361-364``). Here: error if ``strict``,
        else dropped.
        """
        a_id, b_id = self.a_id, self.b_id
        known_a = a_id < n_reads
        known_b = b_id < n_reads
        if strict and not (known_a.all() and known_b.all()):
            bad = int((~known_a).sum() + (~known_b).sum())
            raise ValueError(
                f"PAF names {bad} read(s) absent from the input FASTA "
                "(undefined behavior in reference RAFT); "
                "pass strict=False to drop them")
        ev_read = [a_id[known_a]]
        ev_lo = [self.a_start[known_a]]
        ev_hi = [(self.a_end[known_a] - 1)]
        if not self.symmetric:
            bmask = known_b & (a_id != b_id)
            ev_read.append(b_id[bmask])
            ev_lo.append(self.b_start[bmask])
            ev_hi.append(self.b_end[bmask] - 1)
        return (np.concatenate(ev_read).astype(np.int32),
                np.concatenate(ev_lo).astype(np.int32),
                np.concatenate(ev_hi).astype(np.int32))

    def events_grouped(self, n_reads: int, lens: np.ndarray, reso: int,
                       strict: bool = True):
        """Read-grouped window-binned events via the native counting-sort
        pass: (ev_off [n+1] int64, w0 [m] int32, w1 [m] int32), as a
        ``GroupedEvents`` that also carries the pass's Σcov. Replaces
        events() + argsort + binning on the hot path — same event rules,
        same strict-mode errors. Returns None when the native library is
        unavailable (callers fall back to the sort path)."""
        try:
            from raft_tpu_torch.io import native
            g = native.group_events(self, n_reads, lens, reso)
        except Exception:
            return None
        if g is None:
            return None
        off, w0, w1, n_unknown, n_oob, cov = g
        if strict and n_unknown:
            raise ValueError(
                f"PAF names {n_unknown} read(s) absent from the input "
                "FASTA (undefined behavior in reference RAFT); "
                "pass strict=False to drop them")
        if strict and n_oob:
            raise ValueError(
                "overlap interval exceeds read bounds (reference RAFT has "
                "an unchecked buffer overrun here, repeat.hpp:69-73); "
                "fix the PAF or run with --no-strict")
        return GroupedEvents(off, w0, w1, cov)


class GroupedEvents(tuple):
    """``(ev_off, w0, w1)`` of ``OverlapTable.events_grouped``, with
    ``cov_sum``: Σcov, the coverage summed over every window, from the
    native grouping (the port's addition; the triple is ``raft_tpu``'s)."""

    def __new__(cls, ev_off, w0, w1, cov_sum: int):
        self = super().__new__(cls, (ev_off, w0, w1))
        self.cov_sum = cov_sum
        return self


def load_paf(path: str, store: ReadStore,
             use_native: bool | None = None) -> OverlapTable:
    """Parse a (possibly gzipped) PAF file against an already-loaded read
    store, continuing its name-interning map. Reference:
    ``create_pileup`` (chop.hpp:133-191)."""
    if use_native is not False:
        try:
            from raft_tpu_torch.io import native
            tab = native.load_paf(path, store)
            if tab is not None:
                return tab
        except Exception:
            if use_native:
                raise
    return _load_paf_py(path, store)


def _load_paf_py(path: str, store: ReadStore) -> OverlapTable:
    name_to_id = store.name_to_id
    a_id: list[int] = []
    b_id: list[int] = []
    a_s: list[int] = []
    a_e: list[int] = []
    b_s: list[int] = []
    b_e: list[int] = []

    symmetric = False
    check_sym = True
    first = None  # (a_id, b_id, a_s, a_e, b_s, b_e) of row 0

    with _open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            parts = line.split(b"\t")
            if len(parts) < 10:
                continue  # paf_parse returns -1 → paf_read retries next line
            qn = parts[0].decode("ascii", errors="replace")
            tn = parts[5].decode("ascii", errors="replace")
            qs = int(parts[2]); qe = int(parts[3])
            ts = int(parts[7]); te = int(parts[8])

            ai = name_to_id.setdefault(qn, len(name_to_id))
            bi = name_to_id.setdefault(tn, len(name_to_id))

            row = (ai, bi, qs, qe, ts, te)
            if first is None:
                first = row
            elif check_sym and not symmetric:
                fa, fb, fas, fae, fbs, fbe = first
                if (fa == bi and fb == ai and fas == ts and fae == te
                        and fbs == qs and fbe == qe):
                    symmetric = True
                    check_sym = False

            a_id.append(ai); b_id.append(bi)
            a_s.append(qs); a_e.append(qe)
            b_s.append(ts); b_e.append(te)

    return OverlapTable(
        a_id=np.asarray(a_id, dtype=np.int32),
        b_id=np.asarray(b_id, dtype=np.int32),
        a_start=np.asarray(a_s, dtype=np.int32),
        a_end=np.asarray(a_e, dtype=np.int32),
        b_start=np.asarray(b_s, dtype=np.int32),
        b_end=np.asarray(b_e, dtype=np.int32),
        symmetric=symmetric,
        n_names=len(name_to_id),
    )
