"""Columnar compute result: the contract between engines and emitters.

raft_tpu_torch's copy of ``raft_tpu/result.py``, unchanged apart from
its import paths.

Everything is flat arrays in read-id order — no per-read Python objects —
so emission scales to millions of reads/fragments without interpreter
loops. Derivation notes (all header fields reduce to char_start/char_len):

* real-reads fragment header ``pos_on_original_read={a}-{b}`` has
  ``a = star - ov = char_start`` and ``b = last = char_start + char_len``
  (``chop.hpp:314-316``);
* simulated forward positions are ``start_pos + char_start`` /
  ``start_pos + char_start + char_len``; reverse positions are
  ``end_pos - char_start - char_len`` / ``end_pos - char_start``
  (``chop.hpp:295-309``), and the ``length`` field is ``char_len``;
* the emit-whole branch (``chop.hpp:250-267``) differs only in simulated
  mode (uses the read's own start/end coordinates) — flagged per fragment.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ComputeResult:
    n_reads: int
    # coverage, read-id order. Either materialized (cov_flat) or held as
    # window-binned events (cov_ev_*, read-major) from which the native
    # coverage emitter renders text directly — the fast path never builds
    # the O(total windows) int32 array at all. cov_off always holds the
    # per-read window offsets (cumsum of ceil(len/reso)).
    cov_flat: np.ndarray | None  # int32 [sum n_windows] or None
    cov_off: np.ndarray    # int64 [n+1]
    # repeat intervals (clamped, flank-expanded), read-id order
    rep_s: np.ndarray      # int32 [sum rep_n]
    rep_e: np.ndarray      # int32
    rep_off: np.ndarray    # int64 [n+1]
    # fragments, read-id order (global fragment numbering = index + 1)
    frag_read: np.ndarray        # int32 [n_frags]
    frag_char_start: np.ndarray  # int64
    frag_char_len: np.ndarray    # int64
    frag_whole: np.ndarray       # bool
    # global stats (reference: repeat.hpp:93-97, 173-178)
    total_coverage: int = 0
    total_windows: int = 0
    total_repeat_length: int = 0
    total_read_length: int = 0
    # event-backed coverage (cov_flat is None): window-binned inclusive
    # intervals sorted by read id with per-read offsets
    cov_ev_w0: np.ndarray | None = None  # int32 [n_events]
    cov_ev_w1: np.ndarray | None = None  # int32 [n_events]
    cov_ev_off: np.ndarray | None = None  # int64 [n+1]

    @property
    def n_frags(self) -> int:
        return int(self.frag_read.shape[0])

    def ensure_cov(self) -> np.ndarray:
        """Materialize cov_flat from the coverage events (lazy path for
        tests and python fallbacks; the native emitter renders straight
        from the events and never calls this)."""
        if self.cov_flat is None:
            self.cov_flat = _cov_from_events(
                self.cov_ev_w0, self.cov_ev_w1, self.cov_ev_off,
                self.cov_off, self.n_reads)
        return self.cov_flat

    def cov(self, i: int) -> np.ndarray:
        if self.cov_flat is None:
            nw = int(self.cov_off[i + 1] - self.cov_off[i])
            a, b = int(self.cov_ev_off[i]), int(self.cov_ev_off[i + 1])
            return _cov_one(self.cov_ev_w0[a:b], self.cov_ev_w1[a:b], nw)
        return self.cov_flat[self.cov_off[i]:self.cov_off[i + 1]]

    def repeats(self, i: int) -> list[tuple[int, int]]:
        s, e = self.rep_off[i], self.rep_off[i + 1]
        return list(zip(self.rep_s[s:e].tolist(), self.rep_e[s:e].tolist()))


def _cov_one(w0: np.ndarray, w1: np.ndarray, nw: int) -> np.ndarray:
    """One read's coverage from its window-binned inclusive events
    (diff + cumsum; end clamped to the row like the device's carry)."""
    d = np.zeros(nw + 1, dtype=np.int32)
    sel = (w1 >= w0) & (w0 >= 0) & (w0 < nw)
    np.add.at(d, w0[sel], 1)
    np.add.at(d, np.minimum(w1[sel].astype(np.int64) + 1, nw), -1)
    return np.cumsum(d[:nw], dtype=np.int32)


def _cov_from_events(w0, w1, ev_off, cov_off, n_reads) -> np.ndarray:
    """All reads' coverage from read-major events, vectorized.

    Uses one sentinel slot per read (flat index cov_off[r] + r + w) so a
    -1 falling one past a read's last window lands in the sentinel; the
    global cumsum then carries exactly zero across read boundaries
    because every +1 is cancelled within its read's extended region."""
    n_ev = len(w0) if w0 is not None else 0
    total = int(cov_off[-1])
    ext = np.zeros(total + n_reads + 1, dtype=np.int32)
    if n_ev:
        nw = np.diff(cov_off)
        r = np.searchsorted(ev_off, np.arange(n_ev), side="right") - 1
        base = cov_off[r] + r
        a = w0.astype(np.int64)
        b = w1.astype(np.int64)
        nwr = nw[r]
        sel = (b >= a) & (a >= 0) & (a < nwr)
        np.add.at(ext, base[sel] + a[sel], 1)
        np.add.at(ext, base[sel] + np.minimum(b[sel] + 1, nwr[sel]), -1)
    cov_ext = np.cumsum(ext[:total + n_reads], dtype=np.int32)
    # drop the per-read sentinel slots
    keep = np.ones(total + n_reads, dtype=bool)
    keep[cov_off[1:] + np.arange(n_reads)] = False
    return cov_ext[keep]


def from_per_read_lists(n_reads, coverages, repeats_per_read,
                        frags_per_read, stats) -> ComputeResult:
    """Adapter from the oracle engine's per-read lists (test/fallback path:
    interpreter loops are fine here)."""
    cov_off = np.zeros(n_reads + 1, dtype=np.int64)
    for i, c in enumerate(coverages):
        cov_off[i + 1] = cov_off[i] + len(c)
    cov_flat = (np.concatenate(coverages).astype(np.int32)
                if n_reads else np.empty(0, np.int32))

    rep_off = np.zeros(n_reads + 1, dtype=np.int64)
    for i, r in enumerate(repeats_per_read):
        rep_off[i + 1] = rep_off[i] + len(r)
    tot = int(rep_off[-1])
    rep_s = np.empty(tot, dtype=np.int32)
    rep_e = np.empty(tot, dtype=np.int32)
    k = 0
    for reps in repeats_per_read:
        for (s, e) in reps:
            rep_s[k] = s
            rep_e[k] = e
            k += 1

    frag_read, fcs, fcl, fwh = [], [], [], []
    for i, frags in enumerate(frags_per_read):
        for f in frags:
            frag_read.append(i)
            fcs.append(f.char_start)
            fcl.append(f.char_len)
            fwh.append(f.whole)

    return ComputeResult(
        n_reads=n_reads,
        cov_flat=cov_flat, cov_off=cov_off,
        rep_s=rep_s, rep_e=rep_e, rep_off=rep_off,
        frag_read=np.asarray(frag_read, dtype=np.int32),
        frag_char_start=np.asarray(fcs, dtype=np.int64),
        frag_char_len=np.asarray(fcl, dtype=np.int64),
        frag_whole=np.asarray(fwh, dtype=bool),
        total_coverage=stats.total_coverage,
        total_windows=stats.total_windows,
        total_repeat_length=stats.total_repeat_length,
        total_read_length=stats.total_read_length,
    )
