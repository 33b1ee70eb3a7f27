"""The benchmark's plain reference: RAFT's four output files worked out
again from the generated inputs, with NumPy only. It imports nothing of
the program.

Semantics (reference RAFT's ``repeat.hpp`` and ``chop.hpp``, as
``SURVEY.md`` C9-C13 describes them):

* events: every PAF row adds (query, start, end - 1); unless the PAF is
  symmetric (a later row mirrors row 0) a row between two different reads
  also adds (target, start, end - 1);
* coverage: an event covers windows start // r .. end_incl // r;
* repeats: a maximal run of windows with coverage >= int(e * m) whose
  length (run windows x r) is >= p, expanded by f and clamped to the read;
* fragments (``chop.hpp:209-321``): markers at 0, p, 2p, ... and the
  read's end; an interior marker inside one of the read's repeats (ends
  included) is deleted; with div = l // p, fragment k spans the surviving
  markers k div .. (k + 1) div, the last runs to the read's end, and every
  fragment after the first starts v bp early (a read keeping at most
  div + 1 markers is one fragment, the read whole);
* real-read names, so ``.long_repeats.bed`` stays empty.

``cov_saturate`` is the control's lower precision: coverage held in int8
(saturating at 127), everything downstream computed from it.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np

from perfbench.gen import ascii_ints

SUFFIXES = (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
            ".long_repeats.bed")


@dataclasses.dataclass(frozen=True)
class Flags:
    reso: int
    est_cov: int
    cov_mul: float
    repeat_length: int
    interval_length: int
    read_length: int
    overlap_length: int
    flanking_length: int

    @classmethod
    def from_config(cls, raft_flags: dict, est_cov: int) -> "Flags":
        f = raft_flags
        return cls(reso=f["r"], est_cov=est_cov, cov_mul=f["m"],
                   repeat_length=f["p"], interval_length=f["p"],
                   read_length=f["l"], overlap_length=f["v"],
                   flanking_length=f["f"])

    @property
    def high_cov(self) -> int:
        return int(self.est_cov * self.cov_mul)


@dataclasses.dataclass
class Work:
    """What the reference found, for the roofline's work count."""
    n_reads: int
    n_events: int
    n_windows: int
    n_repeats: int
    n_fragments: int


def is_symmetric(paf: dict) -> bool:
    """A later row is the exact mirror of row 0."""
    if len(paf["a_id"]) < 2:
        return False
    a, b = paf["a_id"], paf["b_id"]
    m = ((a[1:] == b[0]) & (b[1:] == a[0])
         & (paf["a_start"][1:] == paf["b_start"][0])
         & (paf["a_end"][1:] == paf["b_end"][0])
         & (paf["b_start"][1:] == paf["a_start"][0])
         & (paf["b_end"][1:] == paf["a_end"][0]))
    return bool(m.any())


def events(paf: dict):
    a_id, b_id = paf["a_id"], paf["b_id"]
    ev_r, ev_lo, ev_hi = [a_id], [paf["a_start"]], [paf["a_end"] - 1]
    if not is_symmetric(paf):
        m = a_id != b_id
        ev_r.append(b_id[m])
        ev_lo.append(paf["b_start"][m])
        ev_hi.append(paf["b_end"][m] - 1)
    return (np.concatenate(ev_r), np.concatenate(ev_lo),
            np.concatenate(ev_hi))


def coverage(lens: np.ndarray, ev_r, ev_lo, ev_hi, reso: int):
    """Per-window coverage of every read, flat, with window offsets."""
    nw = -(-lens // reso)
    woff = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(nw, out=woff[1:])
    w0 = ev_lo // reso
    w1 = ev_hi // reso
    if (ev_lo < 0).any() or (w1 >= nw[ev_r]).any() or (w1 < w0).any():
        raise ValueError("an overlap interval lies outside its read")
    T = int(woff[-1])
    diff = (np.bincount(woff[ev_r] + w0, minlength=T + 1)
            - np.bincount(woff[ev_r] + w1 + 1, minlength=T + 1))
    return np.cumsum(diff[:T]).astype(np.int32), woff


def repeats(cov, woff, lens, reso, high_cov, repeat_length, flank):
    """Qualifying runs, in read order: (read, start, end), the run's
    window span expanded by the flank and clamped to the read."""
    high = cov >= high_cov
    T = len(high)
    first = woff[:-1][woff[:-1] < woff[1:]]
    last = woff[1:][woff[:-1] < woff[1:]] - 1
    prev = np.zeros(T, bool)
    prev[1:] = high[:-1]
    prev[first] = False
    nxt = np.zeros(T, bool)
    nxt[:-1] = high[1:]
    nxt[last] = False
    rs = np.flatnonzero(high & ~prev)
    re = np.flatnonzero(high & ~nxt)
    rr = np.searchsorted(woff, rs, side="right") - 1
    start = (rs - woff[rr]) * reso
    end = (re - woff[rr] + 1) * reso
    q = end - start >= repeat_length
    rr, start, end = rr[q], start[q], end[q]
    s = np.maximum(start - flank, 0)
    e = np.where(end + flank >= lens[rr], lens[rr], end + flank)
    return rr, s, e


def fragments(lens, rep_read, rep_s, rep_e, fl: Flags):
    """(read, char_start, char_len) of every fragment, in output order.
    ``rep_read`` is sorted; markers are min(j p, L) for j = 0 ..
    ceil(L / p), so the last one is the read's end."""
    p, v = fl.interval_length, fl.overlap_length
    div = fl.read_length // p
    if div < 1:
        raise ValueError("read length under the interval length")
    n = len(lens)
    n_mk = -(-lens // p) + 1
    moff = np.zeros(n + 1, np.int64)
    np.cumsum(n_mk, out=moff[1:])
    M = int(moff[-1])
    mk_read = np.repeat(np.arange(n), n_mk)
    mk_pos = np.minimum((np.arange(M) - moff[mk_read]) * p, lens[mk_read])
    # a repeat [s, e] deletes the interior markers j p with s <= j p <= e
    lo = np.maximum(-(-rep_s // p), 1)
    hi = np.minimum(rep_e // p, n_mk[rep_read] - 2)
    hit = hi >= lo
    at = moff[rep_read[hit]]
    cut = np.cumsum(np.bincount(at + lo[hit], minlength=M + 1)
                    - np.bincount(at + hi[hit] + 1, minlength=M + 1))[:M]
    keep = cut == 0
    sv_pos = mk_pos[keep]
    S = np.bincount(mk_read[keep], minlength=n)
    soff = np.zeros(n + 1, np.int64)
    np.cumsum(S, out=soff[1:])
    nf = np.maximum(-(-(S - 1) // div), 1)
    fr_read = np.repeat(np.arange(n), nf)
    foff = np.zeros(n + 1, np.int64)
    np.cumsum(nf, out=foff[1:])
    k = np.arange(int(foff[-1])) - foff[fr_read]
    base = soff[fr_read]
    star = sv_pos[base + k * div]
    last = sv_pos[np.where(k == nf[fr_read] - 1, soff[fr_read + 1] - 1,
                           base + (k + 1) * div)]
    ov = np.where(k > 0, v, 0)
    return fr_read, star - ov, last - star + ov


def render_coverage(cov, woff, reso: int, block_reads: int = 2048,
                    workers: int = 8) -> bytes:
    """``read {i} `` then ``{window start},{coverage} `` per window, then a
    newline, for every read: the rows are cut from digit tables and the
    NUL padding dropped."""
    n = len(woff) - 1
    nw = np.diff(woff)
    tab_a = ascii_ints(np.arange(int(nw.max(initial=1))) * reso)
    tab_c = ascii_ints(np.arange(int(cov.max(initial=0)) + 1))
    tab_n = ascii_ints(np.arange(n))
    wa, wc, wn = tab_a.shape[1], tab_c.shape[1], tab_n.shape[1]
    W = max(wa + wc + 2, wn + 6) + 1

    def block(lo):
        hi = min(lo + block_reads, n)
        b_nw = nw[lo:hi]
        w_lo, w_hi = int(woff[lo]), int(woff[hi])
        M = np.zeros((w_hi - w_lo + hi - lo, W), np.uint8)
        head = woff[lo:hi] - w_lo + np.arange(hi - lo)
        M[head, :5] = np.frombuffer(b"read ", np.uint8)
        M[head, 5:5 + wn] = tab_n[lo:hi]
        M[head, 5 + wn] = ord(" ")
        rows = np.arange(w_hi - w_lo) + np.repeat(np.arange(hi - lo) + 1,
                                                  b_nw)
        j = np.arange(w_hi - w_lo) - np.repeat(woff[lo:hi] - w_lo, b_nw)
        M[rows, :wa] = tab_a[j]
        M[rows, wa] = ord(",")
        M[rows, wa + 1:wa + 1 + wc] = tab_c[cov[w_lo:w_hi]]
        M[rows, wa + 1 + wc] = ord(" ")
        M[head + b_nw, W - 1] = ord("\n")
        return M[M != 0].tobytes()

    with cf.ThreadPoolExecutor(workers) as ex:
        return b"".join(ex.map(block, range(0, n, block_reads)))


def render_repeats(n: int, rep_read, rep_s, rep_e) -> bytes:
    rep_off = np.searchsorted(rep_read, np.arange(n + 1)).tolist()
    s, e = rep_s.tolist(), rep_e.tolist()
    parts = []
    for i in range(n):
        parts.append(b"read %d, " % i)
        for k in range(rep_off[i], rep_off[i + 1]):
            parts.append(b"%d,%d    " % (s[k], e[k]))
        parts.append(b"\n")
    return b"".join(parts)


def render_fasta(names, seq_src, seq_off, fr_read, fr_s, fr_l) -> bytes:
    """One header and one sequence line per fragment, numbered from 1;
    ``seq_src`` holds read i's bases from ``seq_off[i]``."""
    mv = memoryview(seq_src)
    so = seq_off.tolist()
    parts = []
    for k, (i, s, L) in enumerate(zip(fr_read.tolist(), fr_s.tolist(),
                                      fr_l.tolist())):
        parts.append(b">read=%d,%s,pos_on_original_read=%d-%d\n"
                     % (k + 1, names[i], s, s + L))
        parts.append(mv[so[i] + s:so[i] + s + L])
        parts.append(b"\n")
    return b"".join(parts)


def expected_outputs(ds, fl: Flags, fasta_src,
                     cov_saturate: bool = False) -> tuple[dict, Work]:
    """The four files' bytes by suffix, and the work they took. The
    sequences come from ``fasta_src``, the FASTA the program was handed,
    at the generator's layout."""
    ev_r, ev_lo, ev_hi = events(ds.paf)
    cov, woff = coverage(ds.lens, ev_r, ev_lo, ev_hi, fl.reso)
    if cov_saturate:
        cov = np.minimum(cov, 127).astype(np.int8).astype(np.int32)
    rep_r, rep_s, rep_e = repeats(cov, woff, ds.lens, fl.reso, fl.high_cov,
                                  fl.repeat_length, fl.flanking_length)
    fr = fragments(ds.lens, rep_r, rep_s, rep_e, fl)
    _, seq_off = ds.fasta_layout()
    files = {
        ".reads.fasta": render_fasta(ds.names, fasta_src, seq_off, *fr),
        ".coverage.txt": render_coverage(cov, woff, fl.reso),
        ".long_repeats.txt": render_repeats(ds.n_reads, rep_r, rep_s, rep_e),
        ".long_repeats.bed": b"",
    }
    work = Work(n_reads=ds.n_reads, n_events=len(ev_r), n_windows=len(cov),
                n_repeats=len(rep_r), n_fragments=len(fr[0]))
    return files, work
