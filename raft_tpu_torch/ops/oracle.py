"""Exact-semantics host implementations of the three RAFT stages.

raft_tpu_torch's copy of ``raft_tpu/ops/oracle.py``, unchanged apart from
its import paths.

These are direct re-derivations (NOT ports — written from the behavioral
contract in SURVEY.md §2/§3) of:

* ``profileCoverage``  (/root/reference/repeat.hpp:28-79)
* ``repeat_annotate``  (/root/reference/repeat.hpp:81-204, per-read scan)
* ``break_reads``      (/root/reference/chop.hpp:193-324, marker logic)

They serve as (a) the unit-test oracle for the JAX/Pallas device kernels
and (b) the reference engine for byte-parity testing of the CLI. They are
NOT a spill path — the device engine's slot counts (K/M/F) are closed-form
bounds no input can exceed (see ``engine_jax.derive_cfg`` and
tests/test_kernels.py::test_closed_form_slot_bounds), so nothing ever
needs to spill.

All quantities are integers; semantics notes:

* Coverage: an overlap interval ``[s, e)`` on a read increments windows
  ``floor(s/reso) .. floor((e-1)/reso)`` inclusive (empty if the second
  index is smaller, which happens for zero-length matches starting on a
  window boundary).
* Repeat runs: a maximal run of windows with ``cov >= high_cov`` spanning
  ``[run_start*reso, (last+1)*reso)`` qualifies when its (unclamped)
  length ``>= repeat_length``; the recorded interval is expanded by
  ``flanking_length`` and clamped to ``[0, len]``, while the *unclamped*
  length feeds the global repeat-fraction statistic.
* Chop: candidate markers at ``0, IL, 2*IL, ..`` plus the read end; the
  first and last markers always survive; an interior marker ``m`` is
  deleted iff some recorded repeat ``[s, e]`` has ``s <= m <= e``.
  With ``div = read_length // interval_length``: if at most ``div+1``
  markers survive the read is emitted whole, else fragments each consume
  ``div`` markers, extended ``overlap_length`` bp to the left except for
  the first fragment, and the last fragment runs to the final marker.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def n_windows(length: int, reso: int) -> int:
    return -(-int(length) // reso) if length > 0 else 0


def coverage_one_read(length: int, reso: int,
                      ev_lo: np.ndarray, ev_hi: np.ndarray,
                      strict: bool = True) -> np.ndarray:
    """Windowed coverage for one read. ``ev_hi`` is INCLUSIVE (= end-1)."""
    nw = n_windows(length, reso)
    cov = np.zeros(nw, dtype=np.int32)
    if len(ev_lo) == 0 or nw == 0:
        return cov
    w0 = np.asarray(ev_lo, dtype=np.int64) // reso
    w1 = np.floor_divide(np.asarray(ev_hi, dtype=np.int64), reso)
    # C++ int division truncates toward zero; ev_hi == -1 (zero-length match
    # at position 0) must give w1 == 0-with-empty-range, i.e. w1 < w0 anyway.
    w1 = np.where(np.asarray(ev_hi) < 0, -1, w1)
    if strict and (w1.max(initial=-1) >= nw or w0.min(initial=0) < 0):
        raise ValueError(
            "overlap interval exceeds read bounds (reference RAFT has an "
            "unchecked buffer overrun here, repeat.hpp:69-73); "
            "fix the PAF or run with --no-strict")
    w1c = np.minimum(w1, nw - 1)
    w0c = np.clip(w0, 0, nw)
    valid = w1c >= w0c
    diff = np.zeros(nw + 1, dtype=np.int32)
    np.add.at(diff, w0c[valid], 1)
    np.add.at(diff, w1c[valid] + 1, -1)
    np.cumsum(diff[:nw], out=cov)
    return cov


@dataclasses.dataclass
class RepeatResult:
    intervals: list[tuple[int, int]]   # clamped, flank-expanded [s, e]
    repeat_length_sum: int             # unclamped sum for global stats


def repeats_one_read(cov: np.ndarray, length: int, reso: int,
                     high_cov: int, repeat_length: int,
                     flank: int) -> RepeatResult:
    """Run-length scan over one read's windowed coverage."""
    out: list[tuple[int, int]] = []
    total = 0
    start = 0
    end = 0
    for j in range(len(cov)):
        if cov[j] >= high_cov:
            end = j * reso + reso
        else:
            if end - start >= repeat_length:
                total += end - start
                s = max(start - flank, 0)
                e = end + flank
                if e >= length:
                    e = length
                out.append((s, e))
            start = j * reso + reso
            end = start
    if end - start >= repeat_length:
        total += end - start
        s = max(start - flank, 0)
        e = end + flank
        if e >= length:
            e = length
        out.append((s, e))
    return RepeatResult(intervals=out, repeat_length_sum=total)


def markers_one_read(length: int, interval_length: int) -> list[int]:
    """Candidate cut markers: 0, IL, 2*IL, ..., plus the read end."""
    parts = length // interval_length
    stars = [j * interval_length for j in range(parts + 1)]
    if length % interval_length:
        stars.append(length)
    return stars


def surviving_markers(stars: list[int],
                      repeats: list[tuple[int, int]]) -> list[int]:
    """Repeat-aware marker deletion. First and last markers always survive;
    an interior marker m dies iff some repeat [s,e] has s <= m <= e."""
    if len(stars) <= 2:
        return list(stars)
    final = [stars[0]]
    for m in stars[1:-1]:
        if not any(s <= m <= e for (s, e) in repeats):
            final.append(m)
    final.append(stars[-1])
    return final


@dataclasses.dataclass
class Fragment:
    """One output fragment of a read.

    ``char_start``/``char_len`` index the read's bases;
    ``star``/``last`` are the marker positions bounding it (pre-overlap);
    ``ov`` is the left extension actually applied; ``whole`` flags the
    emit-read-whole branch (different simulated-mode header).
    """
    char_start: int
    char_len: int
    star: int
    last: int
    ov: int
    whole: bool


def chop_one_read(length: int, final_stars: list[int],
                  read_length: int, interval_length: int,
                  overlap_length: int) -> list[Fragment]:
    div = read_length // interval_length
    S = len(final_stars)
    if S <= div + 1:
        return [Fragment(0, length, 0, length, 0, True)]
    fragments = 1 + (S - (div + 1)) // div
    if (S - (div + 1)) % div:
        fragments += 1
    out: list[Fragment] = []
    pos = 0
    for j in range(1, fragments + 1):
        ov = 0 if j == 1 else overlap_length
        last = final_stars[-1] if j == fragments else final_stars[pos + div]
        star = final_stars[pos]
        out.append(Fragment(star - ov, last - star + ov, star, last, ov, False))
        pos += div
    return out
