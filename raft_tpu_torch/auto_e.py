"""Self-estimating coverage: the ``--auto-e`` est_cov estimator.

raft_tpu_torch's copy of ``raft_tpu/auto_e.py``, unchanged apart from
its import paths.

est_cov (``-e``) is the ONE knob reference-RAFT users must compute by
hand — total_bases / genome_size per ``/root/reference/README.md:22-26``
— and the r4 sensitivity sweep (EVAL.md) measured its failure mode as
severe and asymmetric: a 0.5x under-estimate collapses flank-tolerant
repeat precision to 0.02-0.11 and largely stops fragmentation, while
over-estimates are harmless up to 1.5x and only cost recall near 2x.
The engine already derives the full per-window coverage distribution
from the overlap events, so the right value can be read off the data.

Estimator (measured against simulated truth, EVAL.md r5):

1. Histogram per-window pileup coverage over every read (native
   threaded pass; numpy fallback), excluding zero-coverage windows
   (read flanks / orphan reads carry no signal).
2. Take the upper weighted median — on simulated 30x data this lands on
   29-30 for every genome size / seed tested, where the mean sits at
   ~37 (inflated by the repeat tail; that inflation is exactly why the
   reference's stdout ``coverage per window`` stat over-estimates).
3. One fixed-point refinement: drop windows at or above the provisional
   threshold ``int(median * cov_mul)`` (the windows a first-pass run
   would call repeat) and re-take the median, so a heavy repeat tail
   cannot drag the center up.
4. Bias the result UP by 1.15 (ceil): the sweep shows quality is flat
   and maximal on [1.1x, 1.5x] of the true coverage — measured at the
   10 Mbp noise point, precision_fl is 0.85 at 1.0x but 0.995 from
   1.1x — while the damage direction (under-estimate) starts
   immediately below 1.0x. 1.15x centers the estimate in the safe band
   with margin for the median's own ~5% downward jitter.

Byte parity: ``--auto-e`` is opt-in; default runs never call this
module, and an auto-e run produces exactly the bytes of ``-e <estimate>``
(tested: tests/test_auto_e.py).
"""

from __future__ import annotations

import math

import numpy as np

# Upper bias applied to the median estimate (EVAL.md r5: quality is flat
# and maximal on [1.1x, 1.5x] of true coverage; under-estimates damage).
SAFETY_MUL = 1.15

# Histogram length: coverage clamps into the top bin. 65536 covers any
# plausible pileup depth (reference int32 coverage; HiFi depth << 1000).
HIST_LEN = 65536


def cov_histogram_grouped(ev_off: np.ndarray, w0: np.ndarray,
                          w1: np.ndarray, lens: np.ndarray,
                          reso: int) -> np.ndarray:
    """Per-window coverage histogram from read-grouped window-binned
    events. Native threaded pass when available; vectorized numpy
    fallback (global diff + cumsum — per-read events cancel to zero, so
    one flat cumsum yields every read's coverage)."""
    try:
        from raft_tpu_torch.io import native
        h = native.cov_hist(w0, w1, ev_off, lens, reso, HIST_LEN)
        if h is not None:
            return h
    except Exception:
        pass
    return _cov_histogram_numpy(ev_off, w0, w1, lens, reso)


def _cov_histogram_numpy(ev_off, w0, w1, lens, reso):
    lens = np.asarray(lens, dtype=np.int64)
    nw = -(-lens // reso)
    n = len(lens)
    cov_off = np.concatenate([[0], np.cumsum(nw)])
    total = int(cov_off[-1])
    if total == 0:
        return np.zeros(HIST_LEN, dtype=np.int64)
    rid = np.repeat(np.arange(n), np.diff(np.asarray(ev_off)))
    w0 = np.asarray(w0, dtype=np.int64)
    w1 = np.asarray(w1, dtype=np.int64)
    valid = (w1 >= w0) & (w0 >= 0) & (w0 < nw[rid])
    w1c = np.minimum(w1, nw[rid] - 1)
    diff = np.zeros(total + 1, dtype=np.int64)
    np.add.at(diff, cov_off[rid[valid]] + w0[valid], 1)
    np.add.at(diff, cov_off[rid[valid]] + w1c[valid] + 1, -1)
    cov = np.cumsum(diff[:-1])
    h = np.bincount(np.minimum(cov, HIST_LEN - 1), minlength=HIST_LEN)
    return h.astype(np.int64)


def cov_histogram_events(ev_read, ev_lo, ev_hi, lens, reso) -> np.ndarray:
    """Histogram from UNGROUPED raw events (read_id, start,
    end_inclusive) — the spill-path / pure-python input shape. Bins with
    the shared convention (hi<0 -> -1) then groups by sorting."""
    ev_read = np.asarray(ev_read, dtype=np.int64)
    order = np.argsort(ev_read, kind="stable")
    ev_read = ev_read[order]
    lo = np.asarray(ev_lo, dtype=np.int64)[order]
    hi = np.asarray(ev_hi, dtype=np.int64)[order]
    w0 = lo // reso
    w1 = np.where(hi < 0, -1, hi // reso)
    n = len(lens)
    ev_off = np.searchsorted(ev_read, np.arange(n + 1))
    return cov_histogram_grouped(ev_off.astype(np.int64),
                                 w0.astype(np.int32),
                                 w1.astype(np.int32), lens, reso)


def estimate_from_hist(hist: np.ndarray, cov_mul: float) -> dict:
    """Estimate est_cov from a per-window coverage histogram.

    Returns ``{"est_cov", "median", "refined_median", "nonzero_windows"}``
    with ``est_cov == 0`` when there is no signal (no covered window)."""
    h = np.asarray(hist, dtype=np.int64).copy()
    if len(h) == 0:
        return dict(est_cov=0, median=0, refined_median=0,
                    nonzero_windows=0)
    h[0] = 0
    tot = int(h.sum())
    if tot == 0:
        return dict(est_cov=0, median=0, refined_median=0,
                    nonzero_windows=0)
    cum = np.cumsum(h)
    med0 = int(np.searchsorted(cum, (tot + 1) // 2))
    # fixed-point tail exclusion: windows the provisional threshold
    # would already call repeat carry no information about base coverage
    thr = max(int(med0 * cov_mul), med0 + 1)
    h2 = h.copy()
    h2[min(thr, len(h2)):] = 0
    tot2 = int(h2.sum())
    if tot2 > 0:
        med1 = int(np.searchsorted(np.cumsum(h2), (tot2 + 1) // 2))
    else:
        med1 = med0
    est = max(1, int(math.ceil(med1 * SAFETY_MUL)))
    return dict(est_cov=est, median=med0, refined_median=med1,
                nonzero_windows=tot)


def estimate_for_table(table, lens, n_reads: int, reso: int,
                       cov_mul: float, strict: bool = True):
    """High-level estimate from an OverlapTable (whole-file paths).

    Returns ``(info_dict, grouped_or_None)`` — ``grouped`` is the
    (ev_off, w0, w1) triple when the native grouping pass ran, so the
    caller can reuse it instead of regrouping."""
    grouped = None
    eg = getattr(table, "events_grouped", None)
    if eg is not None:
        grouped = eg(n_reads, lens, reso, strict=strict)
    if grouped is not None:
        hist = cov_histogram_grouped(grouped[0], grouped[1], grouped[2],
                                     lens, reso)
    else:
        ev_read, ev_lo, ev_hi = table.events(n_reads, strict=strict)
        hist = cov_histogram_events(ev_read, ev_lo, ev_hi, lens, reso)
    return estimate_from_hist(hist, cov_mul), grouped


def estimate_for_bins(bins, lens, reso: int, cov_mul: float,
                      chunk: int) -> dict:
    """Estimate from spilled per-chunk event files (the --spill-paf
    path): one extra sequential read of the spill, accumulating the
    histogram chunk by chunk — overlap memory stays bounded."""
    lens = np.asarray(lens, dtype=np.int64)
    hist = np.zeros(HIST_LEN, dtype=np.int64)
    for k in range(bins.n_bins):
        lo = k * chunk
        hi = min(lo + chunk, len(lens))
        ev_read, ev_lo, ev_hi = bins.events_for_bin(k)
        hist += cov_histogram_events(ev_read - lo, ev_lo, ev_hi,
                                     lens[lo:hi], reso)
    return estimate_from_hist(hist, cov_mul)
