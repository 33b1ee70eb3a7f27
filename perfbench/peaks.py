"""The card's peaks and the work the device step needs, counted from the
dataset (not from the program's buckets or packed layout, so a
re-bucketed, fused or persistent kernel is measured against the same
work).

* ``HBM_BYTES_S``: NVIDIA's published HBM3 bandwidth of the H100 SXM.
* ``INT32_OPS_S``: derived from the architecture, not published: 132 SMs
  x 64 INT32 lanes x the 1.98 GHz boost clock.

Both assume the card's full power limit of 700 W; the harness prints the
card's limit beside every roofline share.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9


def device_step_work(n_reads: int, n_events: int, n_windows: int,
                     n_repeats: int, n_fragments: int) -> tuple[int, int]:
    """(bytes, int32 operations) of the whole device step over a pass.

    Bytes: each event's two window bounds and each read length read once
    (4 bytes each), each repeat interval and fragment span written once
    (two int32 each). Operations: one per event endpoint, two per window
    (the coverage prefix sum and the threshold scan), with a read's
    windows counted as ceil(length / r)."""
    nbytes = 8 * n_events + 4 * n_reads + 8 * n_repeats + 8 * n_fragments
    ops = 2 * n_events + 2 * n_windows
    return nbytes, ops


def least_seconds(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_mem = nbytes / HBM_BYTES_S
    t_ops = ops / INT32_OPS_S
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "int32_ops")
