"""Kernels layer (``csrc/pileup.cu``, ``csrc/scan_chop.cu``): the device
step's least time (``peaks.least_seconds`` of the work counted from the
dataset by ``peaks.device_step_work``) over the summed device time of the
kernels of one profiled pass, in percent."""

from perfbench import peaks


def read(t):
    p = t.profile
    if not p or p["kernel_s"] <= 0:
        return None
    w = t.work
    least, _ = peaks.least_seconds(*peaks.device_step_work(
        w.n_reads, w.n_events, w.n_windows, w.n_repeats, w.n_fragments))
    return 100.0 * least / p["kernel_s"]
