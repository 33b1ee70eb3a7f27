"""Device layer: the share of one profiled pass's wall in which no kernel,
copy or set ran on the card (``torch.profiler``, the union of device
intervals)."""


def read(t):
    p = t.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
