"""The program's host spans and counters in a traced run, for the
per-layer readers that read them: ``raft_tpu_torch.profiling`` keeps the
recording of every ``run_pipeline`` made under ``torch.profiler``, and the
traced run's profiled pass (after the window, on the card only) is the one
such run in the process. The readers find nothing, and return None, off
the card and with a program that has no such recorder."""

from __future__ import annotations


def profiled_run(t):
    """The profiled pass's recording (``spans``: dicts with ``name``,
    ``t0``, ``t1`` in ns; ``counters``), or None."""
    if t.profile is None:
        return None
    try:
        from raft_tpu_torch import profiling
    except ImportError:
        return None
    runs = getattr(profiling, "profiled_runs", None)
    runs = runs() if runs is not None else []
    if not runs:
        return None
    rec = runs[-1]
    root = [s for s in rec.spans if s["parent"] is None]
    # the pass's window holds the whole run
    if not root or max(s["t1"] - s["t0"] for s in root) > (
            t.profile["window_s"] * 1e9):
        return None
    return rec


def span_s_per_gbp(t, *names: str) -> float | None:
    """Seconds of the profiled pass's spans named ``names``, summed over
    threads, per input Gbp; None where none of them was recorded."""
    rec = profiled_run(t)
    if rec is None:
        return None
    durs = [s["t1"] - s["t0"] for s in rec.spans if s["name"] in names]
    if not durs:
        return None
    return sum(durs) / 1e9 / t.gbp


def counter_sum(t, names) -> int | None:
    """The sum of the profiled pass's counters ``names`` that it has;
    None where it has none of them."""
    rec = profiled_run(t)
    if rec is None:
        return None
    got = [rec.counters[n] for n in names if n in rec.counters]
    return sum(got) if got else None
