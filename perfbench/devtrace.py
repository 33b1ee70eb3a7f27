"""One pass under ``torch.profiler`` (CPU and CUDA activity), reduced to
what the per-layer metrics and the ``breakdown`` read: the device's busy
time (the union of kernel, copy and set intervals), the kernels' summed
time, the device operations by total time, and the idle gaps labelled by
the host stage the benchmark can see around them (before the first
device operation: parse; between the first and the last: compute; after
the last: emit)."""

from __future__ import annotations

import json
import os
import tempfile

PASS_SPAN = "perfbench.pass"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_pass(run):
    """Run ``run()`` under the profiler; returns (its result, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(PASS_SPAN):
            out = run()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize(events)


def summarize(events: list) -> dict:
    span = [e for e in events if e.get("ph") == "X"
            and e.get("name") == PASS_SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError(f"profiler trace has no {PASS_SPAN} span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["cat"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    by_name: dict = {}
    kernel_us = 0.0
    for s, e, cat, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cat == "kernel":
            kernel_us += e - s
    merged: list = []
    for s, e, _, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps = []
    if merged:
        gaps.append(("parse", merged[0][0] - t0))
        gaps += [("compute", b[0] - a[1]) for a, b in zip(merged, merged[1:])]
        gaps.append(("emit", t1 - merged[-1][1]))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_us / 1e6,
        "n_device_ops": len(dev),
        "device_ops": [[n[:120], us / 1e6] for n, us in ops[:10]],
        "idle_gaps": [[n, us / 1e6] for n, us in gaps[:10]],
    }
