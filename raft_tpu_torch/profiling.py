"""Profiler trace of a run: the counterpart of ``raft_tpu/profiling.py``
on ``torch.profiler``. Stage timers live in ``RunStats.stage_seconds``."""

from __future__ import annotations

import contextlib
import os

TRACE_FILE = "raft_trace.json"


@contextlib.contextmanager
def trace(outdir: str | None, device: str = "cpu"):
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it into ``outdir`` as a Chrome trace (``raft_trace.json``; open it in
    Perfetto or chrome://tracing). CPU activity always, CUDA activity
    (kernels, copies) too when ``device`` is ``cuda``. Wired to the CLI as
    ``--trace DIR``. A no-op when ``outdir`` is falsy."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))
