"""The run's one timing system: host spans and counters, on the clock of
the ``torch.profiler`` trace.

* ``span(name, **attrs)`` is a context manager. A recorded span holds its
  name, start and end (``time.perf_counter_ns()``), its thread, its parent
  (the innermost open span of its thread, or the span that handed its work
  to a pool through ``bind``) and small attributes.
* ``count(name, n)`` adds ``n`` to a counter of the run.
* ``stage(stats, key)`` is a span that also adds its seconds to
  ``stats.stage_seconds[key]``, whether recording is on or off.
* ``Marks`` closes back-to-back spans (the engine's stages) and sums them
  by name for ``compute_torch(timers_out=...)``.

Recording is per run (``run``, around ``pipeline.run_pipeline``). It is
on when ``RAFT_SPANS=1``, when a ``torch.profiler`` is active around the
run (``trace``, the CLI's ``--trace DIR``), or when the caller forces it
(the chunked schedule writing ``RAFT_CHUNK_TRACE``). Off, ``span`` is one
flag check returning a shared no-op context, ``count`` returns at once and
the native emitters (``io.native``) get no stats array. Spans stay in
memory; the run hands them out on ``TorchRunStats.spans`` and
``counters``.

Under an active profiler the root span also opens
``torch.profiler.record_function(ANCHOR)``: that annotation's start on the
profiler's clock and on ``perf_counter`` (``Recording.anchor_ns``) map
every span of the run, from every thread, onto the profiler's timeline
(``trace_events``). Such runs are kept, the last ``PROFILED_KEEP``, for
whoever exports the profiler's trace (``profiled_runs``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

TRACE_FILE = "raft_trace.json"
ANCHOR = "raft.run_pipeline"
SPAN_CAT = "raft_span"
PROFILED_KEEP = 16
TRACK_BASE = 1 << 30  # trace tids of the span tracks, clear of real tids

_clock = time.perf_counter_ns
_active = 0  # runs recording now: the one check of the off path
_lock = threading.Lock()
_tls = threading.local()
_profiled: deque = deque(maxlen=PROFILED_KEEP)


class Recording:
    """One run's spans (dicts: ``id``, ``parent``, ``name``, ``thread``,
    ``t0``, ``t1`` in ``perf_counter`` ns, ``attrs``; in the order they
    closed) and counters. ``anchor_ns``, where the run ran under a
    profiler, is the ``perf_counter`` time of its ``ANCHOR`` annotation's
    start: the middle of the call that opened it, so off by at most half
    that call."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.anchor_ns: int | None = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int, attrs: dict) -> None:
        """A span that has already closed, child of this thread's
        innermost open span."""
        stack = _tls.stack
        self.spans.append({"id": next(self._ids),
                           "parent": stack[-1] if stack else None,
                           "name": name,
                           "thread": threading.current_thread().name,
                           "t0": t0, "t1": t1, "attrs": attrs})

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)


class _Span:
    __slots__ = ("rec", "name", "attrs", "sid", "parent", "t0", "t1")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _tls.stack
        self.parent = stack[-1] if stack else None
        self.sid = next(self.rec._ids)
        stack.append(self.sid)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        _tls.stack.pop()
        self.rec.spans.append({"id": self.sid, "parent": self.parent,
                               "name": self.name,
                               "thread": threading.current_thread().name,
                               "t0": self.t0, "t1": self.t1,
                               "attrs": self.attrs})
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


def recording() -> Recording | None:
    """The recording this thread's work belongs to, or None."""
    return getattr(_tls, "rec", None) if _active else None


def span(name: str, **attrs):
    """A span of ``name`` around the block (``set(**attrs)`` adds
    attributes before it closes); the shared no-op when not recording."""
    if not _active:
        return _NULL
    rec = getattr(_tls, "rec", None)
    return _NULL if rec is None else _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the run's counter ``name`` (nothing when not
    recording)."""
    if not _active:
        return
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.count(name, n)


def bind(fn, name: str | None = None, **attrs):
    """``fn`` for another thread (a pool's worker). When recording, the
    worker records into this thread's run, its spans' parent the innermost
    span open here now, inside a span ``name`` where given. Otherwise
    ``fn`` itself."""
    if not _active:
        return fn
    rec = getattr(_tls, "rec", None)
    if rec is None:
        return fn
    stack = _tls.stack
    base = stack[-1:]

    def run(*a, **k):
        old = getattr(_tls, "rec", None), getattr(_tls, "stack", None)
        _tls.rec, _tls.stack = rec, list(base)
        try:
            if name is None:
                return fn(*a, **k)
            with _Span(rec, name, dict(attrs)):
                return fn(*a, **k)
        finally:
            _tls.rec, _tls.stack = old
    return run


class stage:
    """``with stage(stats, key[, name])``: a span ``name`` (default
    ``key``) whose duration is added to ``stats.stage_seconds[key]``,
    recording or not. The totals are kept in integer ns
    (``stats.stage_ns``), so a stage's seconds equal the sum of its spans'
    durations exactly."""

    __slots__ = ("stats", "key", "sp", "t0")

    def __init__(self, stats, key: str, name: str | None = None):
        self.stats, self.key = stats, key
        self.sp = span(name or key)

    def __enter__(self):
        sp = self.sp.__enter__()
        self.t0 = _clock() if sp is _NULL else None
        return sp

    def __exit__(self, *exc):
        self.sp.__exit__(*exc)
        sp = self.sp
        dt = _clock() - self.t0 if self.t0 is not None else sp.t1 - sp.t0
        ns = self.stats.stage_ns
        ns[self.key] = ns.get(self.key, 0) + dt
        self.stats.stage_seconds[self.key] = ns[self.key] / 1e9
        return False


class Marks:
    """Back-to-back spans ``<prefix><name>`` on this thread: each
    ``mark(name, **attrs)`` closes the interval since the previous mark
    (or since construction). ``seconds()`` sums them by name. Reads no
    clock when neither recording nor ``want``."""

    def __init__(self, prefix: str, want: bool = False):
        self.rec = recording()
        self.prefix = prefix
        self.on = want or self.rec is not None
        self.ns: dict = {}
        self.t = _clock() if self.on else 0

    def mark(self, name: str, **attrs) -> None:
        if not self.on:
            return
        t = _clock()
        if self.rec is not None:
            self.rec.add(self.prefix + name, self.t, t, attrs)
        self.ns[name] = self.ns.get(name, 0) + t - self.t
        self.t = t

    def seconds(self) -> dict:
        return {k: v / 1e9 for k, v in self.ns.items()}


def _profiler_active() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def run(name: str = "run_pipeline", force: bool = False):
    """One run's recording around the block, under the root span
    ``name``; yields the ``Recording``, or None when not recording (see
    the module's docstring). Inside a run already recording on this
    thread it yields that run's recording and opens nothing."""
    global _active
    outer = recording()
    profiled = _profiler_active()
    wanted = os.environ.get("RAFT_SPANS", "") not in ("", "0")
    if outer is not None or not (force or profiled or wanted):
        yield outer
        return
    rec = Recording()
    with _lock:
        _active += 1
    _tls.rec, _tls.stack = rec, []
    try:
        with contextlib.ExitStack() as es:
            es.enter_context(_Span(rec, name, {}))
            if profiled:
                from torch.profiler import record_function
                t = _clock()
                es.enter_context(record_function(ANCHOR))
                # the annotation's start is stamped inside this interval
                rec.anchor_ns = (t + _clock()) // 2
            yield rec
    finally:
        _tls.rec, _tls.stack = None, []
        with _lock:
            _active -= 1
        if rec.anchor_ns is not None:
            _profiled.append(rec)


def profiled_runs() -> list:
    """The recordings of the last ``PROFILED_KEEP`` runs that ran under a
    ``torch.profiler``, oldest first."""
    return list(_profiled)


def span_seconds(spans: list) -> dict:
    """``{name: [seconds, spans]}`` summed over ``spans``, largest
    first."""
    out: dict = {}
    for s in spans:
        tot = out.setdefault(s["name"], [0, 0])
        tot[0] += s["t1"] - s["t0"]
        tot[1] += 1
    return {k: [ns / 1e9, n] for k, (ns, n) in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def trace_events(rec: Recording, anchor_us: float, pid: int) -> list:
    """``rec``'s spans as Chrome-trace complete events (``cat``
    ``SPAN_CAT``, one track per thread) on a profiler timeline in which
    the ``ANCHOR`` annotation of the run starts at ``anchor_us``."""
    off = anchor_us - rec.anchor_ns / 1e3
    tracks: dict = {}
    events = []
    for s in rec.spans:
        tid = tracks.setdefault(s["thread"], TRACK_BASE + len(tracks))
        events.append({"ph": "X", "cat": SPAN_CAT, "name": s["name"],
                       "pid": pid, "tid": tid, "ts": s["t0"] / 1e3 + off,
                       "dur": (s["t1"] - s["t0"]) / 1e3,
                       "args": {**s["attrs"], "id": s["id"],
                                "parent": s["parent"]}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"raft spans: {thread}"}}
               for thread, tid in tracks.items()]
    return events


def add_spans_to_trace(path: str, runs: list) -> None:
    """Append the spans of ``runs`` (anchored recordings, in run order)
    to the Chrome trace at ``path``, each run mapped by its own ``ANCHOR``
    annotation."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    anchors = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("name") == ANCHOR), key=lambda e: e["ts"])
    for rec, a in zip(runs, anchors):
        events += trace_events(rec, float(a["ts"]), a.get("pid", os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(outdir: str | None, device: str = "cpu"):
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it into ``outdir`` as a Chrome trace (``raft_trace.json``; open it in
    Perfetto or chrome://tracing). CPU activity always, CUDA activity
    (kernels, copies) too when ``device`` is ``cuda``; the host spans of
    every ``run_pipeline`` in the block join it (``SPAN_CAT`` events, a
    track per thread). Wired to the CLI as ``--trace DIR``. A no-op when
    ``outdir`` is falsy."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    t0 = _clock()
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(outdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    runs = [r for r in _profiled if r.anchor_ns >= t0]
    if runs:
        add_spans_to_trace(path, runs)
