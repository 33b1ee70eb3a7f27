"""The port's one timing system (``raft_tpu_torch.profiling``) on the CPU:
off by default and byte-neutral on, spans nested and named as documented
for both schedules, ``stage_seconds`` and ``RAFT_CHUNK_TRACE`` read from
the spans, the counters against what they count, the native emitters'
stats array, and ``--trace DIR``'s host spans on the profiler's clock."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu_torch import profiling  # noqa: E402
from raft_tpu_torch import pipeline as port_pipeline  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.io import native  # noqa: E402
from raft_tpu_torch.ops import gather_cuda  # noqa: E402
from raft_tpu_torch.params import AlgoParams  # noqa: E402

OUTS = port_pipeline.OUT_NAMES
SCHEDULES = {"whole": {"chunk_reads": 0}, "chunked": {"chunk_reads": 9}}
STAGES = {"whole": {"load_reads", "load_paf", "compute", "emit"},
          "chunked": {"index", "load_paf", "group_events", "load_reads",
                      "compute", "emit"}}
WRITERS = ("emit.coverage", "emit.repeats", "emit.bed", "emit.fasta")
FILES = {"emit.fasta": ".reads.fasta", "emit.coverage": ".coverage.txt",
         "emit.repeats": ".long_repeats.txt", "emit.bed": ".long_repeats.bed"}
ENGINE = {"engine.events", "engine.cov_events", "engine.bucket_prep",
          "engine.h2d", "engine.step", "engine.integrate"}
RESERVE = {"emit.reserve", "emit.fasta.reserve_wait"}
NAMES = {
    "whole": {"run_pipeline", "load_reads", "load_paf", "parse.preparse_paf",
              "parse.resolve_paf", "compute", "emit", "free", *ENGINE,
              *WRITERS, *RESERVE,
              *(w + ".prep" for w in WRITERS),
              *(w + ".native" for w in WRITERS)},
    "chunked": {"run_pipeline", "index", "load_paf", "parse.preparse_paf",
                "parse.resolve_paf", "group_events", "chunks", "chunk",
                "chunk.wait_load", "chunk.drain", "chunk.load",
                "chunk.load.read", "chunk.load.events", "compute", "emit",
                "free", *ENGINE, *WRITERS, *(w + ".prep" for w in WRITERS),
                *(w + ".native" for w in WRITERS)},
}
COUNTERS = {"parse.fasta_bytes", "parse.paf_bytes", "parse.reads",
            "parse.paf_rows", "engine.buckets", "engine.events",
            "engine.windows", "engine.h2d_bytes", "engine.d2h_bytes",
            "engine.fragments", "engine.cut_reads", "engine.repeats",
            "engine.table_bytes", "engine.gather.buckets",
            "engine.gather.bytes",
            *(f"engine.wide.{k}" for k in ("buckets", "reads", "windows",
                                           "events", "repeats",
                                           "fragments")),
            *(f"{w}.{slot}" for w in WRITERS
              for slot in native.EMIT_STATS)}


def _params(tmp, name):
    return AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                      interval_length=2000, read_length=4000,
                      flanking_length=300, overlap_length=200,
                      outputfilename=f"{tmp}/{name}")


def _run(reads, paf, tmp, name, **kw):
    return port_pipeline.run_pipeline(reads, paf, _params(tmp, name),
                                      device="cpu", verbose=False, **kw)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spans"))
    reads, paf = datagen.standard_case(seed=21, tmpdir=tmp, n_reads=37,
                                       simulated=True)
    return reads, paf, tmp


@pytest.fixture(scope="module")
def ul_case(tmp_path_factory):
    """Ultra-long reads (110-300 kb): every bucket wider than 2,048
    windows at the default -r 50, most reads cut."""
    tmp = str(tmp_path_factory.mktemp("spans_ul"))
    reads, paf = datagen.standard_case(seed=22, tmpdir=tmp, n_reads=10,
                                       len_lo=110_000, len_hi=300_000,
                                       n_pairs=60)
    return reads, paf, tmp


@pytest.fixture
def recorded(case, monkeypatch):
    """Runs with RAFT_SPANS=1 on the case; returns (stats, prefix)."""
    reads, paf, tmp = case
    monkeypatch.setenv("RAFT_SPANS", "1")

    def go(name, **kw):
        return _run(reads, paf, tmp, name, **kw), f"{tmp}/{name}"
    return go


@pytest.mark.parametrize("sched", SCHEDULES)
def test_recording_off_hands_out_nothing(case, monkeypatch, sched):
    reads, paf, tmp = case
    monkeypatch.delenv("RAFT_SPANS", raising=False)
    monkeypatch.delenv("RAFT_CHUNK_TRACE", raising=False)
    st = _run(reads, paf, tmp, f"off_{sched}", **SCHEDULES[sched])
    assert st.spans == [] and st.counters == {}
    assert set(st.stage_seconds) == STAGES[sched]
    assert all(v > 0 for v in st.stage_seconds.values())
    assert profiling.span("x") is profiling._NULL
    assert profiling.bind(len) is len


@pytest.mark.parametrize("kw", [{"chunk_reads": 0}, {"chunk_reads": 9},
                                {"chunk_reads": 0, "gz_out": True},
                                {"chunk_reads": 9, "spill_paf": True},
                                {"chunk_reads": 0, "ul": True}],
                         ids=["whole", "chunked", "whole_gz", "spill",
                              "ul_whole"])
def test_recording_on_changes_no_byte(request, monkeypatch, kw):
    kw = dict(kw)
    ul = kw.pop("ul", False)
    reads, paf, tmp = request.getfixturevalue("ul_case" if ul else "case")
    name = "_".join(f"{k}{v}" for k, v in kw.items())
    sfx = ".gz" if kw.get("gz_out") else ""
    monkeypatch.delenv("RAFT_SPANS", raising=False)
    _run(reads, paf, tmp, "b_off" + name, **kw)
    monkeypatch.setenv("RAFT_SPANS", "1")
    st = _run(reads, paf, tmp, "b_on" + name, **kw)
    assert st.spans and st.counters
    for ext in OUTS:
        with open(f"{tmp}/b_off{name}{ext}{sfx}", "rb") as f, \
                open(f"{tmp}/b_on{name}{ext}{sfx}", "rb") as g:
            assert f.read() == g.read(), ext


@pytest.mark.parametrize("sched", SCHEDULES)
def test_spans_nest_within_their_parents(recorded, sched):
    st, _ = recorded(f"nest_{sched}", **SCHEDULES[sched])
    by_id = {s["id"]: s for s in st.spans}
    assert len(by_id) == len(st.spans)
    roots = [s for s in st.spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["run_pipeline"]
    root = roots[0]
    for s in st.spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        if p["thread"] == s["thread"]:
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
        else:  # work handed to a pool starts after its submitter opened
            assert p["t0"] <= s["t0"] and s["t1"] <= root["t1"], (s, p)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_documented_names(recorded, sched):
    st, _ = recorded(f"names_{sched}", **SCHEDULES[sched])
    names = {s["name"] for s in st.spans}
    assert NAMES[sched] <= names, NAMES[sched] - names
    want = COUNTERS | ({"chunk.events"} if sched == "chunked" else
                       {"emit.fasta.reserved_bytes"})
    assert want <= set(st.counters), want - set(st.counters)
    by_id = {s["id"]: s for s in st.spans}
    for s in st.spans:
        if s["name"] == "emit.reserve":
            assert s["thread"] != root_thread(st)
        if s["name"] == "emit.fasta.reserve_wait":
            assert by_id[s["parent"]]["name"] == "emit.fasta"
        if s["name"] == "engine.step":
            regimes = {"pileup_regime": 0, "scan_chop_regime": 0}
            assert set(s["attrs"]) == {"B", "W", "E", *regimes}
            assert regimes.items() <= s["attrs"].items()
        if s["name"] == "engine.bucket_prep":
            assert set(s["attrs"]) == {"buckets"}
            assert s["attrs"]["buckets"] >= 1
        if s["name"] == "engine.h2d":  # the table's one upload
            assert s["attrs"] == {"table": 1}
        if s["name"] in ("engine.bucket_prep", "engine.h2d", "engine.step"):
            assert by_id[s["parent"]]["name"] == "compute"
        if s["name"] in WRITERS:
            assert s["thread"] != root_thread(st)
            assert ("ci" in s["attrs"]) == (sched == "chunked")
        if s["name"].endswith((".prep", ".native")):
            assert by_id[s["parent"]]["name"] == s["name"].rsplit(".", 1)[0]
    if sched == "chunked":
        assert [s["attrs"]["ci"] for s in st.spans if s["name"] == "chunk"] \
            == list(range(st.n_chunks))
        assert st.counters["chunk.events"] == st.counters["engine.events"]


def root_thread(st) -> str:
    return next(s["thread"] for s in st.spans if s["parent"] is None)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_stage_seconds_are_the_sums_of_their_spans(recorded, sched):
    st, _ = recorded(f"stage_{sched}", **SCHEDULES[sched])
    span_of = {"load_reads": "chunk.wait_load"} if sched == "chunked" else {}
    for key, secs in st.stage_seconds.items():
        name = span_of.get(key, key)
        ns = sum(s["t1"] - s["t0"] for s in st.spans if s["name"] == name)
        assert secs == ns / 1e9, key
        assert ns == st.stage_ns[key]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_counters_count_what_they_say(recorded, sched, case):
    reads, paf, _ = case
    inputs = []
    st, prefix = recorded(
        f"count_{sched}", **SCHEDULES[sched],
        on_bucket=lambda cfg, *a: inputs.append(
            sum(t.element_size() * t.numel() for t in a)))
    for w, ext in FILES.items():
        assert st.counters[w + ".bytes"] == os.path.getsize(prefix + ext)
        assert st.counters[w + ".write_calls"] >= 1
        assert st.counters[w + ".shards"] >= 1
    assert st.counters["engine.buckets"] == len(st.buckets) == len(inputs)
    assert (st.counters["engine.gather.buckets"]
            == st.counters["engine.buckets"])
    assert st.counters["engine.gather.bytes"] == sum(inputs)
    # one table a compute: read offsets, two window columns, lengths
    n_computes = st.n_chunks if sched == "chunked" else 1
    assert st.counters["engine.table_bytes"] == (
        8 * (st.n_reads + n_computes) + 8 * st.counters["engine.events"]
        + 4 * st.n_reads)
    # and the gather's plan: each step's fields, each block's (step, first
    # row), each read's id, int64 all
    blocks = sum(-(-B // gather_cuda.ROWS) for B, _, _ in st.buckets)
    assert st.counters["engine.h2d_bytes"] == (
        st.counters["engine.table_bytes"]
        + 8 * (gather_cuda.NF * len(st.buckets) + 2 * blocks + st.n_reads))
    assert st.counters["engine.windows"] == st.total_windows
    assert st.counters["parse.reads"] == st.n_reads
    assert st.counters["parse.paf_rows"] == st.n_paf_rows
    assert st.counters["parse.fasta_bytes"] == os.path.getsize(reads)
    assert st.counters["parse.paf_bytes"] == os.path.getsize(paf)
    if sched == "whole":  # reserved from the start: the reads file's size
        assert (st.counters["emit.fasta.reserved_bytes"]
                == os.path.getsize(reads)
                >= st.total_read_length + st.n_reads)


def test_ul_counters_tie_to_the_outputs(ul_case, monkeypatch):
    """Ultra-long reads: every read in a wide bucket, so the
    ``engine.wide.*`` counters hold the whole pass; fragments, cut reads
    and repeats as the output files show them."""
    reads, paf, tmp = ul_case
    monkeypatch.setenv("RAFT_SPANS", "1")
    st = _run(reads, paf, tmp, "ul_count")
    c = st.counters
    steps = [s["attrs"] for s in st.spans if s["name"] == "engine.step"]
    assert steps and all(a["W"] > 2048 for a in steps)
    with open(f"{tmp}/ul_count.reads.fasta", "rb") as f:
        heads = [ln for ln in f if ln.startswith(b">")]
    with open(f"{tmp}/ul_count.long_repeats.txt", "rb") as f:
        # "read <i>, <start>,<end> <start>,<end> ..." a line
        n_rep = sum(len(ln.split(b", ", 1)[1].split()) for ln in f)
    per_read: dict = {}
    for h in heads:  # >read=<k>,<name>,pos_on_original_read=<a>-<b>
        name = h.split(b",")[1]
        per_read[name] = per_read.get(name, 0) + 1
    assert c["engine.fragments"] == len(heads) == c["engine.wide.fragments"]
    assert c["engine.cut_reads"] == sum(v > 1 for v in per_read.values())
    assert c["engine.cut_reads"] >= 5
    assert c["engine.repeats"] == n_rep == c["engine.wide.repeats"] > 0
    assert c["engine.wide.reads"] == st.n_reads
    assert c["engine.wide.windows"] == c["engine.windows"] == st.total_windows
    assert c["engine.wide.events"] == c["engine.events"]
    assert c["engine.wide.buckets"] == c["engine.buckets"] == len(steps)
    assert ({k for k in c if k.startswith("engine.wide.")}
            == {k for k in COUNTERS if k.startswith("engine.wide.")})


@pytest.mark.parametrize("kw", [{"chunk_reads": 9},
                                {"chunk_reads": 0, "gz_out": True}],
                         ids=["chunked", "whole_gz"])
def test_no_reservation_off_the_plain_whole_file(recorded, kw):
    """The chunked schedule (appends per chunk) and gz outputs write as
    before: no ``emit.reserve`` span, no reserved-bytes counter."""
    st, _ = recorded("noreserve_" + "_".join(map(str, kw.values())), **kw)
    assert not RESERVE & {s["name"] for s in st.spans}
    assert "emit.fasta.reserved_bytes" not in st.counters


RESERVE_STARTS = {"fasta": ({}, 1), "fastq": ({"fastq": True}, 0),
                  "gz": ({"gz": True}, 0), "nonempty": ({}, 0)}


@pytest.mark.parametrize("inp", RESERVE_STARTS)
def test_reservation_starts_with_the_pass_on_a_plain_fasta(tmp_path,
                                                           monkeypatch, inp):
    """Plain FASTA reads and an absent output: ``emit.reserve`` (``early``
    1) begins before ``load_reads`` ends and reserves the reads file's
    size. FASTQ or gz reads, or an output that holds bytes: ``early`` 0,
    from ``load_reads``' end, the bases and a newline a read."""
    mode, early = RESERVE_STARTS[inp]
    reads, paf = datagen.standard_case(seed=23, tmpdir=str(tmp_path),
                                       n_reads=30, **mode)
    if inp == "nonempty":
        (tmp_path / "r.reads.fasta").write_bytes(b">earlier run\nACGT\n")
    monkeypatch.setenv("RAFT_SPANS", "1")
    st = _run(reads, paf, str(tmp_path), "r", chunk_reads=0)
    res = [s for s in st.spans if s["name"] == "emit.reserve"]
    load = next(s for s in st.spans if s["name"] == "load_reads")
    assert len(res) == 1 and res[0]["attrs"] == {"early": early}
    if early:
        assert res[0]["t0"] < load["t1"]
    else:
        assert res[0]["t0"] >= load["t1"]
    assert st.counters["emit.fasta.reserved_bytes"] == (
        os.path.getsize(reads) if early
        else st.total_read_length + st.n_reads)


@pytest.fixture(scope="module")
def computed(case):
    """A simulated-read store and its result, for the native emitters."""
    reads, paf, tmp = case
    stats = port_pipeline.TorchRunStats()
    store, table = port_pipeline.load_inputs(reads, paf, stats)
    params = _params(tmp, "x").replace(real_reads=store.real_reads,
                                       symmetric_overlaps=table.symmetric)
    res = compute_torch(store, table, params, device="cpu")
    assert not store.real_reads and len(res.rep_s)
    return store, params, res


EMITTERS = {
    "fasta": lambda p, store, prm, res, gz: native.emit_frags_full(
        p, store, res, gz=gz),
    "coverage_events": lambda p, store, prm, res, gz:
        native.emit_coverage_events(p, res.cov_ev_w0, res.cov_ev_w1,
                                    res.cov_ev_off, res.cov_off,
                                    res.n_reads, prm.reso, gz=gz),
    "coverage": lambda p, store, prm, res, gz: native.emit_coverage(
        p, res.ensure_cov(), res.cov_off, res.n_reads, prm.reso, gz=gz),
    "repeats": lambda p, store, prm, res, gz: native.emit_repeats(
        p, res.rep_s, res.rep_e, res.rep_off, res.n_reads, gz=gz),
    "bed": lambda p, store, prm, res, gz: native.emit_bed(
        p, store, res, gz=gz),
}


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("shards", ["1", "4"])
@pytest.mark.parametrize("fn", EMITTERS)
def test_native_emitter_stats(computed, tmp_path, monkeypatch, fn, shards,
                              gz):
    """Each native emitter with and without its stats array: the same
    bytes; the counters only when asked, with time inside the writes."""
    monkeypatch.setenv("RAFT_EMIT_SHARDS", shards)
    file = fn.split("_")[0]
    off, on = str(tmp_path / "off"), str(tmp_path / "on")
    assert EMITTERS[fn](off, *computed, gz)
    with profiling.run(force=True) as rec:
        assert EMITTERS[fn](on, *computed, gz)
    with open(off, "rb") as f, open(on, "rb") as g:
        assert f.read() == g.read()
    c = {k.split(".", 2)[2]: v for k, v in rec.counters.items()}
    assert set(c) == set(native.EMIT_STATS)
    assert c["write_ns"] > 0 and c["write_calls"] >= 1
    assert c["render_ns"] > 0 and c["bytes"] == os.path.getsize(on)
    parallel = shards == "4" and not gz
    assert (c["count_ns"] > 0) == parallel
    assert c["shards"] == int(shards)
    assert [s["name"] for s in rec.spans] == [
        f"emit.{file}.prep", f"emit.{file}.native", "run_pipeline"]


@pytest.mark.parametrize("shards", ["1", "4"])
def test_reserved_emit_leaves_no_reserved_byte(computed, tmp_path,
                                               monkeypatch, shards):
    """The fragment FASTA written over a file reserved past its output,
    by the serial and the sharded emitter: an unreserved emit's bytes,
    and no reserved NUL after them."""
    monkeypatch.setenv("RAFT_EMIT_SHARDS", shards)
    store, _, res = computed
    plain, kept = str(tmp_path / "plain"), str(tmp_path / "kept")
    assert native.emit_frags_full(plain, store, res)
    with open(plain, "rb") as f:
        want = f.read()
    assert native.reserve(kept, 2 * len(want)) == 2 * len(want)
    assert os.path.getsize(kept) == 2 * len(want)
    assert native.emit_frags_full(kept, store, res, reserved=True)
    with open(kept, "rb") as f:
        assert f.read() == want


def test_reserve_engages_only_on_regular_files(tmp_path):
    """``reserve`` creates an absent file and allocates its range; a FIFO
    (opening it for writing would block), a link to one and a character
    device are never opened, and the native call refuses a FIFO without
    blocking either."""
    path = str(tmp_path / "new")
    assert native.reserve(path, 1 << 20) == 1 << 20
    assert os.path.getsize(path) == 1 << 20
    fifo, link = str(tmp_path / "fifo"), str(tmp_path / "link")
    os.mkfifo(fifo)
    os.symlink(fifo, link)
    out = []

    def go():
        out.extend(native.reserve(p, 4096) for p in (fifo, link, os.devnull))
        out.append(native._get_lib().raftio_reserve(fifo.encode(), 4096))
    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert out[:3] == [0, 0, 0] and out[3] < 0


def test_chunk_trace_values_are_span_durations(case, monkeypatch):
    reads, paf, tmp = case
    trace = f"{tmp}/chunks.jsonl"
    monkeypatch.delenv("RAFT_SPANS", raising=False)
    monkeypatch.setenv("RAFT_CHUNK_TRACE", trace)
    st = _run(reads, paf, tmp, "ctrace", chunk_reads=9)
    with open(trace) as f:
        recs = [json.loads(line) for line in f]
    tail = recs.pop()
    assert len(recs) == st.n_chunks > 1 and tail["n_chunks"] == st.n_chunks
    by_id = {s["id"]: s for s in st.spans}
    loop = next(s for s in st.spans if s["name"] == "chunks")

    def sec(s):
        return round((s["t1"] - s["t0"]) / 1e9, 3)

    def at(s):
        return [round((s["t0"] - loop["t0"]) / 1e9, 3),
                round((s["t1"] - loop["t0"]) / 1e9, 3)]

    assert tail["total_wall_s"] == sec(loop)
    assert tail["stage_seconds"] == {k: round(v, 3) for k, v in
                                     st.stage_seconds.items()}
    for s in st.spans:
        ci = s["attrs"].get("ci")
        if ci is None:
            continue
        r = recs[ci]
        if s["name"] == "chunk":
            assert r["n_events"] == s["attrs"]["n_events"]
        elif s["name"] == "chunk.load":
            assert r["load_span"] == at(s)
        elif s["name"] in WRITERS:
            key = {"emit.fasta": "emit_fasta", "emit.repeats": "emit_lr",
                   "emit.bed": "emit_bed",
                   "emit.coverage": "emit_cov"}[s["name"]]
            assert r[key + "_s"] == sec(s) and r[key + "_span"] == at(s)
    for s in st.spans:
        p = by_id.get(s["parent"])
        if p is None or p["name"] not in ("chunk", "chunk.load"):
            continue
        r = recs[p["attrs"]["ci"]]
        key = {"chunk.wait_load": "wait_load_s", "chunk.drain": "drain_s",
               "compute": "compute_s", "chunk.load.read": "load_read_s",
               "chunk.load.events": "load_events_s"}.get(s["name"])
        if key is None:  # work this chunk started: the next load, writers
            assert s["name"] == "chunk.load" or s["name"] in WRITERS
            continue
        assert r[key] == sec(s)
        if s["name"] == "compute":
            assert r["compute_span"] == at(s)
            eng = {}
            for e in st.spans:
                if e["parent"] == s["id"] and e["name"].startswith("engine."):
                    k = e["name"].split(".", 1)[1]
                    eng[k] = eng.get(k, 0) + e["t1"] - e["t0"]
            assert r["engine"] == {k: round(v / 1e9, 3)
                                   for k, v in eng.items()}


def test_trace_dir_holds_the_host_spans(case, tmp_path, monkeypatch):
    """``profiling.trace`` (the CLI's ``--trace DIR``) records without
    RAFT_SPANS and writes every span as a ``raft_span`` event: the root
    span over its anchor annotation, every other span inside the
    annotation (give or take the anchor's error, half the call that opened
    the annotation: under a millisecond)."""
    reads, paf, tmp = case
    monkeypatch.delenv("RAFT_SPANS", raising=False)
    out = str(tmp_path / "tr")
    with profiling.trace(out, "cpu"):
        st = _run(reads, paf, tmp, "traced", chunk_reads=0)
    assert profiling.profiled_runs()[-1].spans is st.spans
    with open(os.path.join(out, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CAT]
    assert len(spans) == len(st.spans) > 0
    anchor = next(e for e in events if e.get("ph") == "X"
                  and e["name"] == profiling.ANCHOR)
    root = next(e for e in spans if e["name"] == "run_pipeline")
    assert root["ts"] <= anchor["ts"] <= root["ts"] + root["dur"]
    lo, hi = anchor["ts"] - 1e3, anchor["ts"] + anchor["dur"] + 1e3
    out = [e for e in spans if e is not root
           and (e["ts"] < lo or e["ts"] + e["dur"] > hi)]
    assert not out, (lo, hi, out)
    assert {e["args"]["name"] for e in events if e.get("ph") == "M"
            and e["tid"] >= profiling.TRACK_BASE} == {
        f"raft spans: {s['thread']}" for s in st.spans}


def test_anchor_maps_spans_exactly():
    """``trace_events`` shifts every span by the anchor's offset, and
    keeps each span's duration, attributes, id and parent."""
    rec = profiling.Recording()
    rec.anchor_ns = 5_000_000
    rec.spans = [
        {"id": 1, "parent": None, "name": "run_pipeline",
         "thread": "MainThread", "t0": 4_000_000, "t1": 9_000_000,
         "attrs": {}},
        {"id": 2, "parent": 1, "name": "emit.fasta", "thread": "pool_0",
         "t0": 6_000_000, "t1": 8_500_000, "attrs": {"ci": 3}}]
    ev = profiling.trace_events(rec, anchor_us=100.0, pid=7)
    x = [e for e in ev if e["ph"] == "X"]
    assert [(e["ts"], e["dur"]) for e in x] == [(-900.0, 5000.0),
                                                (1100.0, 2500.0)]
    assert x[1]["args"] == {"ci": 3, "id": 2, "parent": 1}
    assert x[0]["tid"] != x[1]["tid"] and {e["pid"] for e in ev} == {7}


def test_work_handed_to_a_pool_keeps_its_parent():
    """A worker's spans hang under the span that submitted the work; the
    worker's thread leaves the run's recording when the work is done."""
    import concurrent.futures as cf

    def work():
        with profiling.span("inner"):
            return profiling.recording()

    with profiling.run(force=True) as rec:
        with profiling.span("submitter"):
            fn = profiling.bind(work, "work")
        with cf.ThreadPoolExecutor(1) as ex:
            assert ex.submit(fn).result() is rec
            assert ex.submit(profiling.recording).result() is None
    by_name = {s["name"]: s for s in rec.spans}
    assert by_name["work"]["parent"] == by_name["submitter"]["id"]
    assert by_name["inner"]["parent"] == by_name["work"]["id"]
    assert by_name["work"]["thread"] != by_name["submitter"]["thread"]
    assert np.all([s["t0"] <= s["t1"] for s in rec.spans])


def test_threads_lose_no_span_or_count():
    """More workers than cores, switching often, all recording into one
    run: every span and every count arrives."""
    import concurrent.futures as cf
    import sys
    workers, per = 4 * (os.cpu_count() or 1), 200

    def work(i):
        for _ in range(per):
            with profiling.span("w", i=i):
                profiling.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.run(force=True) as rec:
            with cf.ThreadPoolExecutor(workers) as ex:
                futs = [ex.submit(profiling.bind(work), i)
                        for i in range(workers)]
                done, pending = cf.wait(futs, timeout=120)
                assert not pending
                for f in done:
                    f.result()
    finally:
        sys.setswitchinterval(old)
    assert rec.counters["n"] == workers * per
    spans = [s for s in rec.spans if s["name"] == "w"]
    assert len(spans) == workers * per
    assert len({s["id"] for s in rec.spans}) == len(rec.spans)
