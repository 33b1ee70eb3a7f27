"""The per-layer readers of the program's host spans and counters
(``perfbench/spans.py``): values from the profiled pass's recording, and
None without one (off the card, a program without the recorder, or a
recording that is not the profiled pass's)."""

import time
import types

import pytest

from perfbench import harness

READERS = ("emit.fasta_s_per_gbp", "emit.syscall_s_per_gbp",
           "engine.prep_s_per_gbp", "engine.integrate_s_per_gbp")
GBP = 0.5


def span(name, t0, t1, parent=1, sid=None):
    return {"id": sid, "parent": parent, "name": name, "thread": "t",
            "t0": t0, "t1": t1, "attrs": {}}


RECORDING = types.SimpleNamespace(
    spans=[span("engine.events", 0, 10_000_000),
           span("engine.cov_events", 10_000_000, 30_000_000),
           span("engine.bucket_prep", 30_000_000, 35_000_000),
           span("engine.bucket_prep", 40_000_000, 45_000_000),
           span("engine.integrate", 50_000_000, 90_000_000),
           span("emit.fasta", 100_000_000, 700_000_000),
           span("emit.fasta.native", 110_000_000, 690_000_000),
           span("run_pipeline", 0, 1_000_000_000, parent=None, sid=1)],
    counters={"emit.fasta.write_ns": 200_000_000,
              "emit.coverage.write_ns": 50_000_000,
              "emit.repeats.write_ns": 1_000_000,
              "emit.bed.write_ns": 0,
              "emit.fasta.render_ns": 300_000_000})
# seconds per pass over GBP
WANT = {"emit.fasta_s_per_gbp": 0.6 / GBP,
        "emit.syscall_s_per_gbp": 0.251 / GBP,
        "engine.prep_s_per_gbp": 0.04 / GBP,
        "engine.integrate_s_per_gbp": 0.04 / GBP}


def data(profile=True):
    return harness.TraceData(
        passes=[{"stage_seconds": {"emit": 0.8}, "schedule": "whole"}],
        gbp=GBP, profile={"window_s": 1.2} if profile else None, work=None)


@pytest.fixture
def runs(monkeypatch):
    from raft_tpu_torch import profiling
    kept = []
    monkeypatch.setattr(profiling, "profiled_runs", lambda: list(kept))
    return kept


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_profiled_pass(name, runs):
    runs.append(RECORDING)
    assert harness.metric_reader(name)(data()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing(name, runs, monkeypatch):
    read = harness.metric_reader(name)
    assert read(data()) is None                  # no profiled run
    runs.append(RECORDING)
    assert read(data(profile=False)) is None     # off the card
    long = types.SimpleNamespace(spans=[span("run_pipeline", 0, 2e9, None)]
                                 + RECORDING.spans[:-1],
                                 counters=RECORDING.counters)
    runs[:] = [long]
    assert read(data()) is None                  # not the profiled pass
    empty = types.SimpleNamespace(spans=RECORDING.spans[-1:], counters={})
    runs[:] = [empty]
    assert read(data()) is None                  # nothing of its own
    from raft_tpu_torch import profiling
    monkeypatch.delattr(profiling, "profiled_runs")
    assert read(data()) is None                  # a program without it


def test_readers_on_a_profiled_program_pass(tmp_path, monkeypatch):
    """One pass of the program on the CPU under ``torch.profiler``, as the
    traced run's profiled pass is on the card: every reader reads it, the
    writer's span inside the ``emit`` stage's wall."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.tests.conftest import small_cell
    monkeypatch.delenv("RAFT_SPANS", raising=False)
    cell = small_cell("hifi30x.whole", 300)
    from perfbench import gen
    ds = gen.make_dataset(cell.config, cell.traffic, 11)
    reads, paf = str(tmp_path / "r.fasta"), str(tmp_path / "o.paf")
    with open(reads, "w+b") as f:
        gen.render_fasta(ds, f.fileno())
    with open(paf, "wb") as f:
        gen.render_paf(ds, f.fileno())
    params = harness.algo_params(cell.config, ds.est_cov,
                                 str(tmp_path / "out"))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        rec = harness.stats_record(
            harness.program_pass("cpu")(reads, paf, params))
    t = harness.TraceData(passes=[rec], gbp=ds.total_bases / 1e9,
                          profile={"window_s": time.perf_counter() - t0},
                          work=None)
    got = {n: harness.metric_reader(n)(t) for n in READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["emit.fasta_s_per_gbp"] > 0
    assert got["emit.fasta_s_per_gbp"] * t.gbp <= (
        rec["stage_seconds"]["emit"] + rec["stage_seconds"]["compute"])
