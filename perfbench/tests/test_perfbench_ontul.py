"""The corrected ultra-long ONT cell, ``ontul30x.whole``, on the CPU at
test size: built from its files alone (a configuration, a traffic file and
the entries in ``BENCHMARK.json``), its reads at the configuration's
lengths fill a bucket wider than 2,048 windows; the program is
``correct`` there and the int8 control is not; and every per-layer metric
that lists the cell finds what it reads in a pass of the program over the
cell's data."""

import types

import pytest

from perfbench import control, gen, harness, reference
from perfbench.tests.conftest import run_small, small_cell

CELL = "ontul30x.whole"
# at 160 reads the slice caps reads at about 210 kb: the longest tier is
# 8,192 windows, and every tier merges into it (fewer than 256 reads)
N_READS = 160


def checks(out):
    return {k: v["value"] for k, v in out.result["checks"].items()}


def test_cell_from_its_files():
    cell = harness.find_cell(CELL)
    assert cell.config["name"] == "ont_ul_human_30x"
    assert cell.config["read_length"] == {"dist": "lognormal",
                                          "median": 62000, "sigma": 0.70,
                                          "min": 1000}
    assert cell.config["read_names"] == "ont_duplex"
    hifi = harness.find_cell("hifi30x.whole").config
    for k in ("coverage", "repeats", "min_overlap", "paf_noise",
              "raft_flags", "genome_size", "reduced", "guarantees"):
        assert cell.config[k] == hifi[k], k
    assert set(hifi) - set(cell.config) == {"movies"}
    assert cell.traffic["n_reads"] == 8192
    assert cell.traffic["expect"] == {"schedule": "whole", "n_chunks": 1}
    assert ([m["name"] for m in cell.per_layer]
            == [m["name"] for m in harness.find_cell("hifi30x.whole")
                .per_layer])
    assert {m["name"] for m in cell.end_to_end} == {"mbp_per_s",
                                                   "peak_rss_mb", "setup_s"}


def test_lengths_at_the_cells_size():
    """The configuration's lengths at 8,192 reads: N50 over 100 kb and a
    longest read under 1 Mbp, as the ultra-long protocol's figures."""
    cfg = harness.find_cell(CELL).config
    lens = sorted(gen.read_lengths(cfg, 8192), reverse=True)
    half, acc = sum(lens) / 2, 0
    for n50 in lens:
        acc += n50
        if acc >= half:
            break
    assert 100_000 < n50 < 105_000
    assert 882_000 <= lens[0] < 1_000_000


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_program_is_correct_in_a_wide_bucket(seed, monkeypatch):
    from raft_tpu_torch import pipeline
    monkeypatch.setenv("RAFT_SPANS", "1")
    stats = []

    def pass_fn(reads, paf, params):
        st = pipeline.run_pipeline(reads, paf, params, device="cpu",
                                   verbose=False)
        stats.append(st)
        return st

    out = run_small(small_cell(CELL, N_READS), seed, pass_fn=pass_fn)
    assert out.result["correct"], checks(out)
    assert out.result["failed"] == 0
    st = stats[-1]
    widths = [s["attrs"]["W"] for s in st.spans if s["name"] == "engine.step"]
    assert widths and max(widths) > 2048
    c = st.counters
    assert c["engine.wide.reads"] == N_READS
    assert c["engine.wide.fragments"] == c["engine.fragments"]
    assert c["engine.cut_reads"] > N_READS // 2


@pytest.mark.parametrize("seed", [4, 2**33 + 1])
def test_control_is_not_correct(seed):
    # families of 10 copies, so that coverage passes 127 at test size as
    # it does at the cell's size
    cell = small_cell(CELL, N_READS,
                      repeats={"share": 0.06, "unit_min": 10000,
                               "unit_max": 50000, "copies_min": 10,
                               "copies_max": 10})
    out = run_small(cell, seed, pass_fn=control.control_pass(cell, seed))
    c = checks(out)
    assert not out.result["correct"]
    assert c["coverage_txt_bad_passes"] == out.result["attempted"] > 0


@pytest.fixture(scope="module")
def recorded_pass():
    """One recorded pass of the program over the cell's data at test
    size: its ``TorchRunStats``."""
    from raft_tpu_torch import pipeline
    stats = []

    def pass_fn(reads, paf, params):
        st = pipeline.run_pipeline(reads, paf, params, device="cpu",
                                   verbose=False)
        stats.append(st)
        return st

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_SPANS", "1")
        out = run_small(small_cell(CELL, N_READS), 5, pass_fn=pass_fn)
    assert out.result["correct"], checks(out)
    return stats[-1]


@pytest.mark.parametrize(
    "name", [m["name"] for m in harness.find_cell(CELL).per_layer])
def test_layer_metric_reads_the_cells_pass(name, recorded_pass,
                                           monkeypatch):
    """What a traced run of the cell gives each reader, with the pass's
    own recording as the profiled pass's and a stand-in device summary
    (the CPU has no device trace): every metric that lists the cell
    reads a number there."""
    from raft_tpu_torch import profiling
    st = recorded_pass
    rec = types.SimpleNamespace(spans=st.spans, counters=st.counters)
    monkeypatch.setattr(profiling, "profiled_runs", lambda: [rec])
    wall = max(s["t1"] - s["t0"] for s in st.spans if s["parent"] is None)
    c = st.counters
    t = harness.TraceData(
        passes=[harness.stats_record(st)],
        gbp=st.total_read_length / 1e9,
        profile={"window_s": 2 * wall / 1e9, "busy_s": 1e-4,
                 "kernel_s": 5e-5},
        work=reference.Work(st.n_reads, c["engine.events"],
                            c["engine.windows"], c["engine.repeats"],
                            c["engine.fragments"]))
    got = harness.metric_reader(name)(t)
    assert got is not None and got > 0, name
