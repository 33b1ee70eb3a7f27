"""``correct`` on the CPU at test size: true for the program on every
cell's path; false for the control (the reference put in the program's
place with coverage in int8) and for each fault a cell can have, planted
under the harness's timed path: a pass that leaves its outputs as they
were, half of the PAF rows left out, and an answer altered where the
program produces it. (One chip per cell: no exchange between chips.)"""

import os

import pytest

from perfbench import control
from perfbench.tests.conftest import LONG_READS, run_small, small_cell


def checks(out):
    return {k: v["value"] for k, v in out.result["checks"].items()}


@pytest.mark.parametrize("variant", [{}, LONG_READS], ids=["hifi", "long"])
def test_program_is_correct(variant):
    out = run_small(small_cell("hifi30x.whole", 400, **variant), 2**31 + 1)
    assert out.result["correct"], checks(out)
    assert out.result["attempted"] >= 1 and out.result["failed"] == 0
    assert set(out.result["metrics"]) == {"mbp_per_s", "peak_rss_mb",
                                          "setup_s"}
    assert list(out.result)[-1] == "checks"


def test_program_is_correct_streaming(stream_small):
    cell, root = stream_small
    out = run_small(cell, 77, trace=True, root=root)
    assert out.result["correct"], checks(out)
    assert set(out.result["metrics"]) == {
        "engine.s_per_gbp", "stream.prelude_s_per_gbp",
        "stream.drain_s_per_gbp", "stream.load_wait_s_per_gbp"}


def test_traced_whole_reports_the_host_layers():
    out = run_small(small_cell("hifi30x.whole", 300), 5, trace=True)
    assert out.result["correct"]
    assert set(out.result["metrics"]) == {
        "parse.s_per_gbp", "engine.s_per_gbp", "emit.s_per_gbp"}


@pytest.mark.parametrize("seed", [4, 2**31 + 9, 12345678901])
def test_control_is_not_correct(seed):
    # families of 10 copies, so that coverage passes 127 at test size as
    # it does in every cell at full size
    cell = small_cell("hifi30x.whole", 600,
                      repeats={"share": 0.06, "unit_min": 10000,
                               "unit_max": 50000, "copies_min": 10,
                               "copies_max": 10})
    out = run_small(cell, seed, pass_fn=control.control_pass(cell, seed))
    c = checks(out)
    assert not out.result["correct"]
    assert c["coverage_txt_bad_passes"] == out.result["attempted"] > 0
    assert c["reads_fasta_bad_passes"] == 0


def program(device="cpu"):
    from raft_tpu_torch import pipeline

    def run(reads, paf, params):
        return pipeline.run_pipeline(reads, paf, params, device=device,
                                     verbose=False)
    return run


def test_fault_outputs_left_unchanged():
    out = run_small(small_cell("hifi30x.whole", 300), 6,
                    pass_fn=lambda reads, paf, params: None)
    assert not out.result["correct"]
    assert checks(out)["reads_fasta_bad_passes"] > 0


def test_fault_half_the_rows_left_out(tmp_path):
    run = program()
    half = {}

    def pass_fn(reads, paf, params):
        if not half:
            with open(paf, "rb") as f:
                rows = f.read().split(b"\n")[:-1]
            p = tmp_path / "half.paf"
            p.write_bytes(b"\n".join(rows[::2]) + b"\n")
            half["path"] = str(p)
        return run(reads, half["path"], params)

    out = run_small(small_cell("hifi30x.whole", 300, **LONG_READS), 7,
                    pass_fn=pass_fn)
    assert not out.result["correct"]
    assert checks(out)["coverage_txt_bad_passes"] > 0


def one_changed(arr):
    arr[len(arr) // 2] += 1


@pytest.mark.parametrize("field", ["rep_e", "frag_char_len", "cov_ev_w1"])
def test_fault_answer_altered_where_produced(field, monkeypatch):
    # the coverage file is written from the binned events that the engine
    # hands over before its device work (``on_cov_events``)
    from raft_tpu_torch import pipeline
    real = pipeline.compute_torch

    def altered(*a, **k):
        if field.startswith("cov_"):
            hand_over = k["on_cov_events"]

            def on_cov(early):
                one_changed(getattr(early, field))
                hand_over(early)
            k["on_cov_events"] = on_cov
            return real(*a, **k)
        res = real(*a, **k)
        one_changed(getattr(res, field))
        return res

    monkeypatch.setattr(pipeline, "compute_torch", altered)
    out = run_small(small_cell("hifi30x.whole", 400), 8)
    assert not out.result["correct"]
    assert out.result["failed"] == out.result["attempted"]


def test_schedule_other_than_expected_is_not_correct(stream_small):
    cell, root = stream_small
    cell.traffic["expect"] = {"schedule": "chunked", "n_chunks": 2}
    out = run_small(cell, 3, root=root)
    assert not out.result["correct"]
    assert checks(out)["schedule_bad_passes"] > 0


def test_nothing_left_on_disk(tmp_path, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = run_small(small_cell("hifi30x.whole", 300), 10)
    assert out.result["correct"]
    assert os.listdir(tmp_path) == []


def test_pass_that_raises_counts_once():
    calls = []

    def boom(reads, paf, params):
        calls.append(params)
        if len(calls) > 1:  # the warm pass passes, the first timed one fails
            raise RuntimeError("planted")

    out = run_small(small_cell("hifi30x.whole", 300), 12, pass_fn=boom)
    assert not out.result["correct"]
    assert out.result["failed"] == 1 and out.result["attempted"] == 1
