"""A cell added from files alone: a traffic file under ``perfbench/traffic``
and an entry in ``BENCHMARK.json``, with the traffic's own overrides of the
configuration and compressed inputs; and the run's refusal to print a
result once its process holds JAX or the JAX package."""

import json
import sys
import types

import pytest

from perfbench import control, harness, run
from perfbench.tests.conftest import LONG_READS, root_with, run_small


def new_root(tmp_path, traffic: dict) -> str:
    """A checkout's benchmark files plus one traffic file and its cell."""
    return root_with(tmp_path, [{"name": "hifi30x.added",
                                 "config": "hifi_human_30x",
                                 "traffic": "added", "chips": 1,
                                 "why": "a cell from files alone"}],
                     traffic={"added": traffic})


@pytest.mark.parametrize("fmt,magic", [("gzip", b"\x1f\x8b\x08\x00"),
                                       ("bgzf", b"\x1f\x8b\x08\x04")])
def test_cell_from_files_alone(fmt, magic, tmp_path):
    root = new_root(tmp_path, {
        "why": "gzip inputs and long reads", "n_reads": 300,
        "inputs": fmt, "config": LONG_READS,
        "expect": {"schedule": "whole", "n_chunks": 1}})
    cell = harness.find_cell("hifi30x.added", root)
    assert cell.config["read_length"] == LONG_READS["read_length"]
    assert cell.config["coverage"] == 30
    handed = []
    program = harness.program_pass("cpu")

    def pass_fn(reads, paf, params):
        for p in (reads, paf):
            with open(p, "rb") as f:
                handed.append((p, f.read(4)))
        return program(reads, paf, params)

    out = run_small(cell, 41, pass_fn=pass_fn, root=root)
    assert out.result["correct"], out.result["checks"]
    assert handed and all(p.endswith(".gz") and m == magic
                          for p, m in handed)
    assert any(f"inputs={fmt}" in line for line in out.info)


def test_traffic_may_not_invent_config_keys(tmp_path):
    root = new_root(tmp_path, {"why": "a typo", "n_reads": 300,
                               "config": {"read_lenght": {}},
                               "expect": {"schedule": "whole",
                                          "n_chunks": 1}})
    with pytest.raises(ValueError, match="read_lenght"):
        harness.find_cell("hifi30x.added", root)


def fake_outcome():
    return harness.Outcome({"correct": True, "attempted": 1, "failed": 0,
                            "metrics": {}, "device": {},
                            "checks": {"failed_passes": {"value": 0,
                                                         "limit": 0}}},
                           ["info"], [("failed_passes", 0, 0)])


@pytest.fixture
def card_faked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: fake_outcome())
    for m in list(sys.modules):
        if m.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)


@pytest.mark.parametrize("loaded", [None, "jax", "raft_tpu.cli", "flax"])
def test_result_only_without_jax(loaded, card_faked, monkeypatch, capsys):
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    args = ["--workload", "hifi30x.whole", "--seed", "1", "--seconds", "1"]
    rc = run.main(args + ["--trace", "0"])
    out, err = capsys.readouterr()
    if loaded:
        assert rc != 0 and '"correct"' not in out
        assert loaded.split(".")[0] in err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]
    monkeypatch.setattr(control, "control_pass", lambda cell, seed: None)
    rc = control.main(args[:2] + ["--seeds", "1"])
    out, _ = capsys.readouterr()
    assert (rc != 0 and '"correct"' not in out) if loaded else rc == 0
