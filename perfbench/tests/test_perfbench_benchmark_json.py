"""``BENCHMARK.json`` within its allowed shape and characters, and
every name it uses found as a file under ``perfbench/``."""

import json
import os
import re

import pytest

from perfbench import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
LINE = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    harness.validate(BENCH)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
    assert c["file"].startswith("perfbench/configs/")
    with open(os.path.join(harness.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16
    assert all(NAME.fullmatch(k) and k in cfg for k in c["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and LINE.fullmatch(w["why"])
    cell = harness.find_cell(w["name"])
    assert LINE.fullmatch(cell.traffic["why"])
    assert cell.traffic["n_reads"] > 0
    assert {"schedule", "n_chunks"} <= set(cell.traffic["expect"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_cells_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert LINE.fullmatch(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(harness.metric_reader(m["name"]))
