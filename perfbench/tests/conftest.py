"""Shared helpers of the benchmark's CPU tests: small cells, run on the
CPU (``device="cpu"``) at a few hundred reads."""

import copy
import json
import os
import shutil
import time

import pytest

from perfbench import harness


# long reads (most cut into fragments), to drive the chop at test size
LONG_READS = {"read_length": {"dist": "lognormal", "median": 25000,
                              "sigma": 0.6, "min": 1000}}


def small_cell(name: str, n_reads: int, root: str = harness.ROOT,
               **config) -> harness.Cell:
    cell = harness.find_cell(name, root)
    cell.config = {**cell.config, **config}
    cell.traffic = {**cell.traffic, "n_reads": n_reads}
    return cell


def run_small(cell: harness.Cell, seed: int, pass_fn=None, trace=False,
              seconds: float = 0.5, root: str = harness.ROOT
              ) -> harness.Outcome:
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", pass_fn=pass_fn, root=root)


def root_with(tmp_path, workloads=(), per_layer=(), traffic=None) -> str:
    """A checkout's benchmark files with cells and per-layer metrics added
    to its ``BENCHMARK.json`` and, optionally, traffic files
    (``{name: mix}``): what a later PR adds to bring in a cell."""
    root = tmp_path / "checkout"
    for d in ("configs", "metrics", "traffic"):
        shutil.copytree(os.path.join(harness.ROOT, "perfbench", d),
                        root / "perfbench" / d)
    for name, mix in (traffic or {}).items():
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench = copy.deepcopy(
        harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")))
    bench["workloads"] += list(workloads)
    bench["per_layer"] += list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


# the streaming cell, out of BENCHMARK.json until its throughput is steady:
# its traffic file and schedule readers stay, and come back as entries
STREAM_CELL = {"name": "hifi30x.stream", "config": "hifi_human_30x",
               "traffic": "stream_128k", "chips": 1,
               "why": "131,072 HiFi reads over the 2 GB threshold: the "
                      "program streams 4 chunks of 32,768"}
STREAM_METRICS = [{"name": f"stream.{n}_s_per_gbp", "unit": "s/Gbp",
                   "better": "lower", "source": "program_span",
                   "layer": "schedule", "moves": "mbp_per_s",
                   "workloads": ["hifi30x.stream"]}
                  for n in ("prelude", "drain", "load_wait")]
# the per-layer metrics it shares with the whole-file cell
STREAM_SHARED = ("engine.s_per_gbp", "device.idle_pct", "device_step_roofline")


@pytest.fixture
def stream_small(tmp_path, monkeypatch):
    """The streaming cell at test size, added from its entries alone, with
    the program's own threshold made small so that it streams. Returns
    the cell and its checkout's root."""
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    root = root_with(tmp_path, [STREAM_CELL], STREAM_METRICS)
    path = os.path.join(root, "BENCHMARK.json")
    bench = harness.load_json(path)
    for m in bench["per_layer"]:
        if m["name"] in STREAM_SHARED:
            m["workloads"].append(STREAM_CELL["name"])
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = small_cell("hifi30x.stream", 600, root)
    cell.traffic["expect"] = {"schedule": "chunked", "n_chunks": 1}
    return cell, root
