"""Multi-host runs of the torch port (``raft_tpu_torch.parallel.distributed``)
on the CPU: the planning helpers against ``raft_tpu``'s, per-host shards
simulated in one process, and real multi-process ``run_distributed`` runs
over gloo on 127.0.0.1. Outputs are compared as bytes against
``raft_tpu``'s single-host run: the tolerance is exact equality."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import datagen  # noqa: E402
from raft_tpu import cli as tpu_cli  # noqa: E402
from raft_tpu.io import native  # noqa: E402
from raft_tpu.io.fasta import load_reads  # noqa: E402
from raft_tpu.io.paf import load_paf  # noqa: E402
from raft_tpu.parallel import distributed as jdist  # noqa: E402
from raft_tpu_torch.cli import parse_args  # noqa: E402
from raft_tpu_torch.engine_torch import compute_torch  # noqa: E402
from raft_tpu_torch.parallel import distributed as dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]
ARGS = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000", "-f", "300",
        "-v", "200"]


def test_shard_ranges():
    assert dist.shard_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert dist.shard_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert dist.fragment_offsets([5, 3, 2]) == [0, 5, 8]


def test_bin_ranges():
    """bin_ranges tiles [0, n) contiguously and aligns with the native PAF
    binner's floor(id/chunk) bins (range h == bin h)."""
    for n, H in [(10, 3), (2, 4), (24, 2), (0, 2), (7, 7), (100, 1)]:
        chunk, ranges = dist.bin_ranges(n, H)
        assert len(ranges) == H
        lo_prev = 0
        for h, (lo, hi) in enumerate(ranges):
            assert lo == lo_prev and lo <= hi
            for rid in range(lo, hi):
                assert rid // chunk == h
            lo_prev = hi
        assert lo_prev == n


@pytest.mark.parametrize("n,H", [(10, 3), (2, 4), (24, 2), (0, 2), (7, 7),
                                 (100, 1), (9, 4), (1, 5), (1000, 6)])
def test_planning_helpers_equal_raft_tpu(n, H):
    assert dist.shard_ranges(n, H) == jdist.shard_ranges(n, H)
    assert dist.bin_ranges(n, H) == jdist.bin_ranges(n, H)
    counts = [(n * 7 + h * 13) % 11 for h in range(H)]
    assert dist.fragment_offsets(counts) == jdist.fragment_offsets(counts)
    for h in range(H):
        assert (dist.shard_path("d/out", ".coverage.txt", h, H)
                == jdist.shard_path("d/out", ".coverage.txt", h, H))


@pytest.mark.parametrize("n_hosts", [2, 3])
@pytest.mark.parametrize("simulated", [False, True])
def test_sharded_emit_equals_single(tmp_path, n_hosts, simulated):
    """Per-host slices computed on the torch engine, emitted as shards with
    global numbering offsets and concatenated: byte-equal to raft_tpu's
    single-host run."""
    tmp = str(tmp_path)
    reads_path, paf_path = datagen.standard_case(
        seed=2024 + n_hosts, tmpdir=tmp, n_reads=30, simulated=simulated)
    assert tpu_cli.main([*ARGS, "-o", f"{tmp}/single", reads_path,
                         paf_path]) == 0

    params = parse_args([*ARGS, "-o", f"{tmp}/multi", reads_path,
                         paf_path])[0]
    store = load_reads(reads_path)
    table = load_paf(paf_path, store)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    results = []
    for lo, hi in dist.shard_ranges(store.n_reads, n_hosts):
        sub_store = dist._slice_store(store, lo, hi)
        sub_table = dist._slice_table(table, lo, hi)
        res = compute_torch(sub_store, sub_table, params, strict=False)
        results.append((lo, sub_store, res))
    offsets = dist.fragment_offsets([r.n_frags for _, _, r in results])
    for h, (lo, sub_store, res) in enumerate(results):
        dist.emit_host_shard(f"{tmp}/multi", sub_store, params, res,
                             host=h, n_hosts=n_hosts,
                             first_read_num=offsets[h] + 1,
                             first_read_index=lo)
    for ext in OUTS:
        dist.concat_shards(f"{tmp}/multi", ext, n_hosts, remove=True)
        assert ((tmp_path / f"multi{ext}").read_bytes()
                == (tmp_path / f"single{ext}").read_bytes()), ext
    assert not [p for p in os.listdir(tmp) if ".shard-" in p]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# One rank of a real run: run_distributed on the CPU, then the rank, its
# pileup launch count (0: CPU tensors never launch the kernel) and
# whether jax was imported. ``wholeparse`` hides the native index, so the
# run takes the whole-parse fallback.
_WORKER = """\
import sys
from raft_tpu.io import native
from raft_tpu_torch.cli import parse_args
from raft_tpu_torch.ops import pileup_cuda
from raft_tpu_torch.parallel import run_distributed
if {wholeparse}:
    native.index_reads = lambda path: None
params = parse_args({args!r})[0]
run_distributed({reads!r}, {paf!r}, params, coordinator={coord!r},
                num_processes={n}, process_id={pid}, device="cpu")
print("RANK", {pid}, "LAUNCHES", pileup_cuda.launches,
      "JAX", "jax" in sys.modules)
"""


def _run_ranks(tmp_path, reads, paf, n_proc, wholeparse=False):
    """Start n_proc ranks, wait for all (killing every rank if one hangs),
    and require each to exit 0."""
    native._get_lib()  # build the native library before the ranks load it
    coord = f"127.0.0.1:{_free_port()}"
    args = [*ARGS, "-o", str(tmp_path / "multi"), reads, paf]
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.format(
            wholeparse=wholeparse, args=args, reads=reads, paf=paf,
            coord=coord, n=n_proc, pid=pid)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
        assert out.splitlines()[-1] == f"RANK {pid} LAUNCHES 0 JAX False"


def _assert_equals_single(tmp_path, reads, paf):
    assert tpu_cli.main([*ARGS, "-o", str(tmp_path / "single"), reads,
                         paf]) == 0
    for ext in OUTS:
        assert ((tmp_path / f"multi{ext}").read_bytes()
                == (tmp_path / f"single{ext}").read_bytes()), ext
    assert not [p for p in os.listdir(tmp_path) if ".shard-" in p]


@pytest.mark.parametrize("mode", ["real", "simulated", "wholeparse"])
def test_two_process_gloo_run_equals_single_host(tmp_path, mode):
    """Two real processes over gloo: the shards that rank 0 concatenates
    are byte-equal to raft_tpu.cli's single-host outputs, through the
    byte-range ingest and through the whole-parse fallback."""
    reads, paf = datagen.standard_case(seed=777, tmpdir=str(tmp_path),
                                       n_reads=24,
                                       simulated=mode == "simulated")
    _run_ranks(tmp_path, reads, paf, 2, wholeparse=mode == "wholeparse")
    _assert_equals_single(tmp_path, reads, paf)


@pytest.mark.slow
def test_four_process_uneven_empty_shard(tmp_path):
    """9 reads over 4 ranks: ranges (0,3), (3,6), (6,9), (9,9), so the last
    rank owns no read and still emits empty shards and joins both
    collectives."""
    reads, paf = datagen.standard_case(seed=4242, tmpdir=str(tmp_path),
                                       n_reads=9)
    _run_ranks(tmp_path, reads, paf, 4)
    _assert_equals_single(tmp_path, reads, paf)
