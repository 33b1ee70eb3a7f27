"""Naive position-only read splitter (baseline/ablation control).

raft_tpu_torch's copy of ``raft_tpu/tools/split_naive.py``, unchanged
apart from its docstring and its import: reads load through
``raft_tpu_torch.io.fasta.load_reads``.

Equivalent of the reference's separate ``split_naive`` binary
(the reference's ``split_naive.cpp:10-62``): fixed-length, non-overlapping
chop with headers ``>{name}_{i}`` (1-based chunk index), FASTA output,
sequence on one line. Used to A/B the repeat-aware chopper in evals.

Usage: ``python -m raft_tpu_torch.tools.split_naive <in> <out> SPLITLEN``
"""

from __future__ import annotations

import sys

from raft_tpu_torch.io.fasta import load_reads


def split_naive(in_path: str, out_path: str, sub_len: int) -> int:
    store = load_reads(in_path)
    blob = store.seq_blob
    off = store.seq_off
    n = 0
    with open(out_path, "wb", buffering=1 << 22) as f:
        for i, name in enumerate(store.names):
            s, e = int(off[i]), int(off[i + 1])
            idx = 1
            for p in range(s, e, sub_len) or [s]:
                f.write(f">{name}_{idx}\n".encode("ascii"))
                chunk = blob[p:min(p + sub_len, e)]
                f.write(chunk)
                f.write(b"\n")
                idx += 1
            n += 1
    return n


def print_help() -> None:
    print("Purpose: Split input reads naively into non-overlapping "
          "subreads. The output format is FASTA")
    print("Usage: split_naive <inputfilename> <outputfilename> SPLITLEN")
    print("Example: split_naive input.fastq output.fragmented.fasta 20000")
    raise SystemExit(1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print_help()
    split_naive(argv[0], argv[1], int(argv[2]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
