"""Pure-python contiguity statistics: the always-available QC metric.

raft_tpu_torch's copy of ``raft_tpu/tools/asm_stats.py``, unchanged apart
from its usage line.

The reference's QC harness (``bash_scripts/quast_pri.sh`` etc.) leans
entirely on external tools, so in an image without quast/yak/minigraph
zero metrics can run. This tool computes the tool-independent subset —
contig count, total length, largest contig, N50/L50, and NG50/LG50 when
a reference FASTA (or explicit genome size) provides the denominator —
from plain/gzip FASTA, so ``scripts/eval_assembly.sh`` always has at
least one metric that genuinely runs.

Usage::

    python -m raft_tpu_torch.tools.asm_stats asm.fa [-r ref.fa | -g SIZE]

Prints ONE JSON line. NG50/LG50 are null without a denominator; NG50 is
null (with ``"ng50_reached": false``) when the assembly does not reach
half the genome size.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys


def contig_lengths(path: str) -> list[int]:
    op = gzip.open if path.endswith(".gz") else open
    lens: list[int] = []
    cur = -1
    with op(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur >= 0:
                    lens.append(cur)
                cur = 0
            elif cur >= 0:
                cur += len(line.strip())
    if cur >= 0:
        lens.append(cur)
    return lens


def nx(lens: list[int], denom: int, x: float = 0.5):
    """(Nx, Lx) over ``denom`` — N50/L50 with denom=sum(lens), NG50/LG50
    with denom=genome size. Returns (None, None) if ``lens`` never
    accumulates to ``x * denom``."""
    target = denom * x
    acc = 0
    for i, n in enumerate(sorted(lens, reverse=True), 1):
        acc += n
        if acc >= target:
            return n, i
    return None, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("assembly")
    ap.add_argument("-r", "--reference",
                    help="reference FASTA for the NG50 denominator")
    ap.add_argument("-g", "--genome-size", type=int,
                    help="explicit genome size (overrides -r)")
    args = ap.parse_args(argv)

    lens = contig_lengths(args.assembly)
    if not lens:
        print(json.dumps({"error": "no contigs"}))
        return 1
    total = sum(lens)
    n50, l50 = nx(lens, total)
    out = {"contigs": len(lens), "total_bp": total,
           "largest_bp": max(lens), "n50": n50, "l50": l50}
    gsize = args.genome_size
    if gsize is None and args.reference:
        gsize = sum(contig_lengths(args.reference))
    if gsize:
        out["genome_size"] = gsize
        ng50, lg50 = nx(lens, gsize)
        out["ng50"], out["lg50"] = ng50, lg50
        out["ng50_reached"] = ng50 is not None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
