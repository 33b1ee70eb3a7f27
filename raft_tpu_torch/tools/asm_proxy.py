"""Idealized-OLC assembly proxy: contiguity impact of fragmentation.

raft_tpu_torch's copy of ``raft_tpu/tools/asm_proxy.py``, unchanged apart
from its usage line.

The reference's assembly-level acceptance (C18: hifiasm + quast/yak)
needs external binaries this environment lacks. This proxy measures the
assembly-relevant consequence of fragmentation that RAFT exists to
control — **junction ambiguity** — with an explicit, idealized layout
model over simulated truth coordinates:

* fragments (headers carry true genome intervals in simulated mode)
  are laid out greedily left-to-right, merging a fragment into the
  growing contig when it overlaps the contig's current end by at least
  ``min_ovl`` bp;
* a merge is **ambiguous** — and breaks the contig — when the
  overlapping (junction) interval lies entirely inside a true repeat:
  a real OLC assembler cannot distinguish which repeat copy the
  continuation belongs to, so repeat-only junctions are exactly where
  misassemblies or breaks happen. Junctions anchored by ANY unique
  sequence pass;
* coverage gaps break contigs for every input equally.

This is NOT an assembler: it uses truth coordinates for layout, so it
cannot measure base accuracy or real misjoins — only how the PLACEMENT
of fragment boundaries constrains contiguity under the standard OLC
uniqueness rule. That is precisely the axis RAFT's repeat-aware
chopping targets (``chop.hpp:225-246``: never cut inside a repeat), so
comparing RAFT fragments against the position-blind ``split_naive``
ablation on the same simulation isolates the product's contribution.

Usage (after an eval run that produced ``out.reads.fasta``)::

    python -m raft_tpu_torch.tools.asm_proxy --fragments out.reads.fasta \
        --truth-bed sim.truth_repeats.bed [--min-ovl 500]

Prints one JSON line: contig count, NG50 (vs the spanned genome),
largest contig, and the count of repeat-ambiguous junctions hit.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np

_HDR = re.compile(
    rb">read=\d+,(?:forward|reverse),position=(\d+)-(\d+),length=\d+,")


def fragment_intervals(path: str) -> np.ndarray:
    """[n, 2] true genome intervals parsed from simulated-mode fragment
    headers (the emitted position field is genome-coordinate)."""
    iv = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                m = _HDR.match(line)
                if m:
                    iv.append((int(m.group(1)), int(m.group(2))))
    if not iv:
        raise ValueError(f"no simulated-mode fragment headers in {path}")
    return np.asarray(iv, dtype=np.int64)


def read_bed(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split("\t")
            if len(p) >= 3:
                rows.append((int(p[1]), int(p[2])))
    rows.sort()
    return np.asarray(rows, dtype=np.int64) if rows \
        else np.empty((0, 2), dtype=np.int64)


def _in_repeat(repeats: np.ndarray, lo: int, hi: int) -> bool:
    """True iff [lo, hi) lies ENTIRELY inside one merged repeat."""
    if len(repeats) == 0 or hi <= lo:
        return False
    i = int(np.searchsorted(repeats[:, 0], lo, side="right")) - 1
    return i >= 0 and repeats[i, 0] <= lo and hi <= repeats[i, 1]


def assemble(frags: np.ndarray, repeats: np.ndarray,
             min_ovl: int = 500):
    """Greedy left-to-right layout under the OLC uniqueness rule.

    Returns (contig_lengths, n_ambiguous_junctions, n_gap_breaks).
    """
    order = np.lexsort((frags[:, 1], frags[:, 0]))
    f = frags[order]
    contigs = []
    n_amb = 0
    n_gap = 0
    cs, ce = int(f[0, 0]), int(f[0, 1])
    # at each step, among fragments starting before the uniqueness/
    # coverage limit, take the one reaching furthest (standard greedy
    # interval cover), then test the junction it forms
    i = 1
    n = len(f)
    while i < n:
        # candidates overlapping the current contig end by >= min_ovl
        best = -1
        best_end = ce
        j = i
        while j < n and f[j, 0] <= ce - min_ovl:
            if f[j, 1] > best_end:
                best = j
                best_end = int(f[j, 1])
            j += 1
        if best < 0:
            # no extension: either a true coverage gap or only
            # too-short overlaps — break, start a new contig
            skip = i
            while skip < n and f[skip, 1] <= ce:
                skip += 1  # contained fragments extend nothing
            contigs.append(ce - cs)
            if skip < n:
                if f[skip, 0] < ce:
                    pass  # short-overlap break (counted as gap-ish)
                n_gap += 1
                cs, ce = int(f[skip, 0]), int(f[skip, 1])
            i = skip + 1 if skip < n else n
            continue
        # junction = the overlap interval between contig and the chosen
        # fragment; entirely-in-repeat junctions are ambiguous
        jlo = int(f[best, 0])
        jhi = min(ce, best_end)
        if _in_repeat(repeats, jlo, jhi):
            n_amb += 1
            contigs.append(ce - cs)
            cs, ce = int(f[best, 0]), best_end
        else:
            ce = max(ce, best_end)
        i = best + 1
        # consume every fragment fully contained in the contig so far
        while i < n and f[i, 1] <= ce and f[i, 0] >= cs:
            i += 1
    contigs.append(ce - cs)
    return np.asarray(sorted(contigs, reverse=True), dtype=np.int64), \
        n_amb, n_gap


def ng50(contigs: np.ndarray, genome_span: int) -> int:
    half = genome_span / 2
    acc = 0
    for c in contigs:
        acc += int(c)
        if acc >= half:
            return int(c)
    return int(contigs[-1]) if len(contigs) else 0


def evaluate(frag_path: str, truth_bed: str, min_ovl: int = 500) -> dict:
    frags = fragment_intervals(frag_path)
    repeats = read_bed(truth_bed)
    # merge repeat intervals
    if len(repeats):
        merged = [list(repeats[0])]
        for s, e in repeats[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        repeats = np.asarray(merged, dtype=np.int64)
    contigs, n_amb, n_gap = assemble(frags, repeats, min_ovl)
    span = int(frags[:, 1].max() - frags[:, 0].min())
    return {
        "n_fragments": int(len(frags)),
        "n_contigs": int(len(contigs)),
        "ng50": ng50(contigs, span),
        "largest_contig": int(contigs[0]),
        "total_contig_bp": int(contigs.sum()),
        "genome_span": span,
        "ambiguous_junction_breaks": int(n_amb),
        "gap_breaks": int(n_gap),
        "min_ovl": min_ovl,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fragments", required=True)
    ap.add_argument("--truth-bed", required=True)
    ap.add_argument("--min-ovl", type=int, default=500)
    a = ap.parse_args(argv)
    print(json.dumps(evaluate(a.fragments, a.truth_bed, a.min_ovl)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
