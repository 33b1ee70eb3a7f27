"""Diploid-style read simulation with ground-truth coordinates.

raft_tpu_torch's copy of ``raft_tpu/tools/simulate.py``, unchanged apart
from its docstrings and the module names it prints: the same arguments
write byte-identical files.

Equivalent of the reference's simulation harness
(the reference's ``bash_scripts/simulate.sh``, which drives seqrequester)
without external tools: synthesize a genome with embedded exact repeats,
sample reads with a log-normal length distribution, and emit

* reads FASTA with seqrequester-style headers
  (``read=N,forward|reverse,position=A-B,length=L,chrom``) that the
  engine auto-detects as simulated mode (``chop.hpp:101`` regex), and
* an all-vs-all PAF derived from TRUE genome overlaps between sampled
  reads (so coverage pileups reflect genuine repeat structure), and
* a ground-truth BED of repeat placements for validating
  ``.long_repeats.bed`` output.

Usage: ``python -m raft_tpu_torch.tools.simulate --genome-size 2000000
--coverage 30 --out sim`` → ``sim.reads.fasta``, ``sim.overlaps.paf``,
``sim.truth_repeats.bed``.
"""

from __future__ import annotations

import argparse

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65}


def _revcomp(seq: np.ndarray) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    for k, v in _COMP.items():
        lut[k] = v
    return lut[seq][::-1]


def make_genome(rng, size: int, n_repeats: int, repeat_len: int,
                copies: int):
    """Random genome with ``n_repeats`` repeat families, each pasted at
    ``copies`` locations. Returns (genome uint8, truth BED rows)."""
    g = _BASES[rng.integers(0, 4, size)]
    truth = []
    for fam in range(n_repeats):
        unit = _BASES[rng.integers(0, 4, repeat_len)]
        for _ in range(copies):
            pos = int(rng.integers(0, size - repeat_len))
            g[pos:pos + repeat_len] = unit
            truth.append((pos, pos + repeat_len, fam))
    truth.sort()
    return g, truth


def sample_reads(rng, genome: np.ndarray, coverage: float,
                 mean_len: int = 18000, sigma: float = 0.35):
    size = len(genome)
    total = int(size * coverage)
    reads = []
    acc = 0
    while acc < total:
        L = int(np.clip(rng.lognormal(np.log(mean_len), sigma), 1000,
                        size // 2))
        start = int(rng.integers(0, size - L))
        fwd = bool(rng.integers(0, 2))
        reads.append((start, start + L, fwd))
        acc += L
    return reads


def write_simulation(out_prefix: str, genome_size: int = 2_000_000,
                     coverage: float = 30.0, n_repeat_fams: int = 3,
                     repeat_len: int = 15000, copies: int = 4,
                     chrom: str = "chr1", seed: int = 11,
                     max_pairs_per_read: int = 40,
                     drop_rate: float = 0.0,
                     spurious_rate: float = 0.0,
                     jitter_sd: float = 0.0):
    """``drop_rate``/``spurious_rate``/``jitter_sd`` inject OVERLAP NOISE:
    real PAFs (hifiasm --dbg-ovec, minimap2 ava) drop true overlaps,
    add spurious pairs, and jitter endpoints —
    EVAL's derived-from-truth PAF is the ideal-input upper bound.

    * ``drop_rate``      — each true overlap row is dropped with this
                           probability;
    * ``spurious_rate``  — this fraction of the emitted-row count is
                           ADDED as random fake pairs (random reads,
                           random in-bounds intervals);
    * ``jitter_sd``      — gaussian jitter (bp, sd) on every PAF
                           endpoint, clamped to read bounds.

    Noise uses a SEPARATE rng stream (seed+1e6) so noise-free outputs
    stay bit-identical to pre-noise versions of this tool."""
    rng = np.random.default_rng(seed)
    noisy = drop_rate > 0 or spurious_rate > 0 or jitter_sd > 0
    nrng = np.random.default_rng(seed + 1_000_000) if noisy else None
    genome, truth = make_genome(rng, genome_size, n_repeat_fams,
                                repeat_len, copies)
    reads = sample_reads(rng, genome, coverage)

    with open(out_prefix + ".truth_repeats.bed", "w") as f:
        for (s, e, fam) in truth:
            f.write(f"{chrom}\t{s}\t{e}\trepeat_fam_{fam}\n")

    names = []
    with open(out_prefix + ".reads.fasta", "wb", buffering=1 << 22) as f:
        for i, (s, e, fwd) in enumerate(reads):
            al = "forward" if fwd else "reverse"
            L = e - s
            nm = f"read={i + 1},{al},position={s}-{e},length={L},{chrom}"
            names.append(nm)
            seq = genome[s:e] if fwd else _revcomp(genome[s:e])
            f.write(b">" + nm.encode() + b"\n" + seq.tobytes() + b"\n")

    # true all-vs-all overlaps from genome coordinates: reads i,j overlap
    # where their genome intervals intersect; PAF coordinates are on each
    # read's own forward strand (strand-flip for reverse reads).
    starts = np.array([r[0] for r in reads])
    ends = np.array([r[1] for r in reads])
    order = np.argsort(starts, kind="stable")
    n_pairs = 0
    with open(out_prefix + ".overlaps.paf", "w", buffering=1 << 22) as f:
        def emit_row(i, j, qs, qe, ts, te):
            nonlocal n_pairs
            if nrng is not None:
                if drop_rate > 0 and nrng.random() < drop_rate:
                    return
                if jitter_sd > 0:
                    li = ends[i] - starts[i]
                    lj = ends[j] - starts[j]
                    qs, qe, ts, te = (
                        v + int(round(nrng.normal(0, jitter_sd)))
                        for v in (qs, qe, ts, te))
                    qs = max(0, min(qs, li - 1))
                    qe = max(qs + 1, min(qe, li))
                    ts = max(0, min(ts, lj - 1))
                    te = max(ts + 1, min(te, lj))
            strand = "+" if reads[i][2] == reads[j][2] else "-"
            ml = min(qe - qs, te - ts)
            f.write(f"{names[i]}\t{ends[i] - starts[i]}\t{qs}\t{qe}\t"
                    f"{strand}\t{names[j]}\t{ends[j] - starts[j]}\t"
                    f"{ts}\t{te}\t{ml}\t{ml}\t60\n")
            n_pairs += 1

        for oi, i in enumerate(order):
            emitted = 0
            for j in order[oi + 1:]:
                if starts[j] >= ends[i]:
                    break
                if emitted >= max_pairs_per_read:
                    break
                lo = max(starts[i], starts[j])
                hi = min(ends[i], ends[j])
                if hi - lo < 500:
                    continue
                qs, qe = _to_read_coords(reads[i], lo, hi)
                ts, te = _to_read_coords(reads[j], lo, hi)
                emit_row(i, j, qs, qe, ts, te)
                emitted += 1

        # cross-copy repeat overlaps: an all-vs-all aligner maps reads on
        # DIFFERENT copies of the same repeat family onto each other —
        # this is precisely what inflates repeat-region coverage (the
        # signal RAFT detects). Coordinates map through the shared unit.
        fams: dict[int, list[tuple[int, int, int]]] = {}
        for (s, e, fam) in truth:
            fams.setdefault(fam, []).append((s, e, fam))
        for fam, copies_list in fams.items():
            hits = []  # (read idx, unit_lo, unit_hi, copy_pos)
            for (cs, ce, _) in copies_list:
                sel = np.nonzero((starts < ce) & (ends > cs))[0]
                for i in sel:
                    u_lo = max(int(starts[i]), cs) - cs
                    u_hi = min(int(ends[i]), ce) - cs
                    if u_hi - u_lo >= 500:
                        hits.append((int(i), u_lo, u_hi, cs))
            for a in range(len(hits)):
                for b in range(a + 1, len(hits)):
                    i, il, ih, ic = hits[a]
                    j, jl, jh, jc = hits[b]
                    if ic == jc:
                        continue  # same copy → already a true overlap
                    lo_u = max(il, jl)
                    hi_u = min(ih, jh)
                    if hi_u - lo_u < 500:
                        continue
                    qs, qe = _to_read_coords(reads[i], ic + lo_u, ic + hi_u)
                    ts, te = _to_read_coords(reads[j], jc + lo_u, jc + hi_u)
                    emit_row(i, j, qs, qe, ts, te)

        # spurious pairs: an aligner also reports pairs that share no
        # genome locus (chimeric joins, low-complexity hits). Random
        # reads, random in-bounds intervals with an overlap-ish length.
        if nrng is not None and spurious_rate > 0:
            n_spur = int(round(spurious_rate * n_pairs))
            nr = len(reads)
            for _ in range(n_spur):
                i = int(nrng.integers(0, nr))
                j = int(nrng.integers(0, nr))
                if i == j:
                    continue
                li = int(ends[i] - starts[i])
                lj = int(ends[j] - starts[j])
                L = int(np.clip(nrng.lognormal(np.log(4000), 0.6), 500,
                                min(li, lj)))
                qs = int(nrng.integers(0, li - L + 1))
                ts = int(nrng.integers(0, lj - L + 1))
                emit_row(i, j, qs, qs + L, ts, ts + L)
    return dict(n_reads=len(reads), n_pairs=n_pairs,
                est_cov=int(sum(e - s for s, e, _ in reads) / genome_size))


def _to_read_coords(read, lo, hi):
    s, e, fwd = read
    if fwd:
        return lo - s, hi - s
    return e - hi, e - lo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-size", type=int, default=2_000_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--repeat-fams", type=int, default=3)
    ap.add_argument("--repeat-len", type=int, default=15000)
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="drop each true overlap row with this prob")
    ap.add_argument("--spurious-rate", type=float, default=0.0,
                    help="add this fraction of rows as random fake pairs")
    ap.add_argument("--jitter-sd", type=float, default=0.0,
                    help="gaussian endpoint jitter (bp, sd)")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    info = write_simulation(a.out, a.genome_size, a.coverage, a.repeat_fams,
                            a.repeat_len, a.copies, seed=a.seed,
                            drop_rate=a.drop_rate,
                            spurious_rate=a.spurious_rate,
                            jitter_sd=a.jitter_sd)
    print(f"simulated {info['n_reads']} reads, {info['n_pairs']} overlap "
          f"rows, est_cov ~{info['est_cov']} → run: python -m "
          f"raft_tpu_torch.cli -e {info['est_cov']} -o out {a.out}.reads.fasta "
          f"{a.out}.overlaps.paf")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
