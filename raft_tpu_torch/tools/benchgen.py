"""Fast vectorized synthetic benchmark-data generator.

raft_tpu_torch's copy of ``raft_tpu/tools/benchgen.py``, unchanged.

Produces a reads FASTA + all-vs-all-style PAF at the scale of the surveyed
baseline workload (BASELINE.md row 3: 2000 reads / 47.2 Mbp / ~60k rows)
or any multiple of it. Pure numpy; ~100 MB/s+ generation.
"""

from __future__ import annotations

import os

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def gen_dataset(path_prefix: str, n_reads: int = 2000,
                mean_len: int = 23600, n_overlaps: int = 60000,
                est_cov: int = 20, repeat_frac: float = 0.08,
                seed: int = 7, force: bool = False) -> tuple[str, str]:
    """Write ``<prefix>.reads.fasta`` and ``<prefix>.overlaps.paf``.

    Coverage structure: most overlap intervals are random spans; a
    ``repeat_frac`` subset of reads gets ``3*est_cov`` extra stacked
    intervals over a contiguous region to create qualifying repeat runs.
    """
    reads_path = path_prefix + ".reads.fasta"
    paf_path = path_prefix + ".overlaps.paf"
    if (not force and os.path.exists(reads_path)
            and os.path.exists(paf_path)):
        return reads_path, paf_path

    rng = np.random.default_rng(seed)
    lens = np.maximum(
        1000, rng.normal(mean_len, mean_len // 3, n_reads).astype(np.int64))

    names = [f"mov1/{i}/ccs" for i in range(n_reads)]
    with open(reads_path, "wb", buffering=1 << 22) as f:
        for i in range(n_reads):
            seq = _BASES[rng.integers(0, 4, lens[i])].tobytes()
            f.write(b">" + names[i].encode() + b"\n" + seq + b"\n")

    # random overlap rows
    qi = rng.integers(0, n_reads, n_overlaps)
    ti = rng.integers(0, n_reads, n_overlaps)
    ql = lens[qi]
    tl = lens[ti]
    span = np.minimum(rng.integers(500, 20000, n_overlaps),
                      np.minimum(ql, tl))
    qs = rng.integers(0, np.maximum(ql - span, 1))
    ts = rng.integers(0, np.maximum(tl - span, 1))
    qe = qs + span
    te = ts + span

    # engineered repeats
    n_rep = max(1, int(n_reads * repeat_frac))
    rep_reads = rng.choice(n_reads, n_rep, replace=False)
    extra = 3 * est_cov
    rq, rt, rqs, rqe, rts, rte = [], [], [], [], [], []
    for r in rep_reads:
        L = lens[r]
        lo = int(rng.integers(0, max(L // 2, 1)))
        hi = int(min(L, lo + rng.integers(L // 3, max(L // 2, L // 3 + 1))))
        other = rng.integers(0, n_reads, extra)
        osp = np.minimum(hi - lo, lens[other])
        os_ = rng.integers(0, np.maximum(lens[other] - osp, 1))
        rq.append(np.full(extra, r)); rt.append(other)
        rqs.append(np.full(extra, lo)); rqe.append(np.full(extra, hi))
        rts.append(os_); rte.append(os_ + osp)
    qi = np.concatenate([qi] + rq)
    ti = np.concatenate([ti] + rt)
    qs = np.concatenate([qs] + rqs)
    qe = np.concatenate([qe] + rqe)
    ts = np.concatenate([ts] + rts)
    te = np.concatenate([te] + rte)
    ql = lens[qi]
    tl = lens[ti]

    with open(paf_path, "w", buffering=1 << 22) as f:
        for k in range(len(qi)):
            ml = int(min(qe[k] - qs[k], te[k] - ts[k]))
            f.write(f"{names[qi[k]]}\t{ql[k]}\t{qs[k]}\t{qe[k]}\t+\t"
                    f"{names[ti[k]]}\t{tl[k]}\t{ts[k]}\t{te[k]}\t"
                    f"{ml}\t{ml}\t60\n")
    return reads_path, paf_path
