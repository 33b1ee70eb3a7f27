"""Ground-truth quality evaluation of the pipeline at workflow scale.

raft_tpu_torch's counterpart of ``raft_tpu/tools/eval_repeats.py``. The
interval algebra, the output parsing, ``cut_positions``,
``naive_cut_positions`` and ``n50`` are copied unchanged; the entry functions
(``run_eval``, ``_eval_point``, ``run_sweep``, ``run_noise_sweep``) run
this package's ``run_pipeline`` and ``compute_torch`` where the original
runs its own and ``compute_jax``, on ``device`` (``cuda`` by default). A
row equals the original's JSON line for the same point, key for key.

The reference's de-facto integration test is the chr11-2M RAFT-hifiasm
workflow plus the header-derived BED QC, i.e. correctness is judged by
what the fragmentation does to the assembly, not only by byte parity.
This tool measures the product metrics directly against simulated ground
truth (``raft_tpu_torch.tools.simulate`` encodes true genome coordinates
in read headers and emits a truth-repeat BED):

* **long_repeats.bed precision/recall** (base-level, vs the truth BED;
  also with flank tolerance, since the emitted intervals are flank-
  expanded by design — ``repeat.hpp:150-168``),
* **cut placement**: fraction of interior fragment boundaries that land
  inside a true repeat (RAFT's product invariant is to never cut inside a
  repeat: ``chop.hpp:225-246``), vs the ``split_naive`` position-blind
  ablation which cuts ~uniformly,
* **fragment stats**: count, N50, length distribution, header-BED genome
  coverage (the run.sh QC).

Usage::

    python -m raft_tpu_torch.tools.eval_repeats --genome-size 2000000 \
        --coverage 30 --workdir /tmp/raft_eval [--device cpu]

Prints one JSON summary line per point. ``--device cuda`` (the default)
with no CUDA device exits 1; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

from raft_tpu_torch import auto_e as _ae
from raft_tpu_torch.engine_torch import compute_torch
from raft_tpu_torch.io.fasta import load_reads
from raft_tpu_torch.io.paf import load_paf
from raft_tpu_torch.params import AlgoParams
from raft_tpu_torch.pipeline import run_pipeline
from raft_tpu_torch.tools.simulate import write_simulation


# ---------------------------------------------------------------------------
# Interval algebra (numpy; no bedtools dependency)
# ---------------------------------------------------------------------------

def merge_intervals(iv: np.ndarray) -> np.ndarray:
    """[n, 2] possibly-overlapping intervals → merged, sorted, disjoint."""
    if len(iv) == 0:
        return np.empty((0, 2), dtype=np.int64)
    iv = iv[np.lexsort((iv[:, 1], iv[:, 0]))]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def total_len(iv: np.ndarray) -> int:
    return int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0


def intersect_len(a: np.ndarray, b: np.ndarray) -> int:
    """Total overlap between two MERGED interval sets."""
    i = j = 0
    tot = 0
    while i < len(a) and j < len(b):
        lo = max(a[i, 0], b[j, 0])
        hi = min(a[i, 1], b[j, 1])
        if hi > lo:
            tot += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return int(tot)


def points_in(points: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Boolean mask: point p falls inside some [s, e) of MERGED iv."""
    if len(iv) == 0 or len(points) == 0:
        return np.zeros(len(points), dtype=bool)
    k = np.searchsorted(iv[:, 0], points, side="right") - 1
    ok = k >= 0
    res = np.zeros(len(points), dtype=bool)
    res[ok] = points[ok] < iv[k[ok], 1]
    return res


# ---------------------------------------------------------------------------
# Output parsing
# ---------------------------------------------------------------------------

_HDR = re.compile(
    rb">read=\d+,(forward|reverse),position=(\d+)-(\d+),length=(\d+),")


def read_bed(path: str) -> np.ndarray:
    rows = []
    with open(path, "rb") as f:
        for line in f:
            parts = line.split(b"\t")
            if len(parts) >= 3:
                rows.append((int(parts[1]), int(parts[2])))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 2)


def fragment_positions(fasta_path: str):
    """Genome-coordinate (start, end, strand) of every fragment from the
    simulated-mode headers (the run.sh:1-12 QC input)."""
    starts, ends, fwd = [], [], []
    with open(fasta_path, "rb") as f:
        for line in f:
            m = _HDR.match(line)
            if m:
                starts.append(int(m.group(2)))
                ends.append(int(m.group(3)))
                fwd.append(m.group(1) == b"forward")
    return (np.asarray(starts, dtype=np.int64),
            np.asarray(ends, dtype=np.int64), np.asarray(fwd, dtype=bool))


def cut_positions(res, store) -> np.ndarray:
    """Genome positions of RAFT's interior cut markers, exactly.

    Fragment j of a read ends at marker M (read coords ``char_start +
    char_len``); fragment j+1 starts at ``M - overlap_length``. The CUT is
    the marker M, one per adjacent fragment pair — a read's own endpoints
    are not cuts (chop.hpp:280-321 span arithmetic). Forward reads map M
    to ``start_pos + M``, reverse reads to ``end_pos - M``."""
    fr = np.asarray(res.frag_read)
    if len(fr) == 0:
        return np.empty(0, dtype=np.int64)
    cs = np.asarray(res.frag_char_start)
    cl = np.asarray(res.frag_char_len)
    whole = np.asarray(res.frag_whole)
    # interior boundary: fragment is not its read's last (emission is in
    # read order, so "next row is the same read" identifies non-last)
    not_last = np.zeros(len(fr), dtype=bool)
    not_last[:-1] = fr[:-1] == fr[1:]
    sel = not_last & ~whole
    m = cs[sel] + cl[sel]
    store.ensure_sim_lists()
    fwd = np.asarray([a == "forward" for a in store.align])
    rid = fr[sel]
    sp = np.asarray(store.start_pos)[rid]
    ep = np.asarray(store.end_pos)[rid]
    return np.where(fwd[rid], sp + m, ep - m).astype(np.int64)


def naive_cut_positions(store, sub_len: int) -> np.ndarray:
    """Genome positions of the position-blind ablation's cuts: fixed
    boundaries every ``sub_len`` read-bp (split_naive.cpp:27-29), mapped
    through the same strand rule."""
    store.ensure_sim_lists()
    cuts = []
    lens = np.asarray(store.lens)
    for i in range(store.n_reads):
        L = int(lens[i])
        k = np.arange(1, (max(L - 1, 0)) // sub_len + 1, dtype=np.int64)
        if len(k) == 0:
            continue
        m = k * sub_len
        if store.align[i] == "forward":
            cuts.append(int(store.start_pos[i]) + m)
        else:
            cuts.append(int(store.end_pos[i]) - m)
    return (np.concatenate(cuts).astype(np.int64)
            if cuts else np.empty(0, dtype=np.int64))


def n50(lengths: np.ndarray) -> int:
    if len(lengths) == 0:
        return 0
    ls = np.sort(lengths)[::-1]
    half = ls.sum() / 2
    return int(ls[np.cumsum(ls) >= half][0])


# ---------------------------------------------------------------------------
# Evaluation entry points
# ---------------------------------------------------------------------------

def run_eval(workdir: str, genome_size: int = 2_000_000,
             coverage: float = 30.0, repeat_fams: int = 3,
             repeat_len: int = 15000, copies: int = 4, seed: int = 11,
             engine: str = "torch", verbose: bool = True,
             est_cov_scale: float = 1.0, auto_e: bool = False,
             drop_rate: float = 0.0, spurious_rate: float = 0.0,
             jitter_sd: float = 0.0, device: str = "cuda") -> dict:
    """One simulation + one evaluation point.

    ``est_cov_scale`` mis-specifies ``-e`` on purpose: the reference's
    one user-supplied knob is est_cov = total_bases/genome_size and users
    routinely get it wrong (stale genome-size guess, unaccounted
    duplications). The sensitivity sweep (``run_sweep``) measures how
    quality degrades at 0.5×..2× of the true value."""
    os.makedirs(workdir, exist_ok=True)
    prefix = os.path.join(workdir, "sim")
    info = write_simulation(prefix, genome_size, coverage, repeat_fams,
                            repeat_len, copies, seed=seed,
                            drop_rate=drop_rate,
                            spurious_rate=spurious_rate,
                            jitter_sd=jitter_sd)
    out = _eval_point(workdir, prefix, info, genome_size, engine,
                      est_cov_scale, auto_e=auto_e, device=device)
    out["noise"] = {"drop_rate": drop_rate,
                    "spurious_rate": spurious_rate,
                    "jitter_sd": jitter_sd}
    if verbose:
        print(json.dumps(out), flush=True)
    return out


def _eval_point(workdir: str, prefix: str, info: dict, genome_size: int,
                engine: str, est_cov_scale: float,
                loaded=None, auto_e: bool = False,
                device: str = "cuda") -> dict:
    """Score one (simulation, est_cov_scale) point. ``loaded`` optionally
    carries a pre-parsed (store, table) so sweeps don't re-parse the same
    inputs per scale. ``auto_e`` scores the --auto-e mode instead: the
    user-supplied scale is IGNORED and est_cov comes from the data
    (derived here exactly as run_pipeline's --auto-e derives it).

    The product run takes ``engine`` (``torch`` or ``oracle``); the exact
    cut positions always come from ``compute_torch`` on ``device``, as
    the original takes them from ``compute_jax``."""
    if auto_e:
        if loaded is None:
            _store = load_reads(prefix + ".reads.fasta")
            _table = load_paf(prefix + ".overlaps.paf", _store)
        else:
            _store, _table = loaded
        dflt = AlgoParams()
        einfo, _ = _ae.estimate_for_table(
            _table, np.asarray(_store.lens, dtype=np.int64),
            _store.n_reads, dflt.reso, dflt.cov_mul)
        est_cov = einfo["est_cov"]
    else:
        est_cov = max(1, int(round(info["est_cov"] * est_cov_scale)))

    # full product run (all four outputs, emitted through the real path)
    params = AlgoParams(est_cov=est_cov,
                        outputfilename=os.path.join(workdir, "out"))
    st = run_pipeline(prefix + ".reads.fasta", prefix + ".overlaps.paf",
                      params, engine=engine, verbose=False, device=device)

    # exact compute-result arrays for the cut-placement analysis
    if loaded is None:
        store = load_reads(prefix + ".reads.fasta")
        table = load_paf(prefix + ".overlaps.paf", store)
    else:
        store, table = loaded
    rparams = params.replace(real_reads=store.real_reads,
                             symmetric_overlaps=table.symmetric)
    res = compute_torch(store, table, rparams, device=device)

    truth = merge_intervals(read_bed(prefix + ".truth_repeats.bed"))
    pred = merge_intervals(read_bed(
        os.path.join(workdir, "out.long_repeats.bed")))

    inter = intersect_len(pred, truth)
    precision = inter / total_len(pred) if total_len(pred) else 0.0
    recall = inter / total_len(truth) if total_len(truth) else 0.0
    # flank tolerance: emitted intervals are flank-expanded BY DESIGN
    # (repeat.hpp:156-168), so also score against flank-expanded truth
    fl = params.flanking_length
    truth_fl = merge_intervals(
        np.stack([np.maximum(truth[:, 0] - fl, 0), truth[:, 1] + fl],
                 axis=1)) if len(truth) else truth
    inter_fl = intersect_len(pred, truth_fl)
    precision_fl = inter_fl / total_len(pred) if total_len(pred) else 0.0

    # fragment QC from the EMITTED headers (run.sh:1-12 style)
    fs, fe, _ = fragment_positions(os.path.join(workdir, "out.reads.fasta"))
    frag_iv = merge_intervals(np.stack([fs, fe], axis=1))
    genome_cov = total_len(frag_iv) / genome_size

    # cut placement: RAFT vs the position-blind ablation
    cuts = cut_positions(res, store)
    cuts_in_repeat = int(points_in(cuts, truth).sum())
    ncuts = naive_cut_positions(store, params.read_length)
    ncuts_in_repeat = int(points_in(ncuts, truth).sum())

    out = {
        "n_reads": st.n_reads,
        "n_paf_rows": st.n_paf_rows,
        "n_fragments": st.n_fragments,
        "fragment_n50": n50(fe - fs),
        "genome_fraction_covered_by_fragments": round(genome_cov, 4),
        "truth_repeat_bp": total_len(truth),
        "pred_repeat_bp": total_len(pred),
        "bed_precision": round(precision, 4),
        "bed_precision_flank_tolerant": round(precision_fl, 4),
        "bed_recall": round(recall, 4),
        "interior_cuts": int(len(cuts)),
        "cuts_inside_true_repeats": cuts_in_repeat,
        "cut_in_repeat_rate": round(cuts_in_repeat / max(len(cuts), 1), 4),
        "naive_interior_cuts": int(len(ncuts)),
        "naive_cuts_inside_true_repeats": ncuts_in_repeat,
        "naive_cut_in_repeat_rate": round(
            ncuts_in_repeat / max(len(ncuts), 1), 4),
        "fraction_repeat_stat": round(st.fraction_repeat, 4),
        "est_cov_used": est_cov,
        "est_cov_scale": None if auto_e else est_cov_scale,
        "auto_e": auto_e,
    }
    return out


SWEEP_SCALES = (0.5, 0.75, 1.0, 1.5, 2.0)


def run_sweep(workdir: str, genome_size: int = 2_000_000,
              coverage: float = 30.0, seeds=(11, 23),
              scales=SWEEP_SCALES, engine: str = "torch",
              repeat_fams: int = 3, repeat_len: int = 15000,
              copies: int = 4, verbose: bool = True,
              device: str = "cuda") -> list[dict]:
    """est_cov sensitivity sweep: one simulation per seed, evaluated at
    each ``-e`` mis-specification scale, then in --auto-e mode. The
    inputs are parsed once per seed; only the parameter point changes."""
    rows = []
    for seed in seeds:
        wd = os.path.join(workdir, f"seed{seed}")
        os.makedirs(wd, exist_ok=True)
        prefix = os.path.join(wd, "sim")
        info = write_simulation(prefix, genome_size, coverage, repeat_fams,
                                repeat_len, copies, seed=seed)
        store = load_reads(prefix + ".reads.fasta")
        table = load_paf(prefix + ".overlaps.paf", store)
        points = [dict(scale=sc, auto=False) for sc in scales]
        points.append(dict(scale=1.0, auto=True))  # the --auto-e row
        for pt in points:
            r = _eval_point(wd, prefix, info, genome_size, engine,
                            pt["scale"], loaded=(store, table),
                            auto_e=pt["auto"], device=device)
            r["seed"] = seed
            r["genome_size"] = genome_size
            rows.append(r)
            if verbose:
                print(json.dumps(r), flush=True)
    return rows


NOISE_POINTS = (
    # one knob at a time, then a realistic combined point
    {"drop_rate": 0.1}, {"drop_rate": 0.2}, {"drop_rate": 0.4},
    {"spurious_rate": 0.1}, {"spurious_rate": 0.2},
    {"jitter_sd": 100.0}, {"jitter_sd": 500.0},
    {"drop_rate": 0.2, "spurious_rate": 0.1, "jitter_sd": 100.0},
)


def run_noise_sweep(workdir: str, genome_size: int = 2_000_000,
                    coverage: float = 30.0, seeds=(11, 23),
                    points=NOISE_POINTS, engine: str = "torch",
                    verbose: bool = True,
                    device: str = "cuda") -> list[dict]:
    """Overlap-noise robustness sweep: real PAFs are not the
    derived-from-truth ideal — they drop true overlaps, add spurious
    ones, and jitter coordinates. One clean point + every NOISE_POINTS
    per seed, -e at truth."""
    rows = []
    for seed in seeds:
        for pt in ({},) + tuple(points):
            wd = os.path.join(workdir,
                              f"s{seed}_" + "_".join(
                                  f"{k[0]}{v:g}" for k, v in pt.items()))
            r = run_eval(wd, genome_size, coverage, seed=seed,
                         engine=engine, verbose=False, device=device, **pt)
            r["seed"] = seed
            rows.append(r)
            if verbose:
                print(json.dumps(r), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--genome-size", type=int, default=2_000_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--repeat-fams", type=int, default=3)
    ap.add_argument("--repeat-len", type=int, default=15000)
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--engine", default="torch", choices=("torch", "oracle"),
                    help="engine of the product run (the cut positions "
                         "always come from compute_torch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the torch engine runs (default cuda; no "
                         "CUDA device is an error)")
    ap.add_argument("--est-cov-scale", type=float, default=1.0,
                    help="evaluate with -e at this multiple of the true "
                         "coverage (sensitivity analysis)")
    ap.add_argument("--auto-e", action="store_true",
                    help="score the --auto-e mode (data-estimated "
                         "est_cov; --est-cov-scale is ignored)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the full est_cov sensitivity sweep "
                         f"(scales {SWEEP_SCALES}, seeds 11+23) instead "
                         "of a single point")
    ap.add_argument("--noise-sweep", action="store_true",
                    help="run the overlap-noise robustness sweep "
                         "(drop/spurious/jitter points, seeds 11+23)")
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--spurious-rate", type=float, default=0.0)
    ap.add_argument("--jitter-sd", type=float, default=0.0)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("ERROR, --device cuda: no CUDA device is available "
                  "(pass --device cpu to run on the CPU)", file=sys.stderr)
            return 1
    if a.noise_sweep:
        run_noise_sweep(a.workdir, a.genome_size, a.coverage,
                        engine=a.engine, device=a.device)
        return 0
    if a.sweep:
        run_sweep(a.workdir, a.genome_size, a.coverage,
                  engine=a.engine, repeat_fams=a.repeat_fams,
                  repeat_len=a.repeat_len, copies=a.copies, device=a.device)
    else:
        run_eval(a.workdir, a.genome_size, a.coverage, a.repeat_fams,
                 a.repeat_len, a.copies, a.seed, a.engine,
                 est_cov_scale=a.est_cov_scale, auto_e=a.auto_e,
                 drop_rate=a.drop_rate, spurious_rate=a.spurious_rate,
                 jitter_sd=a.jitter_sd, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
