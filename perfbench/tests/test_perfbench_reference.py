"""The plain reference: byte-equal to the program's ``--device cpu``
outputs on small slices of the configuration (as it is, and with long
reads, most of them chopped), whole-file and streaming, and its chop
equal to cases worked by hand from RAFT's chop rules."""

import mmap
import os

import numpy as np
import pytest

from perfbench import gen, harness, reference
from perfbench.tests.conftest import LONG_READS

VARIANTS = {"hifi": {}, "long_reads": LONG_READS}


def write_inputs(ds, d):
    paths = []
    for name, render in (("reads.fasta", gen.render_fasta),
                         ("overlaps.paf", gen.render_paf)):
        fd = gen.memfd(name)
        try:
            render(ds, fd)
            with open(gen.fd_path(fd), "rb") as f:
                data = f.read()
        finally:
            os.close(fd)
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    return paths


def program_outputs(reads, paf, cell, est_cov, prefix):
    from raft_tpu_torch import pipeline
    params = harness.algo_params(cell.config, est_cov, prefix)
    pipeline.run_pipeline(reads, paf, params, device="cpu", verbose=False)
    out = {}
    for sfx in reference.SUFFIXES:
        with open(prefix + sfx, "rb") as f:
            out[sfx] = f.read()
    return out


def reference_outputs(ds, cell, reads):
    fl = reference.Flags.from_config(cell.config["raft_flags"], ds.est_cov)
    with open(reads, "rb") as f, \
            mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ) as src:
        return reference.expected_outputs(ds, fl, src)[0]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_equals_program_cpu(variant, seed, tmp_path):
    cell = harness.find_cell("hifi30x.whole")
    cell.config = {**cell.config, **VARIANTS[variant]}
    ds = gen.make_dataset(cell.config, {"n_reads": 700}, seed)
    reads, paf = write_inputs(ds, tmp_path)
    got = program_outputs(reads, paf, cell, ds.est_cov,
                          str(tmp_path / "out"))
    want = reference_outputs(ds, cell, reads)
    assert want[".long_repeats.txt"].count(b",") > ds.n_reads  # repeats found
    n_frag = want[".reads.fasta"].count(b">")
    assert n_frag > (1.5 if variant == "long_reads" else 1.0) * ds.n_reads
    for sfx in reference.SUFFIXES:
        assert got[sfx] == want[sfx], sfx


def test_reference_equals_program_streaming(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    monkeypatch.setattr("raft_tpu_torch.pipeline.DEFAULT_CHUNK_READS", 128)
    cell = harness.find_cell("hifi30x.whole")
    ds = gen.make_dataset(cell.config, {"n_reads": 500}, 8)
    reads, paf = write_inputs(ds, tmp_path)
    got = program_outputs(reads, paf, cell, ds.est_cov,
                          str(tmp_path / "out"))
    want = reference_outputs(ds, cell, reads)
    for sfx in reference.SUFFIXES:
        assert got[sfx] == want[sfx], sfx


def test_symmetric_paf_drops_the_target_side(tmp_path):
    cell = harness.find_cell("hifi30x.whole")
    ds = gen.make_dataset(cell.config, {"n_reads": 300}, 21)
    p = ds.paf
    mirror = {"a_id": p["b_id"], "b_id": p["a_id"], "a_start": p["b_start"],
              "a_end": p["b_end"], "b_start": p["a_start"],
              "b_end": p["a_end"], "same_strand": p["same_strand"]}
    ds.paf = {k: np.concatenate([p[k], mirror[k][:1]]) for k in p}
    assert reference.is_symmetric(ds.paf)
    reads, paf = write_inputs(ds, tmp_path)
    got = program_outputs(reads, paf, cell, ds.est_cov,
                          str(tmp_path / "out"))
    want = reference_outputs(ds, cell, reads)
    for sfx in reference.SUFFIXES:
        assert got[sfx] == want[sfx], sfx


# p = 10,000, l = 20,000 (div 2), v = 500: RAFT's defaults
HAND = {
    "short_read_whole": (15000, [], [(0, 15000)]),
    "three_fragments": (45000, [],
                        [(0, 20000), (19500, 20500), (39500, 5500)]),
    "exact_multiple": (40000, [], [(0, 20000), (19500, 20500)]),
    "repeat_deletes_two_markers": (45000, [(9000, 21000)],
                                   [(0, 40000), (39500, 5500)]),
    "repeat_ends_on_markers": (60000, [(10000, 20000)],
                               [(0, 40000), (39500, 20500)]),
    "repeat_over_the_read": (40000, [(0, 40000)], [(0, 40000)]),
    "two_repeats": (70000, [(100, 9999), (30000, 30000)],
                    [(0, 20000), (19500, 30500), (49500, 20500)]),
    "tiny_read": (7, [], [(0, 7)]),
}


@pytest.mark.parametrize("case", HAND)
def test_chop_worked_by_hand(case):
    L, reps, want = HAND[case]
    fl = reference.Flags(reso=50, est_cov=30, cov_mul=1.5,
                         repeat_length=10000, interval_length=10000,
                         read_length=20000, overlap_length=500,
                         flanking_length=1000)
    # the read between two others, so that offsets across reads count
    lens = np.array([45000, L, 15000], np.int64)
    rr = np.array([0] + [1] * len(reps) + [2], np.int64)
    rs = np.array([9000] + [s for s, _ in reps] + [0], np.int64)
    re_ = np.array([21000] + [e for _, e in reps] + [15000], np.int64)
    fr_r, fr_s, fr_l = reference.fragments(lens, rr, rs, re_, fl)
    got = list(zip(fr_s[fr_r == 1].tolist(), fr_l[fr_r == 1].tolist()))
    assert got == want
    assert list(zip(fr_s[fr_r == 0].tolist(), fr_l[fr_r == 0].tolist())) \
        == [(0, 40000), (39500, 5500)]
    assert list(zip(fr_s[fr_r == 2].tolist(), fr_l[fr_r == 2].tolist())) \
        == [(0, 15000)]
