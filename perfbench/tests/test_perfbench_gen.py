"""The traffic generator: deterministic per seed, and the configuration's
stated lengths, coverage, rows per read and names."""

import json
import os
import re

import numpy as np
import pytest

from perfbench import gen
from perfbench.harness import ROOT

CONFIGS = ("hifi_human_30x",)
SIM_RE = re.compile(rb"read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,"
                    rb"length=[0-9]+,(.*)")


def config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def rendered(ds):
    fa, pf = gen.memfd("r"), gen.memfd("p")
    try:
        gen.render_fasta(ds, fa)
        gen.render_paf(ds, pf)
        with open(gen.fd_path(fa), "rb") as f:
            fasta = f.read()
        with open(gen.fd_path(pf), "rb") as f:
            paf = f.read()
    finally:
        os.close(fa)
        os.close(pf)
    return fasta, paf


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes(name):
    cfg = config(name)
    a = rendered(gen.make_dataset(cfg, {"n_reads": 300}, 2**31 + 5))
    b = rendered(gen.make_dataset(cfg, {"n_reads": 300}, 2**31 + 5))
    c = rendered(gen.make_dataset(cfg, {"n_reads": 300}, 6))
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_seed_gets_the_same_lengths(name):
    cfg = config(name)
    a = gen.make_dataset(cfg, {"n_reads": 500}, 1, with_genome=False)
    b = gen.make_dataset(cfg, {"n_reads": 500}, 2**40 + 3, with_genome=False)
    assert np.array_equal(np.sort(a.lens), np.sort(b.lens))
    assert not np.array_equal(a.lens, b.lens)
    assert a.families and [f[:2] for f in a.families] == \
        [f[:2] for f in b.families]


@pytest.mark.parametrize("name", CONFIGS)
def test_stated_lengths_coverage_and_rows(name):
    cfg = config(name)
    ds = gen.make_dataset(cfg, {"n_reads": 4000}, 17, with_genome=False)
    rl = cfg["read_length"]
    assert abs(np.median(ds.lens) / rl["median"] - 1) < 0.01
    assert abs(np.std(np.log(ds.lens)) / rl["sigma"] - 1) < 0.02
    assert ds.lens.min() >= rl["min"]
    assert ds.est_cov == cfg["coverage"]
    assert abs(ds.total_bases / ds.genome_size / cfg["coverage"] - 1) < 0.01
    fam_bp = sum(u * c for u, c, _ in ds.families)
    assert cfg["repeats"]["share"] <= fam_bp / ds.genome_size < 0.2
    # true pairs listed once, less the dropped fifth, plus the spurious
    # tenth, plus the repeats' cross-copy pairs
    rows = ds.n_rows / ds.n_reads
    assert 0.8 * cfg["coverage"] * 0.8 < rows < 3 * cfg["coverage"]
    p = ds.paf
    assert (p["a_start"] >= 0).all() and (p["a_end"] <= ds.lens[p["a_id"]]
                                          ).all()
    assert (p["b_start"] >= 0).all() and (p["b_end"] <= ds.lens[p["b_id"]]
                                          ).all()
    assert (p["a_end"] > p["a_start"]).all() and (p["b_end"] > p["b_start"]
                                                  ).all()
    assert (p["a_id"] != p["b_id"]).all()
    assert (np.diff(p["a_id"]) >= 0).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_rendered_inputs_match_the_arrays(name):
    ds = gen.make_dataset(config(name), {"n_reads": 200}, 99)
    fasta, paf = rendered(ds)
    lines = fasta.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 2 * ds.n_reads + 1
    assert [x[1:] for x in lines[0:-1:2]] == ds.names
    assert [len(x) for x in lines[1:-1:2]] == ds.lens.tolist()
    assert len(set(ds.names)) == ds.n_reads
    assert not SIM_RE.fullmatch(ds.names[0])
    rc = gen.COMP[ds.genome[::-1]]
    G = ds.genome_size
    for k in (0, 1, ds.n_reads - 1):
        s, e = int(ds.starts[k]), int(ds.starts[k] + ds.lens[k])
        want = ds.genome[s:e] if ds.fwd[k] else rc[G - e:G - s]
        assert lines[2 * k + 1] == want.tobytes()
    rows = [r.split(b"\t") for r in paf.split(b"\n")[:-1]]
    assert len(rows) == ds.n_rows
    p = ds.paf
    for k in (0, ds.n_rows // 2, ds.n_rows - 1):
        r = rows[k]
        assert r[0] == ds.names[p["a_id"][k]] and r[5] == ds.names[p["b_id"][k]]
        assert [int(r[i]) for i in (1, 2, 3, 6, 7, 8)] == [
            ds.lens[p["a_id"][k]], p["a_start"][k], p["a_end"][k],
            ds.lens[p["b_id"][k]], p["b_start"][k], p["b_end"][k]]
        assert r[4] == (b"+" if p["same_strand"][k] else b"-")
        assert len(r) == 12 and r[11] == b"60"


def test_ascii_ints():
    x = np.array([0, 7, 10, 99, 100, 123456789, 2**40])
    got = gen.squeeze([gen.ascii_ints(x), np.full(len(x), 32, np.uint8)])
    assert got == b"".join(b"%d " % v for v in x.tolist())


@pytest.mark.parametrize("fmt", ["gzip", "bgzf"])
def test_compressed_inputs_read_back(fmt, tmp_path):
    import gzip
    import struct
    data = bytes(np.random.default_rng(3).integers(0, 256, 200_000,
                                                   dtype=np.uint8)) * 3
    src, dst = tmp_path / "x", tmp_path / "x.gz"
    src.write_bytes(data)
    n = gen.compress_file(str(src), str(dst), fmt)
    packed = dst.read_bytes()
    assert n == len(packed) and gzip.decompress(packed) == data
    if fmt == "bgzf":
        # every block names its own size; the last is the empty EOF block
        at, sizes = 0, []
        while at < len(packed):
            assert packed[at:at + 4] == b"\x1f\x8b\x08\x04"
            assert packed[at + 12:at + 16] == b"BC\x02\x00"
            sizes.append(struct.unpack_from("<H", packed, at + 16)[0] + 1)
            at += sizes[-1]
        assert at == len(packed) and len(sizes) == -(-len(data) // 0xFF00) + 1
        assert packed.endswith(gen.BGZF_EOF)
