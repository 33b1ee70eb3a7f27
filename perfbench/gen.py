"""The benchmark's traffic generator: one general generator, driven by a
configuration file (the deployment: read lengths, coverage, repeats, PAF
noise, read names) and a traffic file (how many reads a run hands over).

The model is the one of the port's ``tools/simulate.py`` (itself the
upstream ``bash_scripts/simulate.sh`` without external tools): a genome
slice with exact repeat families pasted at several loci, reads drawn from
it on either strand with log-normal lengths, and an all-vs-all PAF made of
the true overlaps between reads, the overlaps an aligner finds between
reads on different copies of one repeat family, and drop / spurious /
endpoint-jitter noise. This copy differs in what makes it a benchmark:

* vectorised, so a 2.5 GB input takes seconds, not minutes;
* real-style read names, so the program stays in its real-reads path;
* every seed gets the same set of read lengths (the log-normal's
  quantiles, shuffled) and the same set of repeat families (sizes and
  copy numbers from the configuration, placed by the seed), so the work
  of a run does not change with the seed;
* each part draws from its own stream of the seed, so the reference can
  rebuild the arrays it needs without the genome.

The inputs are rendered into file descriptors (the harness's input files;
the tests also use anonymous in-memory files, ``memfd``), and compressed
where a traffic mix asks for gzip or BGZF inputs.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import mmap
import os
import statistics
import struct
import zlib

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")

# part streams of one seed
_S_LENS, _S_GENOME, _S_FAMS, _S_READS, _S_NAMES, _S_NOISE = range(6)

POW10 = 10 ** np.arange(19, dtype=np.int64)


def rng_for(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), part])


@dataclasses.dataclass
class Dataset:
    """What one seed makes of a configuration and a traffic mix. The
    genome (and the sequences) exist only where ``with_genome`` asked."""
    genome_size: int
    est_cov: int
    lens: np.ndarray          # int64 [n]
    starts: np.ndarray        # int64 [n], genome coordinates
    fwd: np.ndarray           # bool [n]
    names: list               # bytes [n]
    families: list            # (unit length, copies, [copy starts])
    paf: dict                 # int64 columns a_id b_id a_start a_end
    #                           b_start b_end, bool same_strand
    genome: np.ndarray | None = None

    @property
    def n_reads(self) -> int:
        return len(self.lens)

    @property
    def total_bases(self) -> int:
        return int(self.lens.sum())

    @property
    def n_rows(self) -> int:
        return len(self.paf["a_id"])

    def fasta_layout(self) -> tuple[np.ndarray, np.ndarray]:
        """(record start, sequence start) of each read in the FASTA that
        ``render_fasta`` writes: ``>name\\nSEQ\\n`` per read."""
        nl = np.fromiter((len(x) for x in self.names), np.int64,
                         self.n_reads)
        rec = np.zeros(self.n_reads + 1, np.int64)
        np.cumsum(nl + self.lens + 3, out=rec[1:])
        return rec, rec[:-1] + nl + 2


def read_lengths(cfg: dict, n: int) -> np.ndarray:
    """The log-normal's n quantiles (midpoints), rounded and clipped to
    the configuration's minimum: the same lengths for every seed."""
    rl = cfg["read_length"]
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    lens = np.round(rl["median"] * np.exp(rl["sigma"] * z)).astype(np.int64)
    return np.maximum(lens, rl["min"])


def repeat_families(cfg: dict, genome_size: int) -> list[tuple[int, int]]:
    """(unit length, copies) of each family until the families cover the
    configured share of the slice: unit lengths spread evenly over the
    configured range (golden-ratio steps), copy numbers cycling through
    theirs. The same list for every seed."""
    rp = cfg["repeats"]
    lo, hi = rp["unit_min"], rp["unit_max"]
    c_lo, c_hi = rp["copies_min"], rp["copies_max"]
    out, acc, k = [], 0, 0
    while acc < rp["share"] * genome_size:
        u = int(lo + (hi - lo) * ((k * 0.6180339887498949) % 1.0))
        c = c_lo + k % (c_hi - c_lo + 1)
        out.append((u, c))
        acc += u * c
        k += 1
    return out


def _names(cfg: dict, n: int, seed: int) -> list[bytes]:
    rng = rng_for(seed, _S_NAMES)
    style = cfg["read_names"]
    if style == "pacbio_ccs":
        # movie/zmw/ccs, ZMW numbers rising through the file as a SMRT
        # cell's do, the reads spread over the configured movies
        movies = cfg["movies"]
        zmw = np.cumsum(rng.integers(1, 2 * 180_000_000 // n + 2, n))
        per = -(-n // len(movies))
        return [f"{movies[i // per]}/{int(z)}/ccs".encode()
                for i, z in enumerate(zmw)]
    if style == "ont_duplex":
        # template;complement read ids, as duplex basecallers name them
        raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40     # uuid4 version nibble
        raw[:, 22] = (raw[:, 22] & 0x0F) | 0x40
        raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80      # RFC 4122 variant
        raw[:, 24] = (raw[:, 24] & 0x3F) | 0x80
        out = []
        for r in raw:
            h = r.tobytes().hex()
            a, b = h[:32], h[32:]
            out.append(f"{a[:8]}-{a[8:12]}-{a[12:16]}-{a[16:20]}-{a[20:]};"
                       f"{b[:8]}-{b[8:12]}-{b[12:16]}-{b[16:20]}-{b[20:]}"
                       .encode())
        return out
    raise ValueError(f"unknown read_names style {style!r}")


def _to_read(s, e, fwd, lo, hi):
    """Genome interval [lo, hi) on read [s, e) in the read's own forward
    coordinates (flipped for a reverse-strand read)."""
    return np.where(fwd, lo - s, e - hi), np.where(fwd, hi - s, e - lo)


def _true_pairs(starts, ends, min_ovl):
    """Every pair of reads whose genome intervals share >= min_ovl bp,
    once: with reads sorted by start, read i's partners are the later
    reads starting at or before its end - min_ovl (reads are longer than
    min_ovl, so no other test is needed)."""
    order = np.argsort(starts, kind="stable")
    s_sorted = starts[order]
    hi = np.searchsorted(s_sorted, ends[order] - min_ovl, side="right")
    cnt = np.maximum(hi - np.arange(len(order)) - 1, 0)
    ip = np.repeat(np.arange(len(order)), cnt)
    first = np.zeros(len(order) + 1, np.int64)
    np.cumsum(cnt, out=first[1:])
    jp = ip + 1 + (np.arange(len(ip)) - first[ip])
    return order[ip], order[jp]


def _cross_pairs(starts, ends, families, min_ovl, max_len):
    """Pairs of reads on different copies of one family, aligned over the
    part of the unit both cover (>= min_ovl bp): what an all-vs-all
    aligner reports for a repeat. Returns (i, j, i_lo, i_hi, j_lo, j_hi)
    in genome coordinates."""
    order = np.argsort(starts, kind="stable")
    s_sorted = starts[order]
    out = []
    for unit, _, copy_starts in families:
        hit_r, hit_lo, hit_hi, hit_c = [], [], [], []
        for c, cs in enumerate(copy_starts):
            ce = cs + unit
            a, b = np.searchsorted(s_sorted, [cs - max_len, ce])
            r = order[a:b]
            ulo = np.maximum(starts[r], cs) - cs
            uhi = np.minimum(ends[r], ce) - cs
            keep = uhi - ulo >= min_ovl
            hit_r.append(r[keep])
            hit_lo.append(ulo[keep])
            hit_hi.append(uhi[keep])
            hit_c.append(np.full(int(keep.sum()), c))
        r, ulo, uhi, cp = (np.concatenate(x) for x in
                           (hit_r, hit_lo, hit_hi, hit_c))
        a, b = np.triu_indices(len(r), 1)
        lo = np.maximum(ulo[a], ulo[b])
        hi = np.minimum(uhi[a], uhi[b])
        keep = (cp[a] != cp[b]) & (hi - lo >= min_ovl) & (r[a] != r[b])
        a, b, lo, hi = a[keep], b[keep], lo[keep], hi[keep]
        cs = np.asarray(copy_starts, np.int64)
        out.append((r[a], r[b], cs[cp[a]] + lo, cs[cp[a]] + hi,
                    cs[cp[b]] + lo, cs[cp[b]] + hi))
    if not out:
        e = np.empty(0, np.int64)
        return (e,) * 6
    return tuple(np.concatenate(x) for x in zip(*out))


def make_dataset(cfg: dict, traffic: dict, seed: int,
                 with_genome: bool = True) -> Dataset:
    n = int(traffic["n_reads"])
    rng_l = rng_for(seed, _S_LENS)
    lens = rng_l.permutation(read_lengths(cfg, n))
    total = int(lens.sum())
    genome_size = total // int(cfg["coverage"])
    lens = np.minimum(lens, genome_size // 2)
    total = int(lens.sum())
    est_cov = round(total / genome_size)

    fam_sizes = repeat_families(cfg, genome_size)
    rng_f = rng_for(seed, _S_FAMS)
    families = [(u, c, sorted(int(x) for x in
                              rng_f.integers(0, genome_size - u, c)))
                for u, c in fam_sizes]

    rng_r = rng_for(seed, _S_READS)
    starts = (rng_r.random(n) * (genome_size - lens + 1)).astype(np.int64)
    fwd = rng_r.random(n) < 0.5
    ends = starts + lens

    genome = None
    if with_genome:
        rng_g = rng_for(seed, _S_GENOME)
        genome = BASES[rng_g.integers(0, 4, genome_size, dtype=np.uint8)]
        for u, _, copy_starts in families:
            unit = BASES[rng_g.integers(0, 4, u, dtype=np.uint8)]
            for cs in copy_starts:
                genome[cs:cs + u] = unit

    min_ovl = int(cfg["min_overlap"])
    ti, tj = _true_pairs(starts, ends, min_ovl)
    t_lo = starts[tj]
    t_hi = np.minimum(ends[ti], ends[tj])
    ci, cj, ci_lo, ci_hi, cj_lo, cj_hi = _cross_pairs(
        starts, ends, families, min_ovl, int(lens.max()))
    i = np.concatenate([ti, ci])
    j = np.concatenate([tj, cj])
    i_lo = np.concatenate([t_lo, ci_lo])
    i_hi = np.concatenate([t_hi, ci_hi])
    j_lo = np.concatenate([t_lo, cj_lo])
    j_hi = np.concatenate([t_hi, cj_hi])

    noise = cfg["paf_noise"]
    rng_n = rng_for(seed, _S_NOISE)
    keep = rng_n.random(len(i)) >= noise["drop_rate"]
    i, j, i_lo, i_hi, j_lo, j_hi = (x[keep] for x in
                                    (i, j, i_lo, i_hi, j_lo, j_hi))
    qs, qe = _to_read(starts[i], ends[i], fwd[i], i_lo, i_hi)
    ts, te = _to_read(starts[j], ends[j], fwd[j], j_lo, j_hi)
    sd = noise["jitter_sd"]
    if sd > 0:
        jit = np.rint(rng_n.normal(0.0, sd, (4, len(i)))).astype(np.int64)
        qs, qe, ts, te = qs + jit[0], qe + jit[1], ts + jit[2], te + jit[3]
    li, lj = lens[i], lens[j]
    qs = np.clip(qs, 0, li - 1)
    qe = np.clip(qe, qs + 1, li)
    ts = np.clip(ts, 0, lj - 1)
    te = np.clip(te, ts + 1, lj)

    # spurious pairs: random reads, random in-bounds intervals of an
    # overlap-like length (chimeric joins, low-complexity hits)
    n_sp = int(round(noise["spurious_rate"] * len(i)))
    si = rng_n.integers(0, n, n_sp)
    sj = rng_n.integers(0, n, n_sp)
    ok = si != sj
    si, sj = si[ok], sj[ok]
    sl = np.clip(np.rint(rng_n.lognormal(np.log(4000), 0.6, len(si))),
                 min_ovl, np.minimum(lens[si], lens[sj])).astype(np.int64)
    sqs = (rng_n.random(len(si)) * (lens[si] - sl + 1)).astype(np.int64)
    sts = (rng_n.random(len(si)) * (lens[sj] - sl + 1)).astype(np.int64)

    a_id = np.concatenate([i, si])
    b_id = np.concatenate([j, sj])
    a_s = np.concatenate([qs, sqs])
    a_e = np.concatenate([qe, sqs + sl])
    b_s = np.concatenate([ts, sts])
    b_e = np.concatenate([te, sts + sl])
    # the read earlier in the file is the query; rows grouped by query,
    # as an all-vs-all aligner writes them
    swap = a_id > b_id
    a_id, b_id = np.where(swap, b_id, a_id), np.where(swap, a_id, b_id)
    a_s, b_s = np.where(swap, b_s, a_s), np.where(swap, a_s, b_s)
    a_e, b_e = np.where(swap, b_e, a_e), np.where(swap, a_e, b_e)
    order = np.argsort(a_id, kind="stable")
    paf = {k: v[order] for k, v in dict(
        a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e, b_start=b_s,
        b_end=b_e).items()}
    paf["same_strand"] = fwd[paf["a_id"]] == fwd[paf["b_id"]]
    return Dataset(genome_size=genome_size, est_cov=est_cov, lens=lens,
                   starts=starts, fwd=fwd, names=_names(cfg, n, seed),
                   families=families, paf=paf, genome=genome)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def memfd(name: str) -> int:
    """An anonymous in-memory file (the harness's output sinks)."""
    return os.memfd_create(name, os.MFD_CLOEXEC)


def fd_path(fd: int) -> str:
    return f"/proc/self/fd/{fd}"


def render_fasta(ds: Dataset, fd: int, workers: int = 8) -> int:
    """Write the reads as single-line FASTA into ``fd``; returns bytes."""
    rec, seq = ds.fasta_layout()
    size = int(rec[-1])
    os.ftruncate(fd, size)
    g = ds.genome
    rc = COMP[g[::-1]]
    G = len(g)
    ends = ds.starts + ds.lens
    with mmap.mmap(fd, size) as mm:
        buf = np.frombuffer(mm, np.uint8)

        def fill(lo, hi):
            for k in range(lo, hi):
                p, q, L = int(rec[k]), int(seq[k]), int(ds.lens[k])
                nm = ds.names[k]
                buf[p] = 62                       # '>'
                buf[p + 1:q - 1] = np.frombuffer(nm, np.uint8)
                buf[q - 1] = 10
                s, e = int(ds.starts[k]), int(ends[k])
                buf[q:q + L] = g[s:e] if ds.fwd[k] else rc[G - e:G - s]
                buf[q + L] = 10

        step = -(-ds.n_reads // workers)
        with cf.ThreadPoolExecutor(workers) as ex:
            for f in [ex.submit(fill, lo, min(lo + step, ds.n_reads))
                      for lo in range(0, ds.n_reads, step)]:
                f.result()
        del buf
    return size


def ascii_ints(x: np.ndarray, width: int | None = None) -> np.ndarray:
    """(N, width) uint8: each non-negative integer's decimal digits, right
    aligned after NUL padding (NUL never occurs in the text the rows are
    cut into, and ``squeeze`` drops it)."""
    x = np.asarray(x, np.int64)
    if width is None:
        width = int(np.searchsorted(POW10[1:], x.max(initial=0),
                                    side="right")) + 1
    out = np.zeros((len(x), width), np.uint8)
    q = x.copy()
    for k in range(width):
        d = (q % 10).astype(np.uint8) + 48
        out[:, width - 1 - k] = d if k == 0 else np.where(x >= POW10[k], d,
                                                            0)
        q //= 10
    return out


def name_matrix(names: list) -> np.ndarray:
    w = max(len(x) for x in names)
    return np.array(names, dtype=f"S{w}").view(np.uint8).reshape(len(names),
                                                                w)


def squeeze(cols: list) -> bytes:
    """Concatenate per-row byte columns and drop the NUL padding."""
    m = np.concatenate([c if c.ndim == 2 else c[:, None] for c in cols],
                       axis=1)
    return m[m != 0].tobytes()


def _byte_col(n: int, ch: bytes) -> np.ndarray:
    return np.full(n, ch[0], np.uint8)


def render_paf(ds: Dataset, fd: int, block: int = 1 << 17,
               workers: int = 8) -> int:
    """Write the PAF's 12 columns (names, lengths, coordinates, strand,
    matches, block length, mapq 60) into ``fd``; returns bytes."""
    nm = name_matrix(ds.names)
    len_txt = ascii_ints(ds.lens)
    p = ds.paf

    def rows(lo):
        sl = slice(lo, min(lo + block, ds.n_rows))
        a, b = p["a_id"][sl], p["b_id"][sl]
        m = len(a)
        tab = _byte_col(m, b"\t")
        ml = ascii_ints(np.minimum(p["a_end"][sl] - p["a_start"][sl],
                                   p["b_end"][sl] - p["b_start"][sl]))
        strand = np.where(p["same_strand"][sl], ord("+"), ord("-")
                          ).astype(np.uint8)
        return squeeze([
            nm[a], tab, len_txt[a], tab, ascii_ints(p["a_start"][sl]), tab,
            ascii_ints(p["a_end"][sl]), tab, strand, tab, nm[b], tab,
            len_txt[b], tab, ascii_ints(p["b_start"][sl]), tab,
            ascii_ints(p["b_end"][sl]), tab, ml, tab, ml, tab,
            np.tile(np.frombuffer(b"60\n", np.uint8), (m, 1))])

    size = 0
    with cf.ThreadPoolExecutor(workers) as ex:
        for data in ex.map(rows, range(0, ds.n_rows, block)):
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
            size += len(data)
    return size


GZ_LEVEL = 6                   # gzip's and bgzip's default level
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                         "03000000000000000000")


def _gzip_member(data: bytes) -> bytes:
    c = zlib.compressobj(GZ_LEVEL, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: a gzip member with the ``BC`` extra field that
    holds the block's size less one."""
    c = zlib.compressobj(GZ_LEVEL, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    head = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       ord("B"), ord("C"), 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def compress_file(src: str, dst: str, fmt: str, workers: int = 8) -> int:
    """Write ``src`` compressed into ``dst``: ``gzip``, members of 32 MiB
    (one gzip stream to a reader); ``bgzf``, 65,280-byte blocks and the
    end-of-file block, as ``bgzip`` writes them. Returns bytes written."""
    if fmt == "gzip":
        block, one, tail = 1 << 25, _gzip_member, b""
    elif fmt == "bgzf":
        block, one, tail = 0xFF00, _bgzf_block, BGZF_EOF
    else:
        raise ValueError(f"unknown input compression {fmt!r}")
    size = 0
    with open(src, "rb") as f, open(dst, "wb") as out, \
            mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ) as mm, \
            cf.ThreadPoolExecutor(workers) as ex:
        for data in ex.map(lambda lo: one(mm[lo:lo + block]),
                           range(0, len(mm), block)):
            out.write(data)
            size += len(data)
        out.write(tail)
    return size + len(tail)
