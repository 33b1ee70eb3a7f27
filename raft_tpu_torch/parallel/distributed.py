"""Multi-host execution on ``torch.distributed``: contiguous read-range
ownership, per-host output shards, and global fragment numbering — the
counterpart of ``raft_tpu/parallel/distributed.py``.

The design is ``raft_tpu``'s:

* every host runs the cheap names-only index pass (names must intern in
  global first-seen order so PAF ids agree), then byte-range-parses
  sequence bytes only for its contiguous read range and materializes only
  the overlap events its range owns (the native PAF binner, one bin per
  host); without the native library every host parses everything and
  keeps its own range;
* compute runs on this process's devices (``compute_torch`` over
  ``make_devices``), sharded when there are several;
* each host writes its slice of the four outputs as shard files; the
  global ``read=N`` numbering is kept by offsetting each host's numbering
  with an exclusive scan of per-host fragment counts (one allgather);
* after a barrier, host 0 concatenates the shards into the single
  byte-identical output.

The two collectives carry host integers only, so the process group is
``gloo`` on every platform: no device tensor crosses processes, and gloo,
unlike NCCL, lets two ranks share one card.

The planning and emit helpers (``shard_ranges`` … ``_slice_table``) are
``raft_tpu``'s, copied unchanged: that module cannot be imported without
jax.
"""

from __future__ import annotations

import datetime

import numpy as np

# How long a collective waits for the other ranks: the longest compute
# skew between hosts must fit inside it. A rank that dies leaves the
# others waiting this long, then raising.
TIMEOUT = datetime.timedelta(minutes=30)


def shard_ranges(n_reads: int, n_hosts: int) -> list[tuple[int, int]]:
    """Contiguous, near-equal read ranges (preserves global read order)."""
    base = n_reads // n_hosts
    extra = n_reads % n_hosts
    out = []
    lo = 0
    for h in range(n_hosts):
        hi = lo + base + (1 if h < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def fragment_offsets(frag_counts: list[int]) -> list[int]:
    """Exclusive scan: host h's first fragment number is offsets[h] + 1."""
    out = [0]
    for c in frag_counts[:-1]:
        out.append(out[-1] + c)
    return out


def shard_path(prefix: str, ext: str, host: int, n_hosts: int) -> str:
    return f"{prefix}{ext}.shard-{host:05d}-of-{n_hosts:05d}"


def concat_shards(prefix: str, ext: str, n_hosts: int,
                  remove: bool = False) -> str:
    """Merge per-host shards into the single reference-identical file."""
    import os
    final = prefix + ext
    with open(final, "wb") as out:
        for h in range(n_hosts):
            p = shard_path(prefix, ext, h, n_hosts)
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        break
                    out.write(chunk)
            if remove:
                os.remove(p)
    return final


def bin_ranges(n_reads: int, n_hosts: int) -> tuple[int, list[tuple[int, int]]]:
    """(chunk, contiguous ranges) aligned to the native PAF binner's
    uniform ``floor(id/chunk)`` bins, so host h's read range IS bin h."""
    chunk = -(-n_reads // n_hosts) if n_reads else 1
    return chunk, [(min(h * chunk, n_reads), min((h + 1) * chunk, n_reads))
                   for h in range(n_hosts)]


def run_distributed(read_path: str, paf_path: str, params,
                    coordinator: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None,
                    strict: bool = True, device: str = "cuda") -> None:
    """Multi-host pipeline. Call once per process, with the same
    arguments apart from ``process_id``.

    ``coordinator`` is rank 0's ``host:port``; with it None, the process
    group reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` from the environment (``torchrun`` and cluster launchers
    set them), and ``num_processes``/``process_id`` may be None too.
    Compute runs on every card this process sees
    (``make_devices(None, device)``); a launcher gives each process its
    cards with ``CUDA_VISIBLE_DEVICES``. ``device="cpu"`` runs on the CPU.

    Failure semantics, as in ``raft_tpu``: no elastic recovery or
    checkpointing. The run has two synchronization points (the
    fragment-count allgather and the emit barrier); if a process dies,
    the others wait in the next collective for ``TIMEOUT`` and then
    raise — rerun the whole job. Host 0 concatenates the shards only
    after the barrier, so a failed run never leaves a truncated final
    file (stale ``*.shard-*`` files may remain and are overwritten on
    rerun)."""
    import torch.distributed as dist

    dist.init_process_group(
        backend="gloo",
        init_method=(f"tcp://{coordinator}" if coordinator is not None
                     else "env://"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=TIMEOUT)
    try:
        from raft_tpu_torch.parallel.mesh import make_devices
        _run(read_path, paf_path, params, strict, make_devices(None, device),
             dist.get_world_size(), dist.get_rank())
    finally:
        dist.destroy_process_group()


def _run(read_path, paf_path, params, strict, devices, H: int,
         h: int) -> None:
    """Byte-range ingest of this host's read range, compute, emit."""
    from raft_tpu.io import native
    from raft_tpu_torch.engine_torch import compute_torch

    idx = native.index_reads(read_path)
    if idx is not None and idx["n"] > 0:
        n = idx["n"]
        chunk, ranges = bin_ranges(n, H)
        lo, hi = ranges[h]
        bins = native.bin_paf_events(paf_path, idx, n, chunk)
        if bins is None:
            idx = None  # PAF side unavailable → whole-parse fallback
    if idx is None or idx["n"] == 0:
        return _run_distributed_wholeparse(read_path, paf_path, params,
                                           H, h, devices)
    try:
        if strict and bins.n_unknown:
            raise ValueError(
                f"PAF names {bins.n_unknown} read(s) absent from the input "
                "FASTA (undefined behavior in reference RAFT); "
                "pass strict=False to drop them")
        symmetric = bins.symmetric
        params = params.replace(real_reads=idx["real_reads"],
                                symmetric_overlaps=symmetric)

        rec_off = idx["rec_off"]
        if hi > lo:
            sub_store = native.load_reads_range(
                idx["data_path"], int(rec_off[lo]), int(rec_off[hi]),
                fastq=idx["fastq"])
            sub_store.real_reads = params.real_reads
            if not params.real_reads:
                native.attach_sim_meta(sub_store)
            er, el, eh = bins.events_for_bin(h)
            sub_table = _EventView(er - lo, el, eh, symmetric)
        else:  # more hosts than reads: empty shard
            sub_store = _empty_store(params.real_reads)
            z = np.empty(0, dtype=np.int32)
            sub_table = _EventView(z, z.copy(), z.copy(), symmetric)
    finally:
        bins.close()

    res = compute_torch(sub_store, sub_table, params, strict=False,
                        devices=devices)
    _allgather_and_emit(params, sub_store, res, h, H, lo)


def _run_distributed_wholeparse(read_path: str, paf_path: str, params,
                                H: int, h: int, devices) -> None:
    """Fallback: every host parses everything; the owned-range restriction
    keeps device + emit work local."""
    from raft_tpu.io.fasta import load_reads
    from raft_tpu.io.paf import load_paf
    from raft_tpu_torch.engine_torch import compute_torch

    store = load_reads(read_path)
    table = load_paf(paf_path, store)
    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)

    _, ranges = bin_ranges(store.n_reads, H)
    lo, hi = ranges[h]
    sub_store = _slice_store(store, lo, hi)
    sub_table = _slice_table(table, lo, hi)

    # strict=False: sliced tables deliberately carry FOREIGN partner ids
    res = compute_torch(sub_store, sub_table, params, strict=False,
                        devices=devices)
    _allgather_and_emit(params, sub_store, res, h, H, lo)


def _allgather_and_emit(params, sub_store, res, h: int, H: int,
                        lo: int) -> None:
    """Exclusive-scan the fragment numbering across hosts, write this
    host's shard, and concatenate on host 0."""
    import torch
    import torch.distributed as dist

    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(H)]
    dist.all_gather(counts, torch.tensor([res.n_frags], dtype=torch.int64))
    offset = int(sum(int(c) for c in counts[:h]))

    prefix = params.outputfilename
    emit_host_shard(prefix, sub_store, params, res, host=h, n_hosts=H,
                    first_read_num=offset + 1, first_read_index=lo)
    dist.barrier()
    if h == 0:
        for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                    ".long_repeats.bed"):
            concat_shards(prefix, ext, H, remove=True)


class _EventView:
    """Pre-restricted, id-rebased event table (OverlapTable.events()
    contract) for a host's owned read range."""

    def __init__(self, ev_read, ev_lo, ev_hi, symmetric):
        self._ev = (np.ascontiguousarray(ev_read, dtype=np.int32),
                    np.ascontiguousarray(ev_lo, dtype=np.int32),
                    np.ascontiguousarray(ev_hi, dtype=np.int32))
        self.symmetric = symmetric
        self.n_rows = len(ev_read)

    def events(self, n_reads, strict=True):
        return self._ev


def _empty_store(real_reads: bool):
    from raft_tpu.io.fasta import ReadStore
    return ReadStore(names=[], seq_blob=b"",
                     seq_off=np.zeros(1, dtype=np.int64),
                     lens=np.empty(0, dtype=np.int32),
                     real_reads=real_reads)


def emit_host_shard(prefix: str, sub_store, params, res, host: int,
                    n_hosts: int, first_read_num: int,
                    first_read_index: int) -> None:
    """Write one host's slice of all four outputs as shard files whose
    byte concatenation equals the single-host output."""
    from raft_tpu import emit
    emit.write_fragments_fasta(
        shard_path(prefix, ".reads.fasta", host, n_hosts),
        sub_store, params, res, first_read_num=first_read_num)
    emit.write_coverage(
        shard_path(prefix, ".coverage.txt", host, n_hosts),
        params.reso, res, first_read_index=first_read_index)
    emit.write_long_repeats(
        shard_path(prefix, ".long_repeats.txt", host, n_hosts),
        res, first_read_index=first_read_index)
    bed = shard_path(prefix, ".long_repeats.bed", host, n_hosts)
    emit.write_long_repeats_bed(bed, sub_store, res)


def _slice_store(store, lo, hi):
    import dataclasses as dc
    sub_off = store.seq_off[lo:hi + 1] - store.seq_off[lo]
    blob = store.seq_blob[int(store.seq_off[lo]):int(store.seq_off[hi])]
    sub = dc.replace(
        store, names=store.names[lo:hi], seq_blob=blob,
        seq_off=np.asarray(sub_off), lens=store.lens[lo:hi])
    if not store.real_reads:
        sub.start_pos = store.start_pos[lo:hi]
        sub.end_pos = store.end_pos[lo:hi]
        if store.align is not None:  # native path leaves these None —
            sub.align = store.align[lo:hi]   # emitters re-derive from
            sub.chrom = store.chrom[lo:hi]   # the sub-store's own names
    return sub


def _slice_table(table, lo, hi):
    """Keep rows contributing events to [lo, hi) and rebase ids.

    A row contributes an A-side event to a_id and (when asymmetric and
    a≠b) a B-side event to b_id; rows touching only foreign reads drop.
    Foreign ids in kept rows are clamped out of range so ``events()``
    treats them as unknown — they are only ever used as the partner side.
    """
    import dataclasses as dc
    n_local = hi - lo
    a_in = (table.a_id >= lo) & (table.a_id < hi)
    b_in = (table.b_id >= lo) & (table.b_id < hi)
    keep = a_in | b_in
    FOREIGN = n_local  # id >= n_reads → dropped by events(strict=False)
    a = np.where(a_in[keep], table.a_id[keep] - lo, FOREIGN).astype(np.int32)
    b = np.where(b_in[keep], table.b_id[keep] - lo, FOREIGN).astype(np.int32)
    return dc.replace(
        table, a_id=a, b_id=b,
        a_start=table.a_start[keep], a_end=table.a_end[keep],
        b_start=table.b_start[keep], b_end=table.b_end[keep])
