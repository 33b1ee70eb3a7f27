"""raft_tpu_torch's copy of ``raft_tpu/io/__init__.py``."""

from raft_tpu_torch.io.fasta import ReadStore, load_reads
from raft_tpu_torch.io.paf import OverlapTable, load_paf

__all__ = ["ReadStore", "load_reads", "OverlapTable", "load_paf"]
