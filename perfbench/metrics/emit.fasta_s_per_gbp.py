"""Emit layer (``emit.write_fragments_fasta`` and the native
``raftio_emit_frags_full``): the ``emit.fasta`` writer span of the traced
run's profiled pass, on its pool thread, per input Gbp."""

from perfbench import spans


def read(t):
    return spans.span_s_per_gbp(t, "emit.fasta")
