"""Schedule layer: the seconds the streaming main thread waits on the
chunk loader (the ``load_reads`` stage of the chunked schedule, the sum of
the per-chunk ``wait_load_s``), summed over the traced window's passes,
per input Gbp."""


def read(t):
    if not t.passes or t.passes[0].get("schedule") != "chunked":
        return None
    return t.s_per_gbp("load_reads")
