"""Parse layer (``io.native``): the program's ``load_reads`` + ``load_paf``
stage seconds, summed over the traced window's passes, per input Gbp.
Whole-file schedule only (streaming's ``load_reads`` is a wait)."""


def read(t):
    if not t.passes or t.passes[0].get("schedule") != "whole":
        return None
    return t.s_per_gbp("load_reads", "load_paf")
