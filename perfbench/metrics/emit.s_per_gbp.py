"""Emit layer (``emit``, the native emitters): the program's ``emit``
stage seconds, summed over the traced window's passes, per input Gbp.
Whole-file schedule only (streaming's ``emit`` is the final drain)."""


def read(t):
    if not t.passes or t.passes[0].get("schedule") != "whole":
        return None
    return t.s_per_gbp("emit")
