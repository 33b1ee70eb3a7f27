"""Emit layer (the native emitters): the thread-seconds that the four
writers of the traced run's profiled pass spent inside write, writev,
pwrite, pwritev and bgzf_write (the counters ``emit.<file>.write_ns``,
summed over shard threads), per input Gbp."""

from perfbench import spans

FILES = ("fasta", "coverage", "repeats", "bed")


def read(t):
    ns = spans.counter_sum(t, [f"emit.{f}.write_ns" for f in FILES])
    return None if ns is None else ns / 1e9 / t.gbp
