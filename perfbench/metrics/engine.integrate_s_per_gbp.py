"""Engine layer (``engine_torch.compute_torch``): the host gather of every
bucket's results into the flat result, the span ``engine.integrate`` of
the traced run's profiled pass, per input Gbp."""

from perfbench import spans


def read(t):
    return spans.span_s_per_gbp(t, "engine.integrate")
