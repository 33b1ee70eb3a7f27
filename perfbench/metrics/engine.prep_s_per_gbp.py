"""Engine layer (``engine_torch.compute_torch``, ``bucketing``): the host
preparation of the traced run's profiled pass, per input Gbp: the spans
``engine.events`` (and ``engine.sort`` where the events come ungrouped),
``engine.cov_events`` and every bucket's ``engine.bucket_prep``."""

from perfbench import spans


def read(t):
    return spans.span_s_per_gbp(t, "engine.events", "engine.sort",
                                "engine.cov_events", "engine.bucket_prep")
