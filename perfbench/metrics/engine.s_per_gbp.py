"""Engine layer (``engine_torch``, ``bucketing``): the program's
``compute`` stage seconds (bucketing, H2D, the device step, D2H, the host
gather), summed over the traced window's passes, per input Gbp."""


def read(t):
    return t.s_per_gbp("compute")
