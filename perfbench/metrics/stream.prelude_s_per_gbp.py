"""Schedule layer (``pipeline._run_pipeline_chunked``): the streaming
prelude, ``index`` + ``load_paf`` + ``group_events`` stage seconds, summed
over the traced window's passes, per input Gbp."""


def read(t):
    if not t.passes or t.passes[0].get("schedule") != "chunked":
        return None
    return t.s_per_gbp("index", "load_paf", "group_events")
