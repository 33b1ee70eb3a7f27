"""Schedule layer: the seconds the streaming main thread waits on the
emit threads, per input Gbp: its waits between chunks (``drain_s`` of the
program's per-chunk trace, ``RAFT_CHUNK_TRACE``) and its final wait after
the last chunk (the ``emit`` stage), summed over the traced window's
passes."""


def read(t):
    if not t.passes or any("chunks" not in p for p in t.passes):
        return None
    secs = sum(c.get("drain_s", 0.0) for p in t.passes
               for c in p["chunks"] if "ci" in c)
    secs += sum(p["stage_seconds"].get("emit", 0.0) for p in t.passes)
    return secs / (t.gbp * len(t.passes))
