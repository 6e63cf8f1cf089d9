"""Seconds of the hybrid's pilot (``measure_hybrid_schedule``: a 128×128
render that sets the pool's compaction caps), host clock around the
synchronised call.  Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("pilot")
