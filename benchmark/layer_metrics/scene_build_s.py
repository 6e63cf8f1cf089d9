"""Seconds of the program's scene build (triangle tables, LBVH, cluster
BVH, the engine's kernel tables, the camera), host clock around the
synchronised call.  Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("scene_build")
