"""Set-up seconds of the scene: the benchmark's build of the port's
``Scene`` graph and the program's own compile of it (its BVH and
packing: the facade's ``compile_seconds``, or the span around
``Scene.compile``)."""


def read(ctx):
    s = ctx["setup"]
    if "scene_graph_s" not in s or "compile_s" not in s:
        return None
    return s["scene_graph_s"] + s["compile_s"]
