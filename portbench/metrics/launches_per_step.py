"""Device launches (kernels, copies, fills) the profiler records in a
traced stretch of training steps, per step."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "inverse" or not tr or tr.get("kernels") is None:
        return None
    return tr["launches"] / tr["units"]
