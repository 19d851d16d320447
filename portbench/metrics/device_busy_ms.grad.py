"""Device-busy milliseconds a training step: the union of the device
intervals of the traced stretch of steps after the window, over its
steps. Numerator and denominator both come from the trace; the profiler
slows the host's launches, not the device's work."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "inverse" or not tr or tr.get("kernels") is None:
        return None
    return 1e3 * tr["busy_s"] / tr["units"]
