"""Device-busy milliseconds a rendered sample: the union of the device
intervals of the traced stretch of samples after the window, over its
samples. Numerator and denominator both come from the trace; the profiler
slows the host's launches, not the device's work."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "render" or not tr or tr.get("kernels") is None:
        return None
    return 1e3 * tr["busy_s"] / tr["units"]
