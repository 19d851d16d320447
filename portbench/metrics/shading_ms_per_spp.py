"""Device milliseconds of every launch of a traced stretch of rendered
samples that is not a traversal kernel (the shading chain, the sampler,
the camera and the film), per sample."""

from harness.trace import TRAVERSAL_MARK


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "render" or not tr or tr.get("kernels") is None:
        return None
    secs = sum(s for name, s in tr["kernels"] if TRAVERSAL_MARK not in name)
    return 1e3 * secs / tr["units"]
