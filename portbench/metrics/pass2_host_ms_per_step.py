"""Host milliseconds a training step spends in `grad.pass2` (the replay of
the shading chain under autograd and `autograd.backward`, batch by batch),
mean over the window's steps (spans on, profiler off). Nothing where the
program records no spans."""

from harness import spans


def read(ctx):
    tree = spans.tree_of(ctx) if ctx["kind"] == "inverse" else None
    units = spans.window_units(ctx, tree) if tree else []
    if not units:
        return None
    ns = sum(s.end_ns - s.start_ns for u in units
             for s in tree.descendants(u) if s.name == "grad.pass2")
    return ns / 1e6 / len(units)
