"""Host milliseconds a rendered sample spends in path_li's `bounce` spans
less the `traverse` spans inside them: the shading chain's enqueue time on
the host, mean over the window's samples (spans on, profiler off).
Nothing where the program records no spans."""

from harness import spans


def read(ctx):
    tree = spans.tree_of(ctx) if ctx["kind"] == "render" else None
    units = spans.window_units(ctx, tree) if tree else []
    if not units:
        return None
    ns = 0
    for u in units:
        for b in tree.descendants(u):
            if b.name == "bounce":
                ns += (b.end_ns - b.start_ns) - sum(
                    t.end_ns - t.start_ns for t in tree.descendants(b)
                    if t.name == "traverse")
    return ns / 1e6 / len(units)
