"""Share of the traced steps' device time launched inside `grad.backward`
(`torch.autograd.backward` of pass 2: its kernels come from autograd's
device thread, so they are put down by the time of their launch, not by
thread), in percent of all device time of the traced stretch. Nothing
where the program records no spans or the trace holds no device work."""

from harness import spans


def read(ctx):
    tr = ctx.get("trace") or {}
    by_id = tr.get("span_device_ns")
    tree = spans.tree_of(ctx) if ctx["kind"] == "inverse" else None
    total = sum(by_id.values()) if by_id else 0
    if tree is None or total <= 0:
        return None
    back = sum(ns for sid, ns in by_id.items() if sid in tree.by_id
               and tree.by_id[sid].name == "grad.backward")
    return 100.0 * back / total
