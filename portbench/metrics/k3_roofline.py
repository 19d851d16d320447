"""K3's (csrc/traverse_treelets.cu) share of its roofline over one
sample rendered with the per-ray counters on: the least time of its calls
(the operations of every node step and prim test the counters record, and
each ray's own bytes; harness/peaks.py) over the device time the profiler
gives its launches, in percent. Nothing where no K3 launch ran."""

from harness import peaks


def read(ctx):
    k3 = ctx.get("k3")
    if not k3 or k3["seconds"] <= 0:
        return None
    b = peaks.traversal_bound(k3["node_visits"], k3["prim_tests"],
                              k3["lanes"], k3["live_closest"])
    return 100.0 * b["bound_s"] / k3["seconds"]
