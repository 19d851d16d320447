"""Published peaks of one NVIDIA H100 SXM and the least time of a traversal
call. Frozen copy of `chip_smoke.py`'s constants (lines 362-380) and its
`bound()` arithmetic (line 2797) at commit 2f1d965."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside tensor cores
# per ray: tmax always (4 B), origin and direction when it is live (24 B);
# t, b1, b2, gid, row id and three counters written (32 B)
RAY_LIVE_BYTES, RAY_BYTES = 24, 4 + 32
# float32 operations of one interior-node step (8 x [6 sub, 6 mul, 12 min/max,
# 1 mul, 4 compares, 1 max] + 19 compare-exchanges of 5 ops) and of one
# triangle test (9 sub, 6 shear mul-sub pairs, 3 edge functions of 3 ops,
# t_scaled 5, det 2, 3 z mul, 1 div, 3 mul, ~10 compares)
OPS_PER_NODE = 8 * 30 + 19 * 5
OPS_PER_PRIM = 65


def bound(nbytes: float, ops: float) -> dict:
    """Least time of a call that moves `nbytes` and does `ops`, and which
    of the two sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / FP32_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def traversal_bound(node_visits: float, prim_tests: float, lanes: float,
                    live_lanes: float) -> dict:
    """Least time of a set of traversal calls: the operations of every node
    step and prim test, and only each ray's own bytes in and out (no table
    row), so that it never passes the least time of the calls."""
    ops = OPS_PER_NODE * node_visits + OPS_PER_PRIM * prim_tests
    nbytes = RAY_BYTES * lanes + RAY_LIVE_BYTES * live_lanes
    return bound(nbytes, ops)
