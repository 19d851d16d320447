"""Record the hit records of a forward render and hand them back in order.

`Renderer.value_and_grad` renders one sample twice: pass 1 without
autograd, traversing every ray, and pass 2 with autograd, replaying each
batch's shading chain to back-propagate the film's cotangent. Traversal is
detached from the gradients, so pass 2 needs only the hits pass 1 found:
`HitRecorder.record` stands in for the traversal in pass 1 and keeps each
call's hit record, and `HitRecorder.replay()` stands in for it in pass 2 and
returns them in the same order without launching anything. Both keep the
`isect(ds, st, o, d, tmax, any_hit=False, with_stats=True)` interface, so the
path integrator runs unchanged.

A closest-hit call keeps valid / t / prim / b1 / b2 / p_obj (29 B a ray), an
any-hit call its `valid` alone (1 B a ray): the path integrator reads no
other field of a shadow ray's hit. The counters are not kept; a replayed call
returns zeros for them.

The replay is right only if pass 2 traces the very rays pass 1 traced. Each
call keeps a digest of its rays' bits (origin, direction, tmax and, in a
motion scene, the shutter time at which its triangles were lerped), and the replay compares the digest of
the rays it is handed with it; `Replay.finish` raises if any differed or if
the calls do not pair up one for one.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel.traverse import Hit, TraversalStats


def ray_digest(o, d, tmax, *time):
    """Sum of the rays' float32 bit patterns as int64 (their shutter times'
    too, where the traversal is handed them): one number a call, which any
    single changed bit changes (the tests compare the bits themselves)."""
    return sum(x.view(torch.int32).sum(dtype=torch.int64)
               for x in (o, d, tmax, *time))


def _no_grad_in(o, d, tmax):
    if o.requires_grad or d.requires_grad or tmax.requires_grad:
        raise RuntimeError("a traversal input requires grad: the traversal "
                           "must be detached from the gradients")


class HitRecorder:
    """`record` calls `isect` and keeps what it found, call after call."""

    def __init__(self, isect):
        self.isect = isect
        self.calls = []   # (any_hit, Hit or valid, digest of the rays)

    def record(self, ds, st, o, d, tmax, any_hit=False, with_stats=True,
               **kw):
        _no_grad_in(o, d, tmax)
        hit, stats = self.isect(ds, st, o, d, tmax, any_hit=any_hit,
                                with_stats=with_stats, **kw)
        kept = hit.valid if any_hit else Hit(*(x.detach() for x in hit))
        time = () if kw.get("time") is None else (kw["time"],)
        self.calls.append((any_hit, kept, ray_digest(o, d, tmax, *time)))
        return hit, stats

    def replay(self) -> "Replay":
        return Replay(self.calls)


class Replay:
    """The recorded hit records, handed out in call order."""

    def __init__(self, calls):
        self.calls = calls
        self.next = 0
        self.differs = None   # device bool: some call's rays differed

    def __call__(self, ds, st, o, d, tmax, any_hit=False, with_stats=True,
                 time=None):
        _no_grad_in(o, d, tmax)
        if self.next >= len(self.calls):
            raise RuntimeError(f"replay asked for call {self.next + 1} of "
                               f"{len(self.calls)} recorded")
        rec_any, kept, digest = self.calls[self.next]
        if rec_any != any_hit:
            raise RuntimeError(f"replay call {self.next}: any_hit={any_hit}, "
                               f"recorded any_hit={rec_any}")
        self.next += 1
        differs = (ray_digest(o, d, tmax, *(() if time is None else (time,)))
                   != digest).any()
        self.differs = differs if self.differs is None else self.differs | differs
        n = o.shape[0]
        zero = torch.zeros((), dtype=torch.int32, device=o.device).expand(n)
        if any_hit:
            fzero = o.new_zeros(()).expand(n)
            hit = Hit(valid=kept, t=tmax, prim=torch.where(kept, 0, -1).int(),
                      b1=fzero, b2=fzero, p_obj=o.new_zeros(()).expand(n, 3))
        else:
            hit = kept
        return hit, TraversalStats(zero, zero, zero)

    def finish(self):
        """Raise unless every recorded call was replayed, each on the rays
        it was recorded with (one synchronisation)."""
        if self.next != len(self.calls):
            raise RuntimeError(f"replayed {self.next} of {len(self.calls)} "
                               "recorded traversal calls")
        if self.differs is not None and bool(self.differs):
            raise RuntimeError("the replayed rays differ from the recorded "
                               "ones: the gradients would use other rays' hits")
