"""tpupt_torch's kd / RBSP / BSP walker against the JAX package's TPU kernel
(`tpupt.ops.traverse_kdbsp`, Pallas) run as the JAX package's own tests run it
on the CPU: one 1024-ray packet in interpret mode. In a file of its own:
compiling the interpreted kernel takes about a minute, so both trees hand it
tables of one shape and share one compile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kdbsp_traverse import _base, _tree
from tpupt_torch.accel import kdbsp

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


CASES = [("kdtree", None), ("rbsp", 3)]


def _prim_rows(accel, ndirs):
    """The tree's packed prim rows with zero rows appended up to the longest
    of CASES (the node tiles of both trees already have one shape). Rows
    past a tree's own are never read, and the jitted kernel, whose compile is
    most of this file's time, then serves both trees."""
    rows = max(len(_tree(a, n)[0][0]["prim_rows"]) for a, n in CASES)
    own = np.asarray(_tree(accel, ndirs)[0][0]["prim_rows"])
    return jnp.asarray(np.pad(own, ((0, rows - len(own)), (0, 0))))


@pytest.mark.parametrize("accel,ndirs", CASES)
def test_walker_matches_pallas_kernel_in_interpret_mode(accel, ndirs):
    """One 1024-ray packet through the JAX package's TPU kernel as its own
    tests run it on the CPU. `t` to rtol=1e-3, the bound its own test holds
    (the packet kernel tests triangles with another epsilon); its counters
    are the packet's, not the ray's, and are not compared."""
    from tpupt.ops.traverse_kdbsp import intersect_kdbsp_packets

    _, (ds_j, st_j), _, o, d, _ = _base()
    (nodes, _, _), (ds_t, st_t) = _tree(accel, ndirs)
    ds_j = ds_j._replace(alt_pack=nodes["pack"],
                         alt_prim_rows=_prim_rows(accel, ndirs))
    o, d = o[:1024], d[:1024]
    inf = np.full(1024, np.inf, np.float32)
    hj, _ = intersect_kdbsp_packets(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(inf), interpret=True,
                                    with_stats=True)
    ht, stt = kdbsp.intersect_kdbsp(ds_t, st_t, torch.from_numpy(o),
                                    torch.from_numpy(d), torch.from_numpy(inf))
    valid = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy()[valid],
                                  np.asarray(hj.prim)[valid])
    np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(hj.t)[valid],
                               rtol=1e-3)
    assert valid.sum() > 300 and int(stt.node_visits.sum()) > 0
