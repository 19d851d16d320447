"""The port's sharded renderer and training step over two ranks (spawned
processes, gloo on the CPU) against the JAX package's `ShardedRenderer`
and `train_step_fn` on a 2-device submesh of the conftest's 8 virtual CPU
devices, on the JAX package's tables carried across.

The port shards whole batches (48x48 pixels: two batches of 2,048 lanes,
one a rank), the JAX package each batch's lanes; a lane's value depends on
neither. The films are held at the render-parity tolerance of
test_torch_render.py (rgb / weight within rtol 1e-4, atol 1e-5 on at least
99.5 % of the pixels, the bottom-right pixel left out: the JAX film parks
its masked lanes there), the training step's loss within 1e-5 and its
update at test_torch_train.py's tolerance (GRAD_TOL of each table's
largest step). The port's ranks run in a thread of this process while the
JAX side computes."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_mesh_ranks as ranks
from test_torch_gradients import GRAD_TOL, _close_grads, _jax_walkers
from test_differentiable import _SCENE2
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.parallel import mesh as jax_mesh
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import PARAMS, spawn
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

from test_torch_mesh import SPAWN_TIMEOUT_S, room

torch.set_num_threads(1)

RES = 48


def _jax_pair(txt, res=None):
    sj = jax_flatten(jax_parse_string(txt))
    if res is not None:
        sj = jax_with_resolution(sj, res, res)
    rj = JaxRenderer(sj)
    return sj, rj, testscenes.tables_as_numpy(rj.ds, rj.st)


def _spawn_async(pool, fn, args):
    return pool.submit(spawn, fn, 2, args, device="cpu", threads=1,
                       timeout_s=SPAWN_TIMEOUT_S)


def test_two_ranks_render_the_jax_sharded_film():
    txt = room(res=RES)
    sj, rj, (fields, statics) = _jax_pair(txt)
    with ThreadPoolExecutor(1) as pool:
        fut = _spawn_async(pool, ranks.render_tables,
                           (txt, fields, statics, 2))
        sr = jax_mesh.ShardedRenderer(
            sj, jax_mesh.make_mesh(jax.devices()[:2]), base=rj)
        fj = sr.render(spp=2)
        got = fut.result()
    assert torch.equal(got[0]["rgb"], got[1]["rgb"])
    n = RES * RES
    keep = np.ones(n, bool)
    keep[-1] = False
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = got[0][f].numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    assert float(got[0]["weight"].sum()) > 0.9 * 2 * n


def test_two_rank_training_step_matches_jax_on_two_devices(monkeypatch):
    """One step of the port's train_step_fn over two ranks against the JAX
    package's over a 2-device mesh (its walkers jitted, its bounce loop
    unrolled, the step run eagerly): the loss, and the update of every
    table as (p - p_new) / lr."""
    txt = _SCENE2.replace('"02sequence"', '"halton"')
    sj, rj, (fields, statics) = _jax_pair(txt, RES)
    sp = with_resolution(flatten(parse_string(txt)), RES, RES)
    ds, st = from_numpy(fields, statics, device="cpu")
    r = Renderer(sp, device="cpu", tables=(ds._replace(
        mat_kd=ds.mat_kd * 0.5), st))
    target = r.image(r.render(spp=1))
    lr = 1e-3
    with ThreadPoolExecutor(1) as pool:
        fut = _spawn_async(pool, ranks.train_step,
                           (txt, fields, statics, target, lr, (RES, RES)))
        monkeypatch.setattr(jax_mesh, "pick_traversal", _jax_walkers)
        monkeypatch.setattr(jax_mesh, "path_li",
                            functools.partial(jax_path_li, unroll=True))
        jstep, jp0, (px, py, valid) = jax_mesh.train_step_fn(
            sj, jax_mesh.make_mesh(jax.devices()[:2]), target)
        jp0 = {k: jp0[k] for k in PARAMS}
        loss_j, new_j = jstep.__wrapped__(jp0, jnp.uint32(0), px, py, valid,
                                          lr)
        got = fut.result()
    (loss_t, new_t), (loss_1, new_1) = got
    assert loss_t == loss_1
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    p0 = {k: torch.from_numpy(np.array(fields[k])) for k in PARAMS}
    for k in PARAMS:
        assert torch.equal(new_t[k], new_1[k]), k
    steps_t = {k: (p0[k] - new_t[k]) / lr for k in PARAMS}
    steps_j = {k: (np.asarray(jp0[k]) - np.asarray(new_j[k])) / lr
               for k in PARAMS}
    _close_grads(steps_t, steps_j, "two-rank train step", GRAD_TOL)
    assert float(steps_t["mat_kd"].abs().max()) > 0
