"""Data parallelism over `torch.distributed` for rendering and for the
differentiable-render training step (counterpart of the JAX package's
parallel/mesh.py).

The JAX package splits every wavefront batch's lanes over a device mesh and
lets its compiler insert the reductions. The port runs one process per card,
each with its own host thread, and shards WHOLE wavefront batches: rank r
renders batches b = r, r + size, ... of the renderer's own batches. A
sample's launches are host-bound (one eager PyTorch operation at a time), so
cutting each batch's lanes would leave every rank with all the launches of a
sample; cutting the batches divides them by the number of ranks. Where a film
has fewer batches than ranks, the batch is cut in powers of two (at least
1,024 lanes) until every rank has one.

The scene tables are replicated (read-only). Every rank accumulates its
batches into a film of its own; one `all_reduce(SUM)` over a flat buffer of
the film's rgb, weight, splat and aov after the last sample gives every
rank the same film. A lane's value does not depend on its batch, so the
ranks' films add up to one process's: to the bit where a pixel took at most
two samples (a sum of two is the same in either order), in the last bits
where it took more, which a card's atomic adds order differently within
one process too; BDPT's splats land anywhere and are summed in another
order. The training step reduces its loss and every
table's gradient the same way, in one buffer, and applies the SGD update on
every rank, so the parameters stay identical.

One process drives one device: a list of several devices in one process
raises ValueError. Start one process a card (`torchrun --nproc-per-node N`,
or `init_distributed(coordinator, num_processes, process_id)` in each) or
`spawn` ranks on one machine.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators.path import (BATCH_RAYS, Renderer,
                                          sph_shade_table, tri_shade_table)

# every parameter table of the JAX package's step: diffuse / specular
# albedo, roughness, light radiance, the environment map's texels, the
# texture atlas (per-texel gradients) and the two camera matrices
PARAMS = ("mat_kd", "mat_ks", "mat_roughness", "light_L", "env_map",
          "tex_atlas", "raster_to_camera", "cam_to_world")
# the smallest batch the sharded renderer cuts to
MIN_BATCH = 1024
# how long a collective or the rendezvous waits before it fails
TIMEOUT_S = 600.0

_ONE_DEVICE = ("one process drives one device: start one process a device "
               "(torchrun, or init_distributed in each) and build the mesh "
               "there with make_mesh()")


class Mesh(NamedTuple):
    """The ranks a render or a training step is sharded over: a process
    group (None for a mesh of one), this process's rank in it, its size,
    the device this process drives, and the axis name (the JAX package's
    mesh axis; nothing reads it)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "rays"


# the device init_distributed bound this process to
_bound_device = None


def _cuda_or_raise(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, device=None, backend: str = None,
                     timeout_s: float = TIMEOUT_S):
    """Join a torch.distributed job; returns (rank, world size), as the
    JAX package's does. Call it on every process before `make_mesh`.

    With no arguments it reads the job from the environment (`env://`:
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them);
    else it meets the others at `coordinator` ("HOST:PORT", or an init
    method URL such as "file:///shared/path") as process `process_id` of
    `num_processes`.

    `device`: "cuda" (the default) binds the process to card LOCAL_RANK
    (else rank % the cards present) and raises without a card; "cpu" runs
    the ranks on the CPU; a "cuda:i" binds that card. `backend`: nccl for a
    card and gloo for the CPU unless given (gloo also reduces CUDA
    tensors: two ranks sharing one card cannot share an NCCL
    communicator)."""
    global _bound_device
    device = torch.device("cuda" if device is None else device)
    _cuda_or_raise(device)
    if coordinator is None and num_processes is None:
        init_method, kw = "env://", {}
        rank = int(os.environ.get("RANK", 0))
    else:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
        kw = dict(world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None
                                  else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _bound_device = device
    return dist.get_rank(), dist.get_world_size()


def make_mesh(devices=None, axis: str = "rays") -> Mesh:
    """The mesh of this process: every rank of the torch.distributed job
    when there is one (`init_distributed`), else a mesh of one.

    `devices`: None, a device, or a list of one: the device this process
    drives (by default the one `init_distributed` bound, else the card; pass
    "cpu" for the CPU). A list of several raises ValueError: one host
    thread launching for several cards is as host-bound as one card."""
    if isinstance(devices, (list, tuple)):
        if len(devices) > 1:
            raise ValueError(f"a mesh of {len(devices)} devices in one "
                             f"process: {_ONE_DEVICE}")
        devices = devices[0] if devices else None
    if dist.is_available() and dist.is_initialized():
        device = torch.device(devices if devices is not None
                              else _bound_device or "cuda")
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                    device, axis)
    return Mesh(None, 0, 1, torch.device(devices if devices is not None
                                         else "cuda"), axis)


def sharded_batch(n_pixels: int, size: int) -> int:
    """The renderer's batch for `n_pixels` lanes (`Renderer`'s rule), cut
    in powers of two, not below MIN_BATCH, until each of `size` ranks has
    a batch."""
    batch = min(BATCH_RAYS,
                1 << int(np.ceil(np.log2(max(n_pixels, MIN_BATCH)))))
    while batch > MIN_BATCH and -(-n_pixels // batch) < size:
        batch //= 2
    return batch


def _all_reduce(tensors, mesh: Mesh):
    """Sum `tensors` (float32) over the mesh in one flat buffer; returns
    them reduced, in their shapes."""
    if mesh.group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ShardedRenderer:
    """Data-parallel renderer: whole wavefront batches sharded over the
    mesh, the scene replicated, the ranks' films summed by one all-reduce.
    Call it on every rank.

    It runs the base Renderer's own `_step`, so it carries what one card
    renders: path, volpath, directlighting, whitted, ambientocclusion, BDPT
    with its t == 1 splats, crop windows, max_sample_luminance, the
    counters' AOVs under `collect_stats`, spectral transport. MLT and SPPM
    render through their own drivers (integrators/mlt.py, sppm.py), which
    are not sharded, as in the JAX package's CLI. `base` is the renderer
    to shard (its batch is cut where the ranks outnumber its batches);
    else one is built on the mesh's device."""

    def __init__(self, scene, mesh: Mesh = None, light_strategy: str = None,
                 base: Renderer = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.base = base if base is not None else Renderer(
            scene, device=self.mesh.device, light_strategy=light_strategy)
        batch = sharded_batch(self.base.n_pixels, self.mesh.size)
        if batch != self.base.batch:
            self.base.set_batch(batch)
        self.batch, self.n_batches = self.base.batch, self.base.n_batches
        # this rank's batches
        self.batches = list(range(self.mesh.rank, self.n_batches,
                                  self.mesh.size))

    @torch.no_grad()
    def render(self, spp: int = None, verbose: bool = False):
        """The film of `spp` samples, the same on every rank."""
        spp = spp or self.base.scene.sampler.spp
        film = self.base.new_film()
        t0 = time.time()
        for s in range(spp):
            for b in self.batches:
                film = self.base._step(film, s, b)
            if verbose and self.mesh.rank == 0:
                _sync(self.mesh.device)
                print(f"  sample {s + 1}/{spp}  ({time.time() - t0:.1f}s, "
                      f"rank 0 of {self.mesh.size})", flush=True)
        film = filmmod.Film(*_all_reduce(film, self.mesh))
        self.base._spp_rendered = spp
        return film

    def image(self, film):
        # splats are scaled by 1 / the samples in the film, as one card's
        return self.base.image(film)


def scaling_curve(scene, device_counts=None, spp: int = 2):
    """Rays/s on growing sub-meshes and the efficiency against one rank:
    [{n_devices, rays_per_s, efficiency}], the same list on every rank.
    Call it on every rank. For each count c, ranks 0..c-1 render `spp`
    samples (after one to warm up) through a sub-group while the others
    wait; the time is the slowest member's. `device_counts` defaults to
    the powers of two up to the world's size."""
    mesh = make_mesh()
    if device_counts is None:
        device_counts = [1 << k for k in range(mesh.size.bit_length())]
    base = Renderer(scene, device=mesh.device)
    npix = scene.film.xres * scene.film.yres
    out = []
    for c in device_counts:
        if c > mesh.size:
            raise ValueError(f"{c} devices asked for in a world of "
                             f"{mesh.size}")
        group = (dist.new_group(list(range(c)),
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
                 if mesh.group is not None else None)
        dt = 0.0
        if mesh.rank < c:
            sr = ShardedRenderer(scene, Mesh(group, mesh.rank, c, mesh.device,
                                             mesh.axis), base=base)
            sr.render(spp=1)
            _sync(mesh.device)
            t0 = time.time()
            sr.render(spp=spp)
            _sync(mesh.device)
            dt = (time.time() - t0) / spp
        if mesh.group is not None:
            t = torch.tensor([dt], dtype=torch.float64, device=mesh.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
            dt = float(t)
        rps = npix / dt
        first = out[0]["rays_per_s"] if out else rps
        out.append({"n_devices": c, "rays_per_s": rps,
                    "efficiency": rps / (first * c)})
    return out


def train_step_fn(scene, mesh, target, device="cuda", tables=None,
                  spectral: bool = False):
    """A training step: forward render of every ray -> L2 loss of per-ray
    radiance against `target` -> reverse-mode gradients with respect to the
    parameter tables (traversal detached) -> SGD update.

    Every integrator `Renderer` renders is differentiated
    (GRADIENT_INTEGRATORS in integrators/path.py).

    `mesh`: a `Mesh` (make_mesh) to shard the step's batches over, each
    rank taking its own as the sharded renderer does; or None, or a
    sequence of one device, for a step on one device (`device`, or that
    one). A sequence of several devices raises ValueError. `target` (H, W,
    3) image. `tables` and `spectral` as for `Renderer`.

    The per-ray radiance is the film's estimator, `Renderer._radiance`: the
    scene's integrator (volpath for a scene with media), its transport
    (spectral or RGB), and bad samples (non-finite, or of luminance below
    -1e-5) black. The JAX package's step calls its path integrator in RGB
    whatever the scene and compares the raw radiance (ROADMAP.md section
    3). Under BDPT the per-ray radiance leaves out the t == 1 strategies,
    which splat onto other pixels and have no camera ray of their own: the
    loss compares the camera rays' part of the image only (ROADMAP.md
    section 3).

    Returns (step, params0): `step(params, sample_idx, lr) -> (loss,
    new_params)`, `params0` the scene's own tables by the names of `PARAMS`.
    The loss is sum over valid rays of |L - target[pixel]|^2 divided by the
    number of valid rays of the whole film, the JAX package's; it is a sum
    over rays, so each wavefront batch takes its forward and backward pass
    at once and frees its graph, and the gradients add up over the batches.
    On a mesh the loss and every table's gradient are summed over the ranks
    in one all-reduce, and every rank applies the same update. The camera
    rays are the renderer's own (its lens samples; the JAX package's step
    passes zeros, which is the same for a pinhole camera)."""
    if not isinstance(mesh, Mesh):
        devices = [device] if mesh is None else list(mesh)
        if len(devices) > 1:
            raise ValueError(f"a training step over {len(devices)} devices "
                             f"in one process: {_ONE_DEVICE}")
        mesh = Mesh(None, 0, 1, torch.device(devices[0] if devices
                                             else device))
    base = Renderer(scene, device=mesh.device, tables=tables,
                    spectral=spectral)
    if mesh.size > 1:
        base.set_batch(sharded_batch(base.n_pixels, mesh.size))
    mine = range(mesh.rank, base.n_batches, mesh.size)
    cfg = base.cfg
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=base.device).reshape(-1, 3)
    n_valid = max(int(base._valid_b.sum()), 1)
    params0 = {k: getattr(base.ds, k) for k in PARAMS}

    def step(params, sample_idx, lr):
        leaves = {k: v.detach().to(base.device).requires_grad_()
                  for k, v in params.items()}
        ds = base.ds._replace(**leaves)
        loss = torch.zeros((), device=base.device)
        with torch.enable_grad():
            tables = (tri_shade_table(ds), sph_shade_table(ds))
            for b in mine:
                # (BDPT's splats, the fourth value, are left out)
                _, L, *_ = base._radiance(ds, sample_idx, b,
                                          tables=tables, with_stats=False)
                pix = base._py_b[b] * cfg.xres + base._px_b[b]
                tgt = target[pix.long()]
                err = torch.where(base._valid_b[b][:, None], L - tgt, 0.0)
                loss_b = torch.sum(err * err) / n_valid
                if loss_b.requires_grad:
                    torch.autograd.backward(loss_b,
                                            inputs=list(leaves.values()))
                loss = loss + loss_b.detach()
        grads = [v.grad if v.grad is not None else torch.zeros_like(v)
                 for v in leaves.values()]
        loss, *grads = _all_reduce([loss] + grads, mesh)
        new = {k: (v - lr * g).detach()
               for (k, v), g in zip(leaves.items(), grads)}
        return loss, new

    return step, params0


def _rank_main(fn, rank, world, init_method, device, backend, timeout_s,
               threads, out_path, args):
    """A spawned rank: join the job, run fn(mesh, *args), save its result
    (or the traceback) for the parent, leave the job."""
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(init_method, world, rank, device=device,
                         backend=backend, timeout_s=timeout_s)
        result = fn(make_mesh(), *args)
        torch.save(result, out_path)
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, args=(), device=None, backend: str = None,
          timeout_s: float = TIMEOUT_S, threads: int = None):
    """Run `fn(mesh, *args)` on `world` ranks, each a process of its own on
    this machine, and return the ranks' results in rank order. `fn` is a
    module-level function (the children import it); the ranks meet through
    a file in a fresh temporary directory. `device`, `backend` as for
    `init_distributed` ("cpu" runs the ranks on the CPU over gloo);
    `threads` sets each rank's intra-op threads.

    A rank that fails or outlives `timeout_s` makes it raise
    (RuntimeError with the rank's traceback, or TimeoutError) after every
    rank still running has been killed: no rank is left waiting on a
    collective."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpupt_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, init, device, backend, timeout_s, threads,
            outs[r], tuple(args))) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout_s
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = (open(outs[r] + ".err").read()
                           if os.path.exists(outs[r] + ".err") else "")
                    raise RuntimeError(f"rank {r} of {world} exited with code "
                                       f"{codes[r]}\n{err}")
                if all(c == 0 for c in codes):
                    break
                if time.time() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(f"ranks {running} of {world} still "
                                       f"running after {timeout_s} s")
                procs[codes.index(None)].join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(30)
        return [torch.load(o, map_location="cpu", weights_only=False)
                for o in outs]
