"""A differentiable-render training step on one device (counterpart of the
JAX package's parallel/mesh.py `train_step_fn`).

The JAX package shards the rays of the step over a device mesh and lets its
compiler insert the all-reduce of loss and gradients. Here the step runs on
one device: the ray-batch data parallelism over several cards, one
`torch.distributed` all-reduce of the gradients, is ROADMAP.md queue 1,
item 13, and a `mesh` of more than one device raises until then."""

from __future__ import annotations

import torch

from tpupt_torch.integrators.path import (Renderer, sph_shade_table,
                                          tri_shade_table)

# every parameter table of the JAX package's step: diffuse / specular
# albedo, roughness, light radiance, the environment map's texels, the
# texture atlas (per-texel gradients) and the two camera matrices
PARAMS = ("mat_kd", "mat_ks", "mat_roughness", "light_L", "env_map",
          "tex_atlas", "raster_to_camera", "cam_to_world")


def train_step_fn(scene, mesh, target, device="cuda", tables=None,
                  spectral: bool = False):
    """A training step: forward render of every ray -> L2 loss of per-ray
    radiance against `target` -> reverse-mode gradients with respect to the
    parameter tables (traversal detached) -> SGD update.

    The scene's integrator is `path` or `volpath`; the others raise
    NotImplementedError (ROADMAP.md queue 1, item 12).

    `mesh`: None, or a sequence of devices; with more than one device it
    raises NotImplementedError, with one the step runs there instead of on
    `device`. `target` (H, W, 3) image. `tables` and `spectral` as for
    `Renderer`.

    The per-ray radiance is the film's estimator, `Renderer._radiance`: the
    scene's integrator (volpath for a scene with media), its transport
    (spectral or RGB), and bad samples (non-finite, or of luminance below
    -1e-5) black. The JAX package's step calls its path integrator in RGB
    whatever the scene and compares the raw radiance (ROADMAP.md section
    3).

    Returns (step, params0): `step(params, sample_idx, lr) -> (loss,
    new_params)`, `params0` the scene's own tables by the names of `PARAMS`.
    The loss is sum over valid rays of |L - target[pixel]|^2 divided by the
    number of valid rays, the JAX package's; it is a sum over rays, so each
    wavefront batch takes its forward and backward pass at once and frees
    its graph, and the gradients add up over the batches. The camera rays
    are the renderer's own (its lens samples; the JAX package's step passes
    zeros, which is the same for a pinhole camera)."""
    if mesh is not None:
        mesh = list(mesh)
        if len(mesh) > 1:
            raise NotImplementedError(
                f"a training step over {len(mesh)} devices needs the "
                "torch.distributed all-reduce that is not in the PyTorch "
                "port yet (ROADMAP.md queue 1, item 13)")
        device = mesh[0] if mesh else device
    base = Renderer(scene, device=device, tables=tables, spectral=spectral)
    base._refuse_gradients()
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
            for b in range(base.n_batches):
                _, L, _ = base._radiance(ds, sample_idx, b,
                                            tables=tables, with_stats=False)
                pix = base._py_b[b] * cfg.xres + base._px_b[b]
                tgt = target[pix.long()]
                err = torch.where(base._valid_b[b][:, None], L - tgt, 0.0)
                loss_b = torch.sum(err * err) / n_valid
                if loss_b.requires_grad:
                    torch.autograd.backward(loss_b,
                                            inputs=list(leaves.values()))
                loss = loss + loss_b.detach()
        new = {k: (v - lr * v.grad if v.grad is not None else v).detach()
               for k, v in leaves.items()}
        return loss, new

    return step, params0
