"""Rank functions of tests/test_torch_mesh.py: `tpupt_torch.parallel.mesh.
spawn` runs each in processes of their own, which import this module and
nothing of JAX or the JAX package."""

import dataclasses

import numpy as np
import torch

from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import (ShardedRenderer, scaling_curve,
                                       train_step_fn)
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_string


def scene_of(txt, crop=None, max_sample_luminance=None):
    sc = flatten(parse_string(txt))
    film = {}
    if crop is not None:
        film["crop"] = tuple(crop)
    if max_sample_luminance is not None:
        film["max_sample_luminance"] = float(max_sample_luminance)
    if film:
        sc = dataclasses.replace(sc, film=dataclasses.replace(sc.film,
                                                              **film))
    return sc


def render_cases(mesh, cases):
    """{name: (film fields as tensors, this rank's batches, image)} of each
    (name, scene text, spp, scene_of keywords, Renderer keywords) case,
    rendered by a ShardedRenderer over the mesh."""
    out = {}
    for name, txt, spp, scene_kw, renderer_kw in cases:
        sc = scene_of(txt, **scene_kw)
        base = Renderer(sc, device=mesh.device, **renderer_kw)
        sr = ShardedRenderer(sc, mesh, base=base)
        film = sr.render(spp=spp)
        out[name] = (film._asdict(), sr.batches, sr.image(film))
    return out


def render_tables(mesh, txt, fields, statics, spp):
    """The film of a ShardedRenderer over the mesh on tables carried
    across as numpy arrays."""
    sc = flatten(parse_string(txt))
    tables = from_numpy(fields, statics, device=mesh.device)
    sr = ShardedRenderer(sc, mesh, base=Renderer(sc, device=mesh.device,
                                                 tables=tables))
    return sr.render(spp=spp)._asdict()


def train_step(mesh, txt, fields, statics, target, lr, resolution):
    """(loss, updated tables) of one sharded training step."""
    sc = with_resolution(flatten(parse_string(txt)), *resolution)
    tables = from_numpy(fields, statics, device=mesh.device)
    step, p0 = train_step_fn(sc, mesh, target, tables=tables)
    loss, new = step(p0, 0, lr)
    return float(loss), new


def scaling(mesh, txt, counts, spp):
    return scaling_curve(flatten(parse_string(txt)), counts, spp=spp)


def rank_one_fails(mesh):
    """Rank 1 raises while the others wait on a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1, device=mesh.device),
                                 group=mesh.group)
    return np.zeros(1)
