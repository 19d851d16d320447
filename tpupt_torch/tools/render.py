"""Command-line renderer of the PyTorch/CUDA package (counterpart of
src/main/pbrt.cpp):

    python -m tpupt_torch.tools.render scene.pbrt [--spp N]
        [--resolution WxH] [--quick] [--cpu] [--spectral]
        [-o out.{exr,pfm,png}]
        [--quiet] [--stats] [--cropwindow X0 X1 Y0 Y1]
        [--accelerator bvh|kdtree|rbsp|bsp...] [--dumptree] [--writestats]
        [--cat | --toply] [--profile DIR] [--logfile F] [--loglevel L]
        [--mesh] [--distributed HOST:PORT --num-hosts N --host-id I]

    torchrun --nproc-per-node N -m tpupt_torch.tools.render --mesh scene.pbrt

Parses and flattens the scene, uploads it, renders with the scene's
integrator (path, volpath, directlighting, whitted, ambientocclusion and
bdpt through `Renderer`; mlt through `MLTRenderer` with
max(8 spp, 32) mutations a pixel, sppm through `SPPMRenderer` with
max(spp, 4) iterations) and writes the image; --spectral renders with 60-bin sampled
spectra (PBRT_SAMPLED_SPECTRUM) instead of RGB triples. It runs on the CUDA device unless --cpu is given, and
fails when there is none: it never drops to the CPU by itself.

The flags mirror the reference CLI (pbrt.cpp:47-71) as the JAX package's
does: --quick quarters the resolution (at least 16 pixels a side) and renders
1 spp; --cropwindow renders only that part of the film (fractions); --quiet
prints nothing but errors (warnings off); --stats prints the render's
statistics (and turns the traversal counters on); --cat prints the parsed
scene as canonical pbrt statements and exits, --toply too, with each inline
trianglemesh written to a binary PLY sidecar in the current directory;
--profile writes a torch.profiler trace of the render into DIR, the
program's spans (`render.sample`, `path_li`, `traverse`, ...) on a track of
their own; --logfile /
--loglevel route and filter the log lines (utils/logging.py).

--accelerator overrides the scene's `Accelerator` line. --dumptree writes the
kd / RBSP / BSP tree next to the image (GenericBSP operator<<, off by default
like the reference's writeFile). --writestats writes the per-pixel traversal
counters as text matrices (Film::WriteGeneralStats, film.cpp:170) and, for a
kd / RBSP / BSP tree, its node-type depth histograms; it also turns the
traversal's counters on (`Renderer(collect_stats=True)`), which the kernels
otherwise leave out.

--mesh shards whole wavefront batches over the processes of a
torch.distributed job, one process a card (parallel/mesh.py
`ShardedRenderer`): under torchrun it reads the job from the environment;
--distributed HOST:PORT (or an init-method URL such as file:///path) joins
the job there as process --host-id of --num-hosts, and implies --mesh; start
one such process a card, on each host. With --cpu the processes run on the
CPU over gloo. Every process renders its batches and the films are summed;
only rank 0 writes the image and prints the statistics. A job of one
process renders as without --mesh. mlt and sppm are not sharded: each
process renders the whole image through its driver, as the JAX package's
CLI does."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
import warnings

import numpy as np

from tpupt_torch.accel.kdbsp import dump_tree, node_type_depth_maps
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.utils import imageio
from tpupt_torch.utils import logging as tlog


def write_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        imageio.write_png(path, img)
    elif ext == ".pfm":
        imageio.write_pfm(path, img)
    elif ext == ".exr":
        imageio.write_exr(path, img)
    else:
        raise ValueError(f"unknown image extension {ext!r} (exr, pfm, png)")


def write_stats(base: str, renderer, film) -> None:
    """Per-pixel counter matrices `base.<aov>.txt`, the mean leaf size per
    pixel (WriteGeneralStatMapImage leafNodeIntersectionMeanAmount,
    film.cpp:210-239: prim tests over leaf visits; closest-hit and shadow
    traversals merged) and, for a kd / RBSP / BSP tree, the node-type depth
    histograms (GenericBSP::writeNodeTypeDepthMaps, genericBSP.h:132)."""
    aovs = renderer.aovs(film)
    for k, v in aovs.items():
        np.savetxt(f"{base}.{k}.txt", v, fmt="%.2f")
    mean_amt = np.where(aovs["leaf_visits"] > 0,
                        aovs["prim_tests"]
                        / np.maximum(aovs["leaf_visits"], 1), 0.0)
    np.savetxt(f"{base}-leafNodeIntersectionMeanAmount.txt", mean_amt,
               fmt="%.3f")
    if hasattr(renderer, "accel_nodes"):
        maps = node_type_depth_maps(renderer.accel_nodes, renderer.accel_dirs)
        for name, m in maps.items():
            with open(f"{base}-{name}.txt", "w") as f:
                for depth in sorted(m):
                    f.write(f"{depth} {m[depth]}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpupt_torch renderer")
    ap.add_argument("scene")
    ap.add_argument("--outfile", "-o", default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--resolution", default=None, help="WxH override")
    ap.add_argument("--quick", action="store_true",
                    help="1/4 resolution, 1 spp (pbrt --quick)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--spectral", action="store_true",
                    help="60-bin sampled-spectrum transport "
                         "(PBRT_SAMPLED_SPECTRUM, spectrum.h:289)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="print render statistics (pbrt PrintStats)")
    ap.add_argument("--cropwindow", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"))
    ap.add_argument("--accelerator", default=None,
                    help="override the scene accelerator (bvh/kdtree/...)")
    ap.add_argument("--dumptree", action="store_true",
                    help="write the kd/RBSP/BSP tree as text")
    ap.add_argument("--writestats", action="store_true",
                    help="write per-pixel traversal counters and the tree's "
                         "node-type depth histograms")
    ap.add_argument("--cat", action="store_true",
                    help="print the parsed scene as canonical pbrt "
                         "statements and exit (pbrt --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, with inline trianglemeshes written to "
                         "binary PLY sidecars (pbrt --toply)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render to DIR")
    ap.add_argument("--logfile", default=None,
                    help="append the log lines to a file")
    ap.add_argument("--loglevel", default="info",
                    choices=["debug", "info", "warning", "error"])
    ap.add_argument("--mesh", action="store_true",
                    help="shard wavefront batches over the processes of a "
                         "torch.distributed job (torchrun), one a card")
    ap.add_argument("--distributed", default=None, metavar="HOST:PORT",
                    help="join a job of --num-hosts processes there (or at "
                         "an init-method URL) as --host-id; implies --mesh")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="processes in the job (one a card)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's rank in the job")
    args = ap.parse_args(argv)

    tlog.set_level(args.loglevel)
    if args.logfile:
        tlog.set_logfile(args.logfile)
    if args.quiet:
        tlog.set_level("error")
        warnings.simplefilter("ignore")

    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.distributed is not None or (args.mesh
                                        and "WORLD_SIZE" in os.environ):
        from tpupt_torch.parallel.mesh import init_distributed, make_mesh

        rank, world = init_distributed(args.distributed, args.num_hosts,
                                       args.host_id, device=device)
        mesh = make_mesh()
        if not args.quiet:
            print(f"distributed: process {rank} of {world} on {mesh.device}",
                  flush=True)
    try:
        return _render(args, mesh, device)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _render(args, mesh, device) -> int:
    lead = mesh is None or mesh.rank == 0
    t0 = time.time()
    desc = parse_file(args.scene)
    if args.cat or args.toply:
        from tpupt_torch.tools.catscene import cat_scene

        # PLY sidecars go to the current directory, like the reference's,
        # never into the scene's own directory
        out_dir = os.getcwd()
        n_ply = cat_scene(desc, sys.stdout, to_ply=args.toply,
                          ply_dir=out_dir)
        if args.toply and not args.quiet:
            print(f"# wrote {n_ply} PLY sidecars to {out_dir}",
                  file=sys.stderr)
        return 0
    scene = flatten(desc, os.path.dirname(os.path.abspath(args.scene)))
    if args.accelerator:
        scene.accelerator_name = args.accelerator
    if args.resolution:
        w, h = (int(v) for v in args.resolution.lower().split("x"))
        scene = with_resolution(scene, w, h)
    if args.quick:
        scene = with_resolution(scene, max(scene.film.xres // 4, 16),
                                max(scene.film.yres // 4, 16))
        scene.sampler.spp = 1
    if args.cropwindow:
        scene = dataclasses.replace(
            scene, film=dataclasses.replace(scene.film,
                                            crop=tuple(args.cropwindow)))
    t_parse = time.time() - t0
    tlog.info(f"parsed and flattened in {t_parse:.2f}s: "
              f"{scene.triangles.count} triangles, {scene.spheres.count} "
              f"quadrics, {scene.lights.count} lights")
    t0 = time.time()
    renderer = Renderer(scene, device=mesh.device if mesh else device,
                        collect_stats=args.stats or args.writestats,
                        spectral=args.spectral)
    t1 = time.time()
    spp = args.spp or scene.sampler.spp
    verbose = lead and not args.quiet
    with (tlog.profile_to(args.profile) if args.profile
          else contextlib.nullcontext()):
        name = scene.integrator.name
        if name == "mlt":
            from tpupt_torch.integrators.mlt import MLTRenderer

            mr = MLTRenderer(renderer)
            img = mr.render(mutations_per_pixel=max(spp * 8, 32),
                            verbose=verbose)
            film = mr.film  # the estimate as splats, splatScale 1
            renderer._spp_rendered = 1
        elif name == "sppm":
            from tpupt_torch.integrators.sppm import SPPMRenderer

            sr = SPPMRenderer(renderer)
            img = sr.render(n_iterations=max(spp, 4), verbose=verbose)
            film = sr.film  # the estimate in rgb with unit weights
            renderer._spp_rendered = 1
        elif mesh is not None and mesh.size > 1:
            from tpupt_torch.parallel.mesh import ShardedRenderer

            sr = ShardedRenderer(scene, mesh, base=renderer)
            film = sr.render(spp=spp, verbose=verbose)
            img = sr.image(film)
        else:
            film = renderer.render(spp=spp, verbose=verbose)
            img = renderer.image(film)
    t2 = time.time()
    if not lead:
        return 0
    out = args.outfile or os.path.splitext(
        os.path.basename(scene.film.filename))[0] + ".png"
    write_image(out, img)
    base = os.path.splitext(out)[0]
    if args.dumptree and hasattr(renderer, "accel_nodes"):
        dump_tree(renderer.accel_nodes, renderer.accel_dirs,
                  f"{base}-tree.txt")
    if args.writestats:
        write_stats(base, renderer, film)
    if not args.quiet:
        print(f"{out}: {img.shape[1]}x{img.shape[0]}, {spp} spp on "
              f"{renderer.device}; scene {t1 - t0:.2f}s, render "
              f"{t2 - t1:.2f}s")
    if args.stats:
        n_rays = int(renderer._valid_b.sum()) * spp
        print("Statistics:")
        print(f"  camera rays                     {n_rays}")
        for k, v in renderer.aovs(film).items():
            print(f"  {k:30s}  mean/pixel {float(v.mean()):10.2f}")
        print(f"  Timings/Parse                   {t_parse:.2f} s")
        print(f"  Timings/Buildtime               {t1 - t0:.2f} s")
        print(f"  Timings/Rendertime              {t2 - t1:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
