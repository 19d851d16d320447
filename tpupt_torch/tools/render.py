"""Command-line renderer of the PyTorch/CUDA package:

    python -m tpupt_torch.tools.render scene.pbrt [--spp N]
        [--resolution WxH] [--cpu] [-o out.{exr,pfm,png}]
        [--accelerator bvh|kdtree|rbsp|bsp...] [--dumptree] [--writestats]

Parses and flattens the scene, uploads it, renders with the path integrator
and writes the image. It runs on the CUDA device unless --cpu is given, and
fails when there is none: it never drops to the CPU by itself.

--accelerator overrides the scene's `Accelerator` line. --dumptree writes the
kd / RBSP / BSP tree next to the image (GenericBSP operator<<, off by default
like the reference's writeFile). --writestats writes the per-pixel traversal
counters as text matrices (Film::WriteGeneralStats, film.cpp:170) and, for a
kd / RBSP / BSP tree, its node-type depth histograms; it also turns the
traversal's counters on (`Renderer(collect_stats=True)`), which the kernels
otherwise leave out."""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from tpupt_torch.accel.kdbsp import dump_tree, node_type_depth_maps
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.utils import imageio


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
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--accelerator", default=None,
                    help="override the scene accelerator (bvh/kdtree/...)")
    ap.add_argument("--dumptree", action="store_true",
                    help="write the kd/RBSP/BSP tree as text")
    ap.add_argument("--writestats", action="store_true",
                    help="write per-pixel traversal counters and the tree's "
                         "node-type depth histograms")
    args = ap.parse_args(argv)

    scene_dir = os.path.dirname(os.path.abspath(args.scene))
    scene = flatten(parse_file(args.scene), scene_dir)
    if args.accelerator:
        scene.accelerator_name = args.accelerator
    if args.resolution:
        w, h = (int(v) for v in args.resolution.lower().split("x"))
        scene = with_resolution(scene, w, h)
    t0 = time.time()
    renderer = Renderer(scene, device="cpu" if args.cpu else "cuda",
                        collect_stats=args.writestats)
    t1 = time.time()
    film = renderer.render(spp=args.spp)
    img = renderer.image(film)
    t2 = time.time()
    out = args.outfile or os.path.splitext(
        os.path.basename(scene.film.filename))[0] + ".png"
    write_image(out, img)
    base = os.path.splitext(out)[0]
    if args.dumptree and hasattr(renderer, "accel_nodes"):
        dump_tree(renderer.accel_nodes, renderer.accel_dirs,
                  f"{base}-tree.txt")
    if args.writestats:
        write_stats(base, renderer, film)
    print(f"{out}: {img.shape[1]}x{img.shape[0]}, "
          f"{args.spp or scene.sampler.spp} spp on {renderer.device}; "
          f"scene {t1 - t0:.2f}s, render {t2 - t1:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
