"""Command-line renderer of the PyTorch/CUDA package:

    python -m tpupt_torch.tools.render scene.pbrt [--spp N]
        [--resolution WxH] [--cpu] [-o out.{exr,pfm,png}]

Parses and flattens the scene, uploads it, renders with the path integrator
and writes the image. It runs on the CUDA device unless --cpu is given, and
fails when there is none: it never drops to the CPU by itself."""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpupt_torch renderer")
    ap.add_argument("scene")
    ap.add_argument("--outfile", "-o", default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--resolution", default=None, help="WxH override")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    scene_dir = os.path.dirname(os.path.abspath(args.scene))
    scene = flatten(parse_file(args.scene), scene_dir)
    if args.resolution:
        w, h = (int(v) for v in args.resolution.lower().split("x"))
        scene = with_resolution(scene, w, h)
    t0 = time.time()
    renderer = Renderer(scene, device="cpu" if args.cpu else "cuda")
    t1 = time.time()
    film = renderer.render(spp=args.spp)
    img = renderer.image(film)
    t2 = time.time()
    out = args.outfile or os.path.splitext(
        os.path.basename(scene.film.filename))[0] + ".png"
    write_image(out, img)
    print(f"{out}: {img.shape[1]}x{img.shape[0]}, "
          f"{args.spp or scene.sampler.spp} spp on {renderer.device}; "
          f"scene {t1 - t0:.2f}s, render {t2 - t1:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
