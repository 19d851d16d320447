"""Configuration sweep of the thesis's accelerator comparisons (counterpart
of scripts/run_distributed.sh + render_simple.sh, the reference's ssh farm,
and of the JAX package's tools/sweep.py):

    python -m tpupt_torch.tools.sweep scene.pbrt \
        --set acc=bvh,kdtree,rbsp --set accnr=3,7,9,13 \
        --spp 8 --resolution 256x256 --outdir results/ [--cpu]

The scene file names its parameters as `$acc`, `$accnr`, ... (the
reference's sed placeholders, render_simple.sh:24-29); each --set KEY gives
the values of `$KEY`, substituted through the loader's `subst` (a value that
is not a number goes in quoted). Every combination is rendered in turn on
the CUDA device (on the CPU with --cpu; without a card and without --cpu it
fails), with the traversal counters on (`collect_stats=True`: the kernels
leave them out by default), and writes `<tag>.png`, the per-pixel counter
matrices `<tag>.<aov>.txt` and a JSON record (the tag, build and render
seconds, spp, the accelerator's statistics and the mean node visits and
prim tests a pixel); `sweep.json` collects the records."""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep")
    ap.add_argument("scene")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=V1,V2,...")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--resolution", default=None)
    ap.add_argument("--outdir", default="sweep_out")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    import torch

    from tpupt_torch.integrators.path import Renderer
    from tpupt_torch.scene.flatten import flatten, with_resolution
    from tpupt_torch.scene.loader import parse_file
    from tpupt_torch.utils import imageio

    device = "cpu" if args.cpu else "cuda"
    keys, values = [], []
    for spec in args.set:
        k, v = spec.split("=", 1)
        keys.append(k)
        values.append(v.split(","))

    os.makedirs(args.outdir, exist_ok=True)
    results = []
    for combo in itertools.product(*values) if values else [()]:
        # `$KEY` -> the value, quoted unless it is a number
        subst = {f"${k}": (f'"{v}"' if not v.replace(".", "").isdigit()
                           else v) for k, v in zip(keys, combo)}
        tag = "_".join(f"{k}-{v}" for k, v in zip(keys, combo)) or "default"
        print(f"=== {tag} ===", flush=True)
        t0 = time.time()
        scene = flatten(parse_file(args.scene, subst=subst),
                        os.path.dirname(os.path.abspath(args.scene)))
        if args.resolution:
            w, h = (int(x) for x in args.resolution.lower().split("x"))
            scene = with_resolution(scene, w, h)
        r = Renderer(scene, device=device, collect_stats=True)
        build_s = time.time() - t0
        t0 = time.time()
        film = r.render(spp=args.spp)
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        render_s = time.time() - t0
        imageio.write_png(os.path.join(args.outdir, f"{tag}.png"),
                          r.image(film))
        aov = r.aovs(film)
        for k, v in aov.items():
            np.savetxt(os.path.join(args.outdir, f"{tag}.{k}.txt"), v,
                       fmt="%.2f")
        rec = dict(tag=tag, build_s=round(build_s, 2),
                   render_s=round(render_s, 2),
                   spp=args.spp or scene.sampler.spp,
                   accel=r.accel_stats,
                   mean_node_visits=float(aov["node_visits"].mean()),
                   mean_prim_tests=float(aov["prim_tests"].mean()))
        results.append(rec)
        print(json.dumps(rec), flush=True)
        del film, r
    with open(os.path.join(args.outdir, "sweep.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.outdir}/sweep.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
