"""Image utility CLI (counterpart of src/tools/imgtool.cpp and of the JAX
package's tools/imgtool.py, whose output it reproduces):

    python -m tpupt_torch.tools.imgtool assemble out.exr crop1.exr crop2.exr ...
    python -m tpupt_torch.tools.imgtool cat in.exr
    python -m tpupt_torch.tools.imgtool convert [--scale S --tonemap] in out
    python -m tpupt_torch.tools.imgtool diff [--outfile d.png] [--tolerance T] a b
    python -m tpupt_torch.tools.imgtool info in.exr
    python -m tpupt_torch.tools.imgtool makesky [--albedo A --elevation deg
        --turbidity T --resolution N] out.exr

Images are read and written by extension (.exr, .pfm, else PNG) through
utils/imageio.py. `makesky` writes an equirect sky of 2N x N pixels from the
Hosek-Wilkie RGB dataset in hosek_data.npz (a byte copy of the JAX
package's, made there from the model's published tables), with a simplified
Preetham sky where the file is absent. Host-side numpy only."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from tpupt_torch.utils import imageio

HOSEK_DATA = os.path.join(os.path.dirname(__file__), "hosek_data.npz")
LUMINANCE = np.array([0.2126, 0.7152, 0.0722])


def read_image(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return imageio.read_exr(path)
    if ext == ".pfm":
        return imageio.read_pfm(path)
    return imageio.read_png(path)


def write_image(path, img):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        imageio.write_exr(path, img)
    elif ext == ".pfm":
        imageio.write_pfm(path, img)
    else:
        imageio.write_png(path, img)


def cmd_info(args):
    img = read_image(args.input)
    print(f"{args.input}: {img.shape[1]}x{img.shape[0]} ({img.shape[2]} ch)")
    print(f"  min {img.min(axis=(0, 1))}")
    print(f"  max {img.max(axis=(0, 1))}")
    print(f"  avg {img.mean(axis=(0, 1))}")
    print(f"  avg luminance {(img @ LUMINANCE).mean():.6f}")
    return 0


def cmd_cat(args):
    img = read_image(args.input)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            print(f"({x},{y}): ({img[y,x,0]:.6g}, {img[y,x,1]:.6g}, "
                  f"{img[y,x,2]:.6g})")
    return 0


def cmd_convert(args):
    img = read_image(args.input) * args.scale
    if args.tonemap:
        # Reinhard on luminance
        img = img * (1.0 / (1.0 + img @ LUMINANCE))[..., None]
    write_image(args.output, img)
    return 0


def cmd_diff(args):
    a, b = read_image(args.a), read_image(args.b)
    if a.shape != b.shape:
        print(f"size mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    d = a - b
    mse = float((d * d).mean())
    avg = float(np.abs(d).mean())
    mx = float(np.abs(d).max())
    print(f"MSE {mse:.3e}  avg abs diff {avg:.3e}  max abs diff {mx:.3e}")
    if args.outfile:
        write_image(args.outfile, np.abs(d))
    return 0 if mse <= args.tolerance else 1


def cmd_assemble(args):
    """Stitch crop renders: each pixel the mean of the inputs that cover it
    (non-zero there)."""
    imgs = [read_image(p) for p in args.inputs]
    shape = imgs[0].shape
    out = np.zeros(shape, np.float32)
    count = np.zeros(shape[:2], np.int32)
    for img in imgs:
        if img.shape != shape:
            print("crop size mismatch", file=sys.stderr)
            return 1
        mask = np.abs(img).sum(-1) > 0
        out[mask] += img[mask]
        count += mask
    out /= np.maximum(count, 1)[..., None]
    write_image(args.output, out)
    return 0


def hosek_config(turbidity: float, albedo: float, elev: float,
                 path: str = HOSEK_DATA):
    """The nine distribution coefficients and the radiance of each RGB
    channel, cooked from the Hosek-Wilkie dataset as
    ArHosekSkyModel_CookConfiguration does (a quintic Bezier over
    elevation^(1/3), lerped over turbidity and albedo): (config (3, 9),
    radiance (3,)), or None where the dataset file is absent."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    cfg, rad = z["config"], z["radiance"]  # (3,2,10,6,9), (3,2,10,6)
    t = float(np.clip(turbidity, 1.0, 10.0))
    it = min(int(t), 9)
    tr = t - it
    x = (elev / (np.pi / 2.0)) ** (1.0 / 3.0)
    w = np.array([(1 - x) ** 5, 5 * (1 - x) ** 4 * x,
                  10 * (1 - x) ** 3 * x ** 2, 10 * (1 - x) ** 2 * x ** 3,
                  5 * (1 - x) * x ** 4, x ** 5])

    def cook(tab):  # (3, 2, 10, 6, ...) -> (3, ...)
        lo = np.tensordot(tab[:, :, it - 1], w, axes=([2], [0]))
        out = (1 - albedo) * lo[:, 0] + albedo * lo[:, 1]
        if it < 10 and tr > 0:
            hi = np.tensordot(tab[:, :, it], w, axes=([2], [0]))
            out = (1 - tr) * out + tr * ((1 - albedo) * hi[:, 0]
                                         + albedo * hi[:, 1])
        return out

    return cook(cfg), cook(rad)


def make_sky(resolution: int, elevation_deg: float, turbidity: float,
             albedo: float, path: str = HOSEK_DATA) -> np.ndarray:
    """The (N, 2N, 3) float32 equirect sky dome (z up, the sun at
    `elevation_deg` in the x-z plane): the Hosek-Wilkie model with a solar
    disc of 0.51 degrees, the ground below the horizon lit by `albedo`; a
    simplified Preetham sky where the dataset file is absent."""
    h, w = resolution, 2 * resolution
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    T, P = np.meshgrid(theta, phi, indexing="ij")
    elev = np.deg2rad(elevation_deg)
    sun_dir = np.array([np.cos(elev), 0.0, np.sin(elev)])
    d = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                 -1)
    cos_g = np.clip(d @ sun_dir, -1, 1)
    gamma = np.arccos(cos_g)
    cos_t = np.clip(np.cos(T), 1e-3, 1)
    t = turbidity
    above = (T < np.pi / 2)[..., None]
    below = (T >= np.pi / 2)[..., None]

    hk = hosek_config(t, albedo, elev, path)
    if hk is not None:
        cfg, rad = hk
        sky = np.zeros((h, w, 3), np.float64)
        for c in range(3):
            A, B, C, D, E, F_c, G, H, I = cfg[c]
            expM = np.exp(E * gamma)
            rayM = cos_g * cos_g
            mieM = (1.0 + rayM) / np.power(
                np.maximum(1.0 + H * H - 2.0 * H * cos_g, 1e-9), 1.5)
            zenith = np.sqrt(cos_t)
            F_val = ((1.0 + A * np.exp(B / (cos_t + 0.01)))
                     * (C + D * expM + F_c * rayM + G * mieM + I * zenith))
            sky[..., c] = np.maximum(F_val * rad[c], 0.0)
        # the solar disc: the RGB dataset is sky only, so the disc takes a
        # radiance relative to the sky's
        disc = (gamma < np.deg2rad(0.255))[..., None] * sky.max() * 5e3
        img = (sky + disc) * above + albedo * 0.2 * sky.mean() * below
        return img.astype(np.float32)
    # Preetham luminance distribution coefficients
    A = 0.1787 * t - 1.4630
    B = -0.3554 * t + 0.4275
    C = -0.0227 * t + 5.3251
    D = 0.1206 * t - 2.5771
    E = -0.0670 * t + 0.3703
    F_ = ((1 + A * np.exp(B / cos_t))
          * (1 + C * np.exp(D * gamma) + E * cos_g ** 2))
    F_ = np.maximum(F_, 0.0)
    sky = np.stack([0.45 * F_, 0.55 * F_, 0.9 * F_], -1)
    sun = np.exp(-np.maximum(gamma, 0) * 120.0)[..., None] * np.array(
        [120.0, 110.0, 95.0])
    img = (sky + sun) * above + albedo * 0.2 * below
    return img.astype(np.float32)


def cmd_makesky(args):
    write_image(args.output, make_sky(args.resolution, args.elevation,
                                      args.turbidity, args.albedo))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("info")
    p.add_argument("input")
    p = sub.add_parser("cat")
    p.add_argument("input")
    p = sub.add_parser("convert")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--tonemap", action="store_true")
    p.add_argument("input")
    p.add_argument("output")
    p = sub.add_parser("diff")
    p.add_argument("--outfile", default=None)
    p.add_argument("--tolerance", type=float, default=float("inf"))
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("assemble")
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p = sub.add_parser("makesky")
    p.add_argument("--albedo", type=float, default=0.5)
    p.add_argument("--elevation", type=float, default=10.0)
    p.add_argument("--turbidity", type=float, default=3.0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("output")
    args = ap.parse_args(argv)
    return {"info": cmd_info, "cat": cmd_cat, "convert": cmd_convert,
            "diff": cmd_diff, "assemble": cmd_assemble,
            "makesky": cmd_makesky}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
