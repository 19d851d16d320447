"""bsdftest — BSDF sampling validator (counterpart of src/tools/bsdftest.cpp
and of the JAX package's tools/bsdftest.py).

    python -m tpupt_torch.tools.bsdftest [--material matte|plastic|metal|
        uber|substrate|translucent|disney|hair] [--samples N] [--theta DEG]
        [--roughness R] [--cpu]

For the chosen material it estimates the hemispherical-directional
reflectance two ways, by BSDF importance sampling (`materials/bsdf.py`
`sample`) and by uniform-sphere sampling (`eval_pdf`), and prints both and
a chi-square statistic of the sampled directions' histogram (10 cos-theta
x 10 phi bins) against the counts the pdf predicts. The BSDF runs on the
card unless --cpu is given; the random numbers are numpy's
(`default_rng(0)`), the JAX package's draws, and the statistics are numpy
on the host. Exits 1 when the two reflectances disagree (MISMATCH)."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpupt_torch.materials import bsdf as bx

MATERIALS = {
    "matte": bx.MAT_MATTE, "plastic": bx.MAT_PLASTIC, "metal": bx.MAT_METAL,
    "uber": bx.MAT_UBER, "substrate": bx.MAT_SUBSTRATE,
    "translucent": bx.MAT_TRANSLUCENT, "disney": bx.MAT_DISNEY,
    "hair": bx.MAT_HAIR,
}


def _params(material: str, n: int, rough: float, device) -> bx.MatParams:
    """n lanes of one material with the JAX tool's constants."""
    extra = np.zeros((n, 12), np.float32)
    if material == "disney":
        extra[:, 0] = 0.3  # metallic
        extra[:, 4] = 0.5  # clearcoat
        extra[:, 5] = 1.0
    if material == "hair":
        extra[:, 0] = extra[:, 1] = 0.3
    if material == "uber":
        extra[:, 7] = 1.0  # fully opaque (uber.cpp opacity default)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return bx.MatParams(
        type=torch.full((n,), MATERIALS[material], dtype=torch.int32,
                        device=device),
        kd=full((n, 3), 0.5), ks=full((n, 3), 0.5), kr=full((n, 3), 0.5),
        kt=full((n, 3), 0.5), alpha_x=full((n,), rough),
        alpha_y=full((n,), rough), eta=full((n, 3), 1.5), k=full((n, 3), 2.0),
        sigma_a=full((n,), 1.0), sigma_b=full((n,), 0.0),
        extra=torch.from_numpy(extra).to(device), rough=full((n,), rough),
        h=full((n,), 0.0))


def run(material: str, n: int, theta_deg: float, rough: float,
        device="cuda") -> dict:
    """{material, rho_sampled, rho_uniform, chi2, dof, valid_fraction} of
    `n` samples at the incident angle `theta_deg`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for and no CUDA device is available; "
            "pass device='cpu' (--cpu) to run the plain PyTorch path")
    feats = frozenset({"disney", "hair"} & {material})
    mp = _params(material, n, rough, device)
    th = np.deg2rad(theta_deg)
    wo = torch.tensor([np.sin(th), 0.0, np.cos(th)], dtype=torch.float32,
                      device=device).expand(n, 3).contiguous()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(0)
    u = rng.uniform(size=(3, n)).astype(np.float32)
    with torch.no_grad():
        bs = bx.sample(mp, wo, dev(u[0]), dev(u[1]), dev(u[2]), feats)
    pdf = bs.pdf.cpu().numpy()
    wi = bs.wi.cpu().numpy()
    f = bs.f.cpu().numpy()
    ok = pdf > 1e-6
    rho_is = (f[ok] * np.abs(wi[ok, 2:3]) / pdf[ok, None]).mean(0)

    z = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(np.maximum(0, 1 - z * z))
    wi_u = np.stack([s * np.cos(phi), s * np.sin(phi), z],
                    -1).astype(np.float32)
    with torch.no_grad():
        f_u, pdf_u = bx.eval_pdf(mp, wo, dev(wi_u), feats)
    f_u, pdf_eval = f_u.cpu().numpy(), pdf_u.cpu().numpy()
    rho_us = (f_u * np.abs(wi_u[:, 2:3])).mean(0) * 4 * np.pi

    # chi-square: the sampled directions' histogram against the counts
    # the pdf predicts, from its values at the uniform directions
    nb_th, nb_ph = 10, 10
    cos_bins = np.clip(((wi[ok, 2] + 1) / 2 * nb_th).astype(int), 0,
                       nb_th - 1)
    phi_s = np.arctan2(wi[ok, 1], wi[ok, 0]) + np.pi
    phi_bins = np.clip((phi_s / (2 * np.pi) * nb_ph).astype(int), 0,
                       nb_ph - 1)
    observed = np.bincount(cos_bins * nb_ph + phi_bins,
                           minlength=nb_th * nb_ph).astype(np.float64)
    cos_u = np.clip(((wi_u[:, 2] + 1) / 2 * nb_th).astype(int), 0, nb_th - 1)
    phi_u = np.arctan2(wi_u[:, 1], wi_u[:, 0]) + np.pi
    phb_u = np.clip((phi_u / (2 * np.pi) * nb_ph).astype(int), 0, nb_ph - 1)
    expected = np.zeros(nb_th * nb_ph)
    np.add.at(expected, cos_u * nb_ph + phb_u, pdf_eval)
    expected *= 4 * np.pi / n * ok.sum()
    mask = expected > 5
    chi2 = float((((observed - expected) ** 2
                   / np.maximum(expected, 1e-9))[mask]).sum())
    return dict(material=material, rho_sampled=rho_is.tolist(),
                rho_uniform=rho_us.tolist(), chi2=chi2,
                dof=int(mask.sum()) - 1, valid_fraction=float(ok.mean()))


def consistent(r: dict) -> bool:
    """The two reflectance estimates agree (within 0.05, or 10 % of the
    larger uniform one)."""
    err = max(abs(a - b) for a, b in zip(r["rho_sampled"], r["rho_uniform"]))
    return err < 0.05 or err < 0.1 * max(max(r["rho_uniform"]), 1e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsdftest")
    ap.add_argument("--material", default="matte", choices=list(MATERIALS))
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--theta", type=float, default=30.0)
    ap.add_argument("--roughness", type=float, default=0.2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    r = run(args.material, args.samples, args.theta, args.roughness,
            device="cpu" if args.cpu else "cuda")
    print(f"material {r['material']}: valid {r['valid_fraction']:.3f}")
    print(f"  rho (importance sampled) = {r['rho_sampled']}")
    print(f"  rho (uniform reference)  = {r['rho_uniform']}")
    print(f"  chi2 = {r['chi2']:.1f}  dof = {r['dof']}")
    ok = consistent(r)
    print("  CONSISTENT" if ok else "  MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
