"""Colour helpers the scene parser and the film need (numpy on the host,
torch for the per-sample luminance clamp).

`xyz_to_rgb` works in float32 on purpose: the JAX package converts "xyz"
parameters with a float32 matrix product, and the uploaded tables of the two
packages are compared array-equal."""

from __future__ import annotations

import numpy as np
import torch

_Y_WEIGHT = (0.212671, 0.715160, 0.072169)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """y() of RGBSpectrum (spectrum.h YWeight)."""
    w = torch.tensor(_Y_WEIGHT, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    m = np.asarray(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ],
        np.float32,
    )
    return np.asarray(xyz, np.float32) @ m.T


# --- analytic CIE 1931 matching-function fit (Wyman/Sloan/Shirley 2013) ---


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_fit(lam: np.ndarray):
    """Approximate CIE x/y/z matching functions at wavelengths lam (nm)."""
    lam = np.asarray(lam, np.float64)
    x = (
        _gauss(lam, 1.056, 599.8, 37.9, 31.0)
        + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
        + _gauss(lam, -0.065, 501.1, 20.4, 26.2)
    )
    y = _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)
    z = _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)
    return x, y, z


def blackbody(lam_nm: np.ndarray, temp_k: float) -> np.ndarray:
    """Planck's law, W/(m^2 sr m) (spectrum.cpp Blackbody)."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    return (2.0 * h * c * c) / (lam**5 * (np.expm1(h * c / (lam * kb * temp_k))))


def blackbody_normalized(lam_nm: np.ndarray, temp_k: float) -> np.ndarray:
    """Blackbody scaled so peak = 1 (spectrum.cpp BlackbodyNormalized)."""
    lam_max = 2.8977721e-3 / temp_k * 1e9
    return blackbody(lam_nm, temp_k) / blackbody(np.array([lam_max]), temp_k)[0]
