"""Colour and spectral transport (counterpart of src/core/spectrum.{h,cpp}).

The working representation is RGB triples on the trailing axis (pbrt's
default `Spectrum = RGBSpectrum`). Spectral rendering carries 60-bin sampled
spectra over 400-700 nm (`SampledSpectrum`): colours are uplifted to spectra
where they enter the throughput chain (`rgb_to_spectrum`) and the radiance
goes back to RGB after the path (`sampled_to_rgb`). The CIE 1931 matching
curves are the tabulated 471-sample standard data in `cie_data.npz` (a copy
of the JAX package's file, with the Smits tables of spectrum.cpp beside
them), bin-averaged as AverageSpectrumSamples does; the Wyman / Sloan /
Shirley analytic fit stands in when the file is absent.

Host tables (bins, CIE curves, white balance, uplift basis, Smits tables)
are numpy; the per-sample functions take and return torch tensors.

`xyz_to_rgb` works in float32 numpy on purpose: the JAX package converts
"xyz" parameters with a float32 matrix product, and the uploaded tables of
the two packages are compared array-equal."""

from __future__ import annotations

import os

import numpy as np
import torch

N_SPECTRAL_SAMPLES = 60
LAMBDA_START = 400.0
LAMBDA_END = 700.0

_Y_WEIGHT = (0.212671, 0.715160, 0.072169)
_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))
_CIE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "cie_data.npz")


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """y() of RGBSpectrum (spectrum.h YWeight)."""
    w = torch.tensor(_Y_WEIGHT, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    return np.asarray(xyz, np.float32) @ np.asarray(_XYZ_TO_RGB, np.float32).T


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


_BIN_LAMBDA = np.linspace(LAMBDA_START, LAMBDA_END, N_SPECTRAL_SAMPLES + 1)
_BIN_CENTER = 0.5 * (_BIN_LAMBDA[:-1] + _BIN_LAMBDA[1:])


def average_spectrum_samples(lam: np.ndarray, val: np.ndarray,
                             lo: float, hi: float) -> float:
    """Mean of the piecewise-linear spectrum (lam, val) over [lo, hi], held
    constant outside the sample range (spectrum.cpp:129
    AverageSpectrumSamples)."""
    if hi <= lam[0]:
        return float(val[0])
    if lo >= lam[-1]:
        return float(val[-1])
    if len(lam) == 1:
        return float(val[0])
    s = 0.0
    if lo < lam[0]:
        s += val[0] * (lam[0] - lo)
    if hi > lam[-1]:
        s += val[-1] * (hi - lam[-1])
    i = max(int(np.searchsorted(lam, lo, side="right") - 1), 0)

    def interp(w, j):
        t = (w - lam[j]) / (lam[j + 1] - lam[j])
        return (1 - t) * val[j] + t * val[j + 1]

    while i + 1 < len(lam) and hi >= lam[i]:
        sl = max(lo, lam[i])
        sh = min(hi, lam[i + 1])
        if sh > sl:
            s += 0.5 * (interp(sl, i) + interp(sh, i)) * (sh - sl)
        i += 1
    return float(s / (hi - lo))


def _resample_to_bins(lam: np.ndarray, val: np.ndarray) -> np.ndarray:
    return np.asarray([
        average_spectrum_samples(lam, val, _BIN_LAMBDA[i], _BIN_LAMBDA[i + 1])
        for i in range(N_SPECTRAL_SAMPLES)])


def _cie_tables():
    """The CIE 1931 matching functions averaged over the 60 bins: the
    tabulated data of cie_data.npz, or the analytic fit without the file."""
    if os.path.exists(_CIE_FILE):
        z = np.load(_CIE_FILE)
        lam = z["CIE_lambda"]
        return (_resample_to_bins(lam, z["CIE_X"]),
                _resample_to_bins(lam, z["CIE_Y"]),
                _resample_to_bins(lam, z["CIE_Z"]))
    return cie_xyz_fit(_BIN_CENTER)


_CIE_X, _CIE_Y, _CIE_Z = _cie_tables()
_CIE_Y_INT = float(np.sum(_CIE_Y))


def _table(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), dtype=like.dtype,
                           device=like.device)


def sampled_to_xyz(s: torch.Tensor) -> torch.Tensor:
    """(..., 60) sampled spectrum -> XYZ (SampledSpectrum::ToXYZ)."""
    return torch.stack([torch.sum(s * _table(c, s), -1)
                        for c in (_CIE_X, _CIE_Y, _CIE_Z)], -1) / _CIE_Y_INT


def _spec_rgb_m() -> np.ndarray:
    """(3, 60) linear map spectrum -> RGB consistent with sampled_to_xyz."""
    m_xyz = np.stack([_CIE_X, _CIE_Y, _CIE_Z]) / _CIE_Y_INT
    return np.array(_XYZ_TO_RGB) @ m_xyz


# White balance: each channel of the spectrum -> RGB map scaled so that the
# flat (equal-energy) spectrum maps to RGB (1,1,1) exactly; grey then
# uplifts to a flat spectrum and products of greys stay grey.
_WHITE_BAL = (1.0 / (_spec_rgb_m() @ np.ones(N_SPECTRAL_SAMPLES))).astype(
    np.float32)


def sampled_to_rgb(s: torch.Tensor) -> torch.Tensor:
    """(..., 60) -> (..., 3), white-balanced. A saturated spectrum can come
    out of gamut: negative channels, even negative luminance."""
    m = _table(_XYZ_TO_RGB, s)
    return (sampled_to_xyz(s) @ m.T) * _table(_WHITE_BAL, s)


# --- RGB -> sampled-spectrum uplift. The seven basis spectra are solved on
# the host: the smoothest spectra (second-difference energy) whose
# white-balanced sampled_to_rgb gives exactly white, the secondaries and the
# primaries, so every RGB triple round-trips exactly and a grey scene renders
# alike in RGB and spectral transport, while products of saturated spectra
# behave as metamers do. ---

_UPLIFT = None


def _solve_uplift() -> np.ndarray:
    """(7, 60) basis spectra: white, cyan, magenta, yellow, red, green, blue;
    each the smoothest nonnegative spectrum whose white-balanced
    sampled_to_rgb is its target (white solves to the flat spectrum)."""
    n = N_SPECTRAL_SAMPLES
    M = _WHITE_BAL.astype(np.float64)[:, None] * _spec_rgb_m()
    targets = np.array([
        [1.0, 1.0, 1.0],   # white
        [0.0, 1.0, 1.0],   # cyan
        [1.0, 0.0, 1.0],   # magenta
        [1.0, 1.0, 0.0],   # yellow
        [1.0, 0.0, 0.0],   # red
        [0.0, 1.0, 0.0],   # green
        [0.0, 0.0, 1.0],   # blue
    ])
    d2 = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
          + np.diag(np.ones(n - 1), -1))[1:-1]  # (N-2, N)
    # min ||d2 s||^2 + eps ||s||^2 subject to M s = target (closed form),
    # then sweeps of a nonnegative projection and a minimum-norm re-constrain
    Q = d2.T @ d2 + 1e-7 * np.eye(n)
    Qi = np.linalg.inv(Q)
    lam = np.linalg.solve(M @ Qi @ M.T, targets.T)  # (3, 7)
    B = (Qi @ M.T @ lam).T  # (7, N)
    corr = M.T @ np.linalg.solve(M @ M.T, np.eye(3))
    for _ in range(200):
        B = np.clip(B, 0.0, None)
        B = B + (targets.T - M @ B.T).T @ corr.T
    return B.astype(np.float32)


def rgb_uplift_basis() -> np.ndarray:
    global _UPLIFT
    if _UPLIFT is None:
        _UPLIFT = _solve_uplift()
    return _UPLIFT


def _min_mid_max_uplift(rgb: torch.Tensor, basis: np.ndarray) -> torch.Tensor:
    """RGBSpectrum::ToSpectrum's decomposition (spectrum.cpp:289) over the
    (7, 60) `basis`: the smallest channel scales white, the middle one adds
    the secondary opposite the smallest channel, the largest the primary of
    the largest. The basis rows are picked with index_select (exact; the
    first index on ties, as argmin / argmax give it)."""
    t = _table(basis, rgb)
    flat = rgb.reshape(-1, 3)
    mn = torch.amin(flat, -1)
    mx = torch.amax(flat, -1)
    md = flat[:, 0] + flat[:, 1] + flat[:, 2] - mn - mx
    sec = t[1:4].index_select(0, torch.argmin(flat, -1))
    prm = t[4:7].index_select(0, torch.argmax(flat, -1))
    s = (mn[:, None] * t[0] + (md - mn)[:, None] * sec
         + (mx - md)[:, None] * prm)
    return s.reshape(*rgb.shape[:-1], N_SPECTRAL_SAMPLES)


def rgb_to_spectrum(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 60) over the solved basis: an exact sampled_to_rgb
    round trip, grey -> flat. The transport's uplift."""
    return _min_mid_max_uplift(rgb, rgb_uplift_basis())


_Y_SPEC = (np.array(_Y_WEIGHT)
           @ (_WHITE_BAL.astype(np.float64)[:, None] * _spec_rgb_m())
           ).astype(np.float32)


def spectral_luminance(s: torch.Tensor) -> torch.Tensor:
    """y() of SampledSpectrum: luminance(sampled_to_rgb(s)) by construction
    (the same white-balanced map)."""
    return torch.sum(s * _table(_Y_SPEC, s), -1)


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


# --- the Smits tables of spectrum.cpp:984-1172 (RGBRefl2Spect* /
# RGBIllum2Spect*, in cie_data.npz) resampled to the 60 bins, for
# reference-parity promotion; the solved basis above stays the transport's
# uplift because its round trip is exact ---

_SMITS = None


def smits_tables():
    """{'refl': (7, 60), 'illum': (7, 60)} in white, cyan, magenta, yellow,
    red, green, blue order; None without cie_data.npz."""
    global _SMITS
    if _SMITS is None:
        if not os.path.exists(_CIE_FILE):
            return None
        z = np.load(_CIE_FILE)
        lam = z["RGB2SpectLambda"]
        names = ["White", "Cyan", "Magenta", "Yellow", "Red", "Green",
                 "Blue"]
        _SMITS = {
            kind: np.stack([
                _resample_to_bins(lam, z[f"RGB{tab}2Spect{n}"])
                for n in names]).astype(np.float32)
            for kind, tab in (("refl", "Refl"), ("illum", "Illum"))}
    return _SMITS


def rgb_refl_to_spectrum(rgb: torch.Tensor) -> torch.Tensor:
    """Reflectance promotion with the RGBRefl2Spect tables, clamped at 0 and
    scaled by 0.94 (RGBSpectrum::ToSpectrum)."""
    tabs = smits_tables()
    if tabs is None:
        return rgb_to_spectrum(rgb)
    return 0.94 * _min_mid_max_uplift(rgb, tabs["refl"]).clamp_min(0.0)


def rgb_illum_to_spectrum(rgb: torch.Tensor) -> torch.Tensor:
    """Illuminant promotion with the RGBIllum2Spect tables, clamped at 0 and
    scaled by 0.86445 (RGBSpectrum::ToSpectrum)."""
    tabs = smits_tables()
    if tabs is None:
        return rgb_to_spectrum(rgb)
    return 0.86445 * _min_mid_max_uplift(rgb, tabs["illum"]).clamp_min(0.0)
