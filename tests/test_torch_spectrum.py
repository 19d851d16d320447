"""Spectral transport's tables and functions of the PyTorch port against the
JAX package's (tpupt_torch/core/spectrum.py against tpupt/core/spectrum.py),
and the statics and tables that `upload(spectral=True)` and `from_numpy`
give.

The host tables (bins, CIE curves, white balance, the solved uplift basis,
the Smits tables) are built by the same numpy code from the same data
file and are array-equal. `rgb_to_spectrum` picks basis rows with
index_select where the JAX package multiplies by one-hot rows at HIGHEST
precision: equal to the bit on the test inputs (ties included). The other
functions sum 60 bins, whose order differs between XLA and ATen: measured
within 2e-6 of the values (up to about 2), held to rtol 1e-5, atol 2e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpupt.core import spectrum as jspec
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.core import spectrum as tspec
from tpupt_torch.scene.device import from_numpy, upload
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-6


def _rgb_inputs():
    """Seeded RGB triples: positive, with negatives, and with ties (two or
    three equal channels, where argmin / argmax take the first index)."""
    g = np.random.default_rng(11)
    x = g.uniform(-0.2, 2.0, (4096, 3)).astype(np.float32)
    x[:256, 1] = x[:256, 0]
    x[256:512, 2] = x[256:512, 1]
    x[512:640] = x[512:640, :1]
    x[640:700] = 0.0
    return x


@pytest.mark.parametrize("table", [
    "_BIN_LAMBDA", "_CIE_X", "_CIE_Y", "_CIE_Z", "_WHITE_BAL", "_Y_SPEC",
    "uplift", "smits_refl", "smits_illum"])
def test_host_tables_array_equal(table):
    get = {"uplift": lambda m: m.rgb_uplift_basis(),
           "smits_refl": lambda m: m.smits_tables()["refl"],
           "smits_illum": lambda m: m.smits_tables()["illum"]}.get(
        table, lambda m: getattr(m, table))
    a, b = np.asarray(get(jspec)), np.asarray(get(tspec))
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()
    assert tspec.N_SPECTRAL_SAMPLES == jspec.N_SPECTRAL_SAMPLES == 60


def test_average_spectrum_samples_and_blackbody_match():
    g = np.random.default_rng(3)
    lam = np.sort(g.uniform(350, 750, 40))
    val = g.random(40)
    for lo, hi in ((300, 340), (400, 405), (420, 700), (760, 800),
                   (500, 500.5)):
        assert (tspec.average_spectrum_samples(lam, val, lo, hi)
                == jspec.average_spectrum_samples(lam, val, lo, hi))
    lam_nm = np.linspace(380, 780, 81)
    for temp in (2700.0, 3200.0, 6500.0):
        assert np.array_equal(tspec.blackbody(lam_nm, temp),
                              jspec.blackbody(lam_nm, temp))
        assert np.array_equal(tspec.blackbody_normalized(lam_nm, temp),
                              jspec.blackbody_normalized(lam_nm, temp))


@pytest.mark.parametrize("fn", ["rgb_to_spectrum", "rgb_refl_to_spectrum",
                                "rgb_illum_to_spectrum"])
def test_uplifts_match_to_the_bit(fn):
    x = _rgb_inputs()
    a = np.asarray(getattr(jspec, fn)(jnp.asarray(x)))
    b = getattr(tspec, fn)(torch.from_numpy(x)).numpy()
    assert b.shape == (4096, 60)
    assert np.array_equal(a, b)
    # leading dimensions are kept
    c = getattr(tspec, fn)(torch.from_numpy(x).reshape(64, 64, 3))
    assert tuple(c.shape) == (64, 64, 60)


def test_spectrum_to_rgb_luminance_and_round_trip():
    x = _rgb_inputs()
    s = np.asarray(jspec.rgb_to_spectrum(jnp.asarray(x)))
    s = s * np.random.default_rng(5).uniform(0.5, 1.5, s.shape).astype(
        np.float32)
    st = torch.from_numpy(s)
    for fn in ("sampled_to_xyz", "sampled_to_rgb", "spectral_luminance"):
        a = np.asarray(getattr(jspec, fn)(jnp.asarray(s)))
        b = getattr(tspec, fn)(st).numpy()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=fn)
    # the uplift's exact round trip and the luminance it keeps
    rt = tspec.sampled_to_rgb(tspec.rgb_to_spectrum(torch.from_numpy(x)))
    np.testing.assert_allclose(rt.numpy(), x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tspec.spectral_luminance(st).numpy(),
        tspec.luminance(tspec.sampled_to_rgb(st)).numpy(), rtol=RTOL,
        atol=ATOL)


_FOG_TXT = """
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "volpath"
WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.1 0.2 0.3]
  "rgb sigma_s" [0.4 0.3 0.2] "float g" [0.3]
LightSource "distant" "point from" [0 0 -5] "point to" [0 0 0] "rgb L" [2 2 2]
Shape "trianglemesh" "point P" [-1 -1 3  1 -1 3  0 1 3] "integer indices" [0 1 2]
WorldEnd
"""


@pytest.mark.parametrize("spectral", [False, True])
def test_upload_statics_match(spectral):
    """upload(spectral=...) gives the JAX package's statics (n_channels 60
    or 3; the media statics of a fog scene) and tables; from_numpy carries
    both across."""
    sj = jax_flatten(jax_parse_string(_FOG_TXT))
    sp = flatten(parse_string(_FOG_TXT))
    ds_j, st_j = jax_upload(sj, spectral=spectral)
    ds_t, st_t = upload(sp, device="cpu", spectral=spectral)
    for f in ("n_channels", "n_media", "camera_medium", "any_grid_media",
              "has_med_interfaces"):
        assert getattr(st_t, f) == getattr(st_j, f), f
    assert st_t.n_channels == (60 if spectral else 3)
    fields, statics = testscenes.tables_as_numpy(ds_j, st_j)
    ds_c, st_c = from_numpy(fields, statics, device="cpu")
    assert st_c.n_channels == st_j.n_channels
    for f in ("med_sigma_a", "med_sigma_s", "med_majorant", "med_w2m"):
        assert np.array_equal(getattr(ds_c, f).numpy(), getattr(ds_t, f).numpy())
