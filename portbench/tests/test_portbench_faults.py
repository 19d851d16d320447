"""The comparison that decides `correct` at a size a CPU holds: a sound run
of each kind of cell is correct, and a run with its timed path broken
underneath, or the control (the reference in bfloat16 in the program's
place), is not. The harness's look for a card is skipped: the run is
driven on CPU tensors. The cells have one chip, so the fault "the exchange
between chips left out" does not arise."""

import time

import _paths  # noqa: F401
import pytest
import torch

from harness import compare, drive, manifest, scenes

TINY = {"name": "tiny", "generator": "museum", "grid": 2, "seg": 16,
        "rings": 8, "scene_seed": 7}
SEED = 2**31 + 99


def _cell(name, tmp_path, monkeypatch):
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    cell = manifest.cell(name, _paths.ROOT)
    cell["config"] = TINY
    cell["mix"] = dict(cell["mix"], xres=32, yres=24, wavefront=768,
                       check_pixels=400)
    return cell


def _run(cell, device="cpu"):
    return drive.run(cell, SEED, 0.0, False, device, time.time())


def _state_unchanged(monkeypatch, kind):
    from tpupt_torch.integrators import path

    if kind == "render":
        monkeypatch.setattr(path.Renderer, "_spp",
                            lambda self, film, s: film)
    else:
        real = path.Renderer.value_and_grad

        def frozen(self, loss, params, sample_idx=0):
            v, g, film = real(self, loss, params, sample_idx)
            return v, {k: torch.zeros_like(x) for k, x in g.items()}, film
        monkeypatch.setattr(path.Renderer, "value_and_grad", frozen)


def _half_batch(monkeypatch, kind):
    from tpupt_torch.film import film as filmmod

    real = filmmod.add_samples

    def half(film, cfg, p, L, aov=None, mask=None):
        keep = torch.arange(len(L)) < len(L) // 2
        mask = keep if mask is None else mask & keep
        return real(film, cfg, p, L, aov, mask=mask)
    monkeypatch.setattr(filmmod, "add_samples", half)


def _answer_altered(monkeypatch, kind):
    from tpupt_torch.integrators import path

    real = path.path_li

    def altered(*a, **kw):
        L, aov = real(*a, **kw)
        return L * 1.01, aov
    monkeypatch.setattr(path, "path_li", altered)


CELLS = [("museum1m-render-1080p", "render"),
         ("museum-grad-1024", "inverse")]


@pytest.mark.parametrize("name,kind", CELLS)
def test_sound_run_is_correct(name, kind, tmp_path, monkeypatch):
    out = _run(_cell(name, tmp_path, monkeypatch))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("name,kind", CELLS)
def test_fault_is_not_correct(name, kind, fault, tmp_path, monkeypatch):
    cell = _cell(name, tmp_path, monkeypatch)
    fault(monkeypatch, kind)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,kind", CELLS)
def test_control_is_not_correct(name, kind, tmp_path, monkeypatch):
    cell = _cell(name, tmp_path, monkeypatch)
    dev = torch.device("cpu")
    out = manifest.kind(kind, _paths.ROOT).calibrate(cell, SEED, dev, 3)
    if kind == "inverse":
        assert not compare.judge(out["half_batch"], cell["mix"]["limits"])[0]
    assert not compare.judge(out["control"], cell["mix"]["limits"])[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name,kind", CELLS)
def test_on_the_card(name, kind, tmp_path, monkeypatch):
    """The same at the small size on the card, through the CUDA kernels:
    a sound run is correct, one with its answers altered is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = _cell(name, tmp_path, monkeypatch)
    out = _run(cell, "cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    _answer_altered(monkeypatch, kind)
    assert not _run(cell, "cuda")["correct"]
