"""The sharded renderer, the sharded training step, the scaling harness and
the CLI's multi-process flags of the PyTorch port (parallel/mesh.py), with
ranks spawned as processes of their own over gloo on the CPU
(`parallel.mesh.spawn`; their functions are in torch_mesh_ranks.py).

A world of 3 renders whole wavefront batches (64x64 pixels: four batches
of 1,024 lanes, ranks 0-2 taking [0, 3], [1], [2]) and sums its films in
one all-reduce. At 1 spp the film equals the single process's rendered at
the same batch, rgb / weight / aov to the bit, for path, volpath,
directlighting, whitted, ambientocclusion and BDPT, a crop window with
max_sample_luminance, the counters' AOVs and a world that leaves lanes
padded: a lane's value does not depend on its batch, and the CPU's
index_add sums a pixel's samples in lane order, so each rank's film holds
the same partial sums and adding films that are zero where the other
ranks' lanes landed is exact. (On the card, index_add's atomics sum a
pixel of three or four samples in no fixed order, also within one
process; chip_smoke.py's mesh phase holds those pixels to 1e-6
relative.) BDPT's t == 1 splats land
anywhere and are summed in another order: within 1e-6 of the largest
splat (measured: up to 1.2e-7 absolute on 4,096 pixels). The comparisons
against the JAX package's sharded renderer and training step are in
test_torch_mesh_parity.py."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import (ShardedRenderer, make_mesh,
                                       sharded_batch, spawn, train_step_fn)
from tpupt_torch.utils import imageio

# one intra-op thread here and in each rank: the tier-1 run puts six test
# processes on the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0
SPLAT_TOL = 1e-6  # of the largest splat

ROOM = """
LookAt 0 1 4.5  0 1 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [$RES] "integer yresolution" [$RES]
Sampler "halton" "integer pixelsamples" [1]
Integrator "$INT" "integer maxdepth" [3]
WorldBegin
$MEDIA
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6] "bool twosided" "true"
  Translate 0 1.98 0
  Shape "trianglemesh" "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
    "integer indices" [0 2 1 0 3 2]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "point P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2] "integer indices" [0 1 2 2 3 0]
Material "plastic" "rgb Kd" [0.3 0.3 0.6] "float roughness" [0.1]
Shape "sphere" "float radius" [0.6]
WorldEnd
"""
FOG = """MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.05 0.08 0.1] "rgb sigma_s" [0.6 0.5 0.4] "float g" [0.3]
AttributeBegin
  Material "none"
  MediumInterface "fog" ""
  Translate -0.9 0.7 0.8
  Shape "sphere" "float radius" [0.5]
AttributeEnd"""


def room(integrator="path", res=64, media=""):
    return (ROOM.replace("$INT", integrator).replace("$RES", str(res))
            .replace("$MEDIA", media))


# name: (scene text, scene_of keywords, Renderer keywords)
CASES = {
    "path": (room(), {}, {}),
    "volpath": (room("volpath", media=FOG), {}, {}),
    "directlighting": (room("directlighting"), {}, {}),
    "whitted": (room("whitted"), {}, {}),
    "ambientocclusion": (room("ambientocclusion"), {}, {}),
    "bdpt": (room("bdpt"), {}, {}),
    # 64x64 pixels of an 80x80 film
    "crop_and_clamp": (room(res=80), dict(crop=(0.1, 0.9, 0.1, 0.9),
                                          max_sample_luminance=0.5), {}),
    "aovs": (room(), {}, dict(collect_stats=True)),
    # 2,304 pixels in three batches of 1,024: the last one padded
    "padded_lanes": (room(res=48), {}, {}),
}
WORLD = 3


@pytest.fixture(scope="module")
def three_ranks():
    """Every case rendered once by three ranks at 1 spp."""
    cases = [(k, txt, 1, skw, rkw) for k, (txt, skw, rkw) in CASES.items()]
    return spawn(ranks.render_cases, WORLD, (cases,), device="cpu",
                 threads=1, timeout_s=SPAWN_TIMEOUT_S)


def _single(name):
    txt, skw, rkw = CASES[name]
    sc = ranks.scene_of(txt, **skw)
    r = Renderer(sc, device="cpu", **rkw)
    r.set_batch(sharded_batch(r.n_pixels, WORLD))
    film = r.render(spp=1)
    return sc, r, film


@pytest.mark.parametrize("name", list(CASES))
def test_three_ranks_render_the_single_process_film(name, three_ranks):
    out = three_ranks
    sc, r, film = _single(name)
    films = [o[name][0] for o in out]
    for f in films[1:]:
        for k, v in f.items():
            assert torch.equal(v, films[0][k]), (name, k)
    got = films[0]
    n_batches = r.n_batches
    assert [o[name][1] for o in out] == [list(range(k, n_batches, WORLD))
                                         for k in range(WORLD)]
    assert all(o[name][1] for o in out), "a rank without a batch"
    for k in ("rgb", "weight", "aov"):
        assert torch.equal(got[k], getattr(film, k)), (name, k)
    if name == "bdpt":
        ref = film.splat
        assert float(ref.abs().max()) > 0
        err = float((got["splat"] - ref).abs().max())
        assert err <= SPLAT_TOL * float(ref.abs().max()), err
    else:
        assert torch.equal(got["splat"], film.splat), name
    np.testing.assert_allclose(out[0][name][2], r.image(film),
                               rtol=1e-6, atol=1e-7)
    assert float(film.weight.sum()) > 0 and torch.isfinite(film.rgb).all()
    if name == "crop_and_clamp":
        # pixels 8..71 a side (a zero jitter adds to the pixel before)
        w = film.weight.reshape(sc.film.yres, sc.film.xres)
        inside = torch.zeros_like(w, dtype=torch.bool)
        inside[7:72, 7:72] = True
        assert float(w[~inside].abs().sum()) == 0
        assert float(w[inside].sum()) > 0.9 * 64 * 64
        unclamped = Renderer(ranks.scene_of(CASES[name][0],
                                            crop=(0.1, 0.9, 0.1, 0.9)),
                             device="cpu")
        unclamped.set_batch(r.batch)
        assert not torch.equal(unclamped.render(spp=1).rgb, film.rgb)
    if name == "aovs":
        assert float(got["aov"][:, 0].sum()) > 0  # node visits counted
    if name == "padded_lanes":
        assert r.n_batches == WORLD and not bool(r._valid_b[-1].all())


def test_a_mesh_of_one_renders_as_the_renderer():
    """No process group: the mesh of one renders the renderer's batches and
    reduces nothing."""
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == (
        None, 0, 1, "cpu")
    sc = ranks.scene_of(room(res=32))
    sr = ShardedRenderer(sc, mesh)
    film = sr.render(spp=1)
    r = Renderer(sc, device="cpu")
    ref = r.render(spp=1)
    assert sr.batch == r.batch and sr.batches == list(range(r.n_batches))
    for k in ref._fields:
        assert torch.equal(getattr(film, k), getattr(ref, k)), k


@pytest.mark.parametrize("n_pixels,size,batch", [
    (4096, 1, 4096), (4096, 3, 1024), (2304, 2, 2048), (2304, 3, 1024),
    (1 << 20, 4, 131072), (1 << 20, 16, 65536), (500, 4, 1024),
    (65536, 2, 32768)])
def test_the_batch_is_cut_until_every_rank_has_one(n_pixels, size, batch):
    assert sharded_batch(n_pixels, size) == batch


def test_several_devices_in_one_process_raise():
    """One process drives one device: a list of several raises, naming
    init_distributed; a list of one is that device."""
    with pytest.raises(ValueError, match="init_distributed"):
        make_mesh(["cpu", "cpu"])
    sc = ranks.scene_of(room(res=16))
    with pytest.raises(ValueError, match="init_distributed"):
        train_step_fn(sc, ["cpu", "cpu"], np.zeros((16, 16, 3), np.float32),
                      device="cpu")
    assert make_mesh(["cpu"]).device.type == "cpu"


def test_a_failing_rank_fails_the_run_and_hangs_nothing():
    """Rank 1 raises while rank 0 waits in an all-reduce: spawn raises with
    rank 1's traceback, and rank 0 is killed, not left waiting for the
    collective's timeout."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(ranks.rank_one_fails, 2, device="cpu", threads=1,
              timeout_s=SPAWN_TIMEOUT_S)
    assert time.time() - t0 < 60


def test_two_rank_training_step_and_scaling_curve():
    """The training step over two ranks equals the one-process step (the
    gradient sums in another order: 1e-6 of each table's largest step),
    and `scaling_curve` at [1, 2] gives both ranks the same rows, with
    efficiency 1.0 at one rank."""
    txt = room(res=48).replace('"integer maxdepth" [3]',
                               '"integer maxdepth" [2]')
    sc = ranks.scene_of(txt)
    r = Renderer(sc, device="cpu")
    target = (0.5 * r.image(r.render(spp=1))).astype(np.float32)
    fields = {k: v.numpy() for k, v in r.ds._asdict().items()
              if v is not None}
    statics = dict(r.st._asdict())
    lr = 1e-3
    got = spawn(ranks.train_step, 2, (txt, fields, statics, target, lr,
                                      (48, 48)),
                device="cpu", threads=1, timeout_s=SPAWN_TIMEOUT_S)
    step, p0 = train_step_fn(sc, None, target, device="cpu")
    loss, new = step(p0, 0, lr)
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[0][0], float(loss), rtol=1e-6)
    for k in new:
        assert torch.equal(got[0][1][k], got[1][1][k]), k
        d_ref = (p0[k] - new[k]) / lr
        d_got = (p0[k] - got[0][1][k]) / lr
        scale = float(d_ref.abs().max())
        ulp = float(np.spacing(np.abs(p0[k].numpy())).max()) / lr
        assert float((d_got - d_ref).abs().max()) <= 1e-6 * scale + ulp, k
    assert float((p0["mat_kd"] - new["mat_kd"]).abs().max()) > 0

    curves = spawn(ranks.scaling, 2, (room(res=32), [1, 2], 1), device="cpu",
                   threads=1, timeout_s=SPAWN_TIMEOUT_S)
    assert curves[0] == curves[1]
    assert [c["n_devices"] for c in curves[0]] == [1, 2]
    assert all(c["rays_per_s"] > 0 for c in curves[0])
    assert curves[0][0]["efficiency"] == 1.0


def test_cli_distributed_writes_the_one_process_image(tmp_path):
    """`render --cpu --distributed` over two processes meeting through a
    file writes the image the one-process `--cpu` render writes, from rank
    0 only."""
    from tpupt_torch.tools import render

    scene = tmp_path / "room.pbrt"
    scene.write_text(room(res=48))
    one = str(tmp_path / "one.pfm")
    assert render.main([str(scene), "--cpu", "--quiet", "-o", one]) == 0
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpupt_torch.tools.render", str(scene),
         "--cpu", "--quiet", "--distributed", init, "--num-hosts", "2",
         "--host-id", str(i), "-o", str(tmp_path / f"rank{i}.pfm")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert not (tmp_path / "rank1.pfm").exists()
    np.testing.assert_array_equal(
        imageio.read_pfm(str(tmp_path / "rank0.pfm")), imageio.read_pfm(one))
