"""Small seeded scenes and ray batches for parity checks: the random
triangle soup and the one-of-every-quadric-kind scene that the traversal
tests and the on-card smoke run share. Everything is made with numpy from a
seed and returned as pbrt text / numpy arrays, so that two implementations
can be fed the same inputs."""

from __future__ import annotations

import numpy as np


def _triangle_soup(rng, n_tris: int, edge_sigma: float):
    c = rng.uniform(-3, 3, (n_tris, 3))
    e1 = rng.normal(0, edge_sigma, (n_tris, 3))
    e2 = rng.normal(0, edge_sigma, (n_tris, 3))
    pts, idx = [], []
    for i in range(n_tris):
        pts.extend([c[i], c[i] + e1[i], c[i] + e2[i]])
        idx.extend([3 * i, 3 * i + 1, 3 * i + 2])
    p_str = " ".join(f"{v:.5f}" for row in pts for v in row)
    i_str = " ".join(str(i) for i in idx)
    return p_str, i_str


def _wrap(p_str: str, i_str: str, body: str) -> str:
    return f"""
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path"
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [{p_str}] "integer indices" [{i_str}]
{body}
WorldEnd
"""


def random_triangles_pbrt(n_tris: int = 60, n_spheres: int = 0,
                          seed: int = 3) -> str:
    """Random triangles in [-3,3]^3, optionally with translated spheres."""
    rng = np.random.default_rng(seed)
    p_str, i_str = _triangle_soup(rng, n_tris, 0.4)
    sph = ""
    for _ in range(n_spheres):
        x, y, z = rng.uniform(-3, 3, 3)
        r = rng.uniform(0.2, 0.8)
        sph += (f'AttributeBegin\nTranslate {x:.4f} {y:.4f} {z:.4f}\n'
                f'Shape "sphere" "float radius" [{r:.4f}]\nAttributeEnd\n')
    return _wrap(p_str, i_str, sph)


def moving_triangles_pbrt(n_tris: int = 60, n_groups: int = 4,
                          n_spheres: int = 0, seed: int = 13) -> str:
    """Random triangles in [-3,3]^3 in `n_groups` meshes, each moving over
    the shutter by its own random translation and turn about a random axis
    (an `ActiveTransform EndTime` key), so that vertex deltas differ vertex
    by vertex; optionally with static spheres among them."""
    rng = np.random.default_rng(seed)
    body = ""
    for _ in range(n_groups):
        p_str, i_str = _triangle_soup(rng, n_tris // n_groups, 0.4)
        tx, ty, tz = rng.normal(0, 0.4, 3)
        ax = rng.normal(0, 1, 3)
        ax /= np.linalg.norm(ax)
        ang = rng.uniform(-25, 25)
        body += (f'AttributeBegin\nActiveTransform EndTime\n'
                 f'Translate {tx:.4f} {ty:.4f} {tz:.4f}\n'
                 f'Rotate {ang:.3f} {ax[0]:.4f} {ax[1]:.4f} {ax[2]:.4f}\n'
                 f'ActiveTransform All\n'
                 f'Shape "trianglemesh" "point P" [{p_str}] '
                 f'"integer indices" [{i_str}]\nAttributeEnd\n')
    for _ in range(n_spheres):
        x, y, z = rng.uniform(-3, 3, 3)
        r = rng.uniform(0.2, 0.8)
        body += (f'AttributeBegin\nTranslate {x:.4f} {y:.4f} {z:.4f}\n'
                 f'Shape "sphere" "float radius" [{r:.4f}]\nAttributeEnd\n')
    return f"""
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path"
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.5]
{body}
WorldEnd
"""


def quadric_kinds_pbrt(seed: int = 5, n_tris: int = 20) -> str:
    """A few triangles plus one of EVERY analytic quadric kind, each under a
    random rigid transform: exercises the unified quadric row test."""
    rng = np.random.default_rng(seed)
    p_str, i_str = _triangle_soup(rng, n_tris, 0.5)
    shapes = [
        'Shape "sphere" "float radius" [0.7]',
        'Shape "cylinder" "float radius" [0.5] "float zmin" [-0.6]'
        ' "float zmax" [0.9]',
        'Shape "disk" "float radius" [1.1] "float height" [0.2]'
        ' "float innerradius" [0.3]',
        'Shape "cone" "float radius" [0.8] "float height" [1.2]',
        'Shape "paraboloid" "float radius" [0.7] "float zmax" [1.0]',
        'Shape "hyperboloid" "point p1" [0.8 0 -0.3] "point p2" [0.4 0 0.9]',
        'Shape "cylinder" "float radius" [0.5] "float zmax" [1.0]'
        ' "float phimax" [220]',
    ]
    body = ""
    for s in shapes:
        x, y, z = rng.uniform(-2.5, 2.5, 3)
        ax = rng.normal(0, 1, 3)
        ax /= np.linalg.norm(ax)
        ang = rng.uniform(0, 360)
        body += (f'AttributeBegin\nTranslate {x:.4f} {y:.4f} {z:.4f}\n'
                 f'Rotate {ang:.3f} {ax[0]:.4f} {ax[1]:.4f} {ax[2]:.4f}\n'
                 f'{s}\nAttributeEnd\n')
    return _wrap(p_str, i_str, body)


def triangle_clusters_pbrt(n_tris: int = 600, n_clusters: int = 12,
                           n_spheres: int = 0, seed: int = 0,
                           lights: bool = False) -> str:
    """Random triangle clusters in [-8,8]^3: a deep BVH with well-separated
    subtrees, which small treelet capacities cut into many treelets.
    `lights` adds a distant and a point light, to render it."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (n_clusters, 3))
    base = (centers[rng.integers(0, n_clusters, n_tris)]
            + rng.normal(0, 0.5, (n_tris, 3)))
    e1 = rng.normal(0, 0.3, (n_tris, 3))
    e2 = rng.normal(0, 0.3, (n_tris, 3))
    pts = np.concatenate([base, base + e1, base + e2], axis=1).reshape(-1)
    p_str = " ".join(f"{v:.5f}" for v in pts)
    i_str = " ".join(str(i) for i in range(3 * n_tris))
    sph = ""
    for _ in range(n_spheres):
        x, y, z = rng.uniform(-8, 8, 3)
        sph += (f'AttributeBegin\nTranslate {x:.4f} {y:.4f} {z:.4f}\n'
                f'Shape "sphere" "float radius" [{rng.uniform(0.5, 1.5):.4f}]'
                '\nAttributeEnd\n')
    if lights:
        sph += ('LightSource "distant" "point from" [0 20 5] "point to" '
                '[0 0 0] "rgb L" [2 2 2]\n'
                'LightSource "point" "point from" [0 0 0] "rgb I" [60 50 40]\n')
    return _wrap(p_str, i_str, sph)


def accelerator_scene_pbrt(n_tris: int = 40, seed: int = 11) -> str:
    """Two quads, two spheres and `n_tris` random triangles under a LookAt
    camera: the scene the kd / RBSP / BSP accelerators are checked on."""
    rng = np.random.default_rng(seed)
    p_str, i_str = _triangle_soup(rng, n_tris, 0.5)
    return f"""
LookAt 3 2 4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [40] "integer yresolution" [40]
WorldBegin
Material "matte"
Shape "trianglemesh" "point P" [-2 -1 0  2 -1 0  2 1 0  -2 1 0] "integer indices" [0 1 2 2 3 0]
Shape "sphere" "float radius" [0.6]
AttributeBegin
  Translate 0.8 0.5 1.2
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Shape "trianglemesh" "point P" [-3 -3 -1  3 -3 -1  3 3 -1  -3 3 -1] "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [{p_str}] "integer indices" [{i_str}]
WorldEnd
"""


# the twelve accelerator names of the kd / RBSP / BSP family with the
# "integer nbDirections" each is checked with (None: the default)
ALT_ACCELERATORS = [
    ("kdtree", None), ("rbsp", 3), ("rbsp", 7), ("rbsp", 13),
    ("bspcluster", 3), ("bsparbitrary", 4), ("bsprandom", 4),
    ("bspclusterwithkd", 6), ("bsparbitraryfastkd", 6),
    ("bsprandomwithkd", 6), ("bsppaper", None), ("bsppaperkd", None)]


def aimed_rays(n: int, seed: int, lo, hi, radius: float = None):
    """(o, d) float32: origins on a sphere around the box [lo, hi], directions
    toward uniform targets inside it (random directions mostly miss)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    center = 0.5 * (lo + hi)
    if radius is None:
        radius = 1.5 * float(np.linalg.norm(hi - lo)) * 0.5 + 1e-3
    o = rng.normal(0, 1, (n, 3))
    o = center + radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = rng.uniform(lo, hi, (n, 3))
    d = tgt - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def ulp_distance(a, b) -> np.ndarray:
    """Distance of two float32 arrays in units in the last place."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def tables_as_numpy(ds, st):
    """(dict of numpy arrays, dict of Python values) from any NamedTuple pair
    of device tables and statics, whatever array library holds them: the
    form `scene.device.from_numpy` takes."""
    fields = {k: np.asarray(v) for k, v in ds._asdict().items()
              if v is not None}
    return fields, dict(st._asdict())


def _write_appearance_maps(out_dir: str, tex_res: int, env_res, gonio_res,
                          seed: int = 5) -> dict:
    """Write the maps of `textured_museum` as PFM files under out_dir, made
    with numpy from `seed`: a floor texture (tex_res x tex_res: tiles with
    fine stripes, so that the MIP levels differ), an equirect sky (env_res =
    (width, height): a dim gradient with a small bright sun disc, so that
    importance sampling matters) and a goniometric map (gonio_res: bands
    over theta and phi). Returns their file names."""
    import os

    from tpupt_torch.utils.imageio import write_pfm

    rng = np.random.default_rng(seed)
    n = tex_res
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    tiles = (np.floor(xx * 8) + np.floor(yy * 8)) % 2
    stripes = 0.5 + 0.5 * np.sin(xx * n * 0.9 + 3.0 * yy)
    base = rng.uniform(0.3, 0.7, 3).astype(np.float32)
    floor = (base * (0.6 + 0.3 * tiles[..., None])
             * (0.8 + 0.2 * stripes[..., None])).astype(np.float32)
    ew, eh = env_res
    v, u = np.mgrid[0:eh, 0:ew].astype(np.float32)
    theta = (v + 0.5) / eh * np.pi
    phi = (u + 0.5) / ew * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1)
    sun = np.array([np.sin(0.7) * np.cos(1.1), np.sin(0.7) * np.sin(1.1),
                    np.cos(0.7)], np.float32)
    sky = np.where(d[..., 2:] > 0, [0.35, 0.45, 0.7], [0.08, 0.07, 0.06])
    env = (sky * (0.6 + 0.4 * np.abs(d[..., 2:]))).astype(np.float32)
    env[d @ sun > np.cos(0.04)] = [900.0, 820.0, 700.0]
    gw, gh = gonio_res
    gv, gu = np.mgrid[0:gh, 0:gw].astype(np.float32)
    gon = 0.2 + 0.8 * (0.5 + 0.5 * np.cos(gv / gh * 6 * np.pi)
                       * np.cos(gu / gw * 4 * np.pi))
    gon = np.repeat(gon[..., None], 3, -1).astype(np.float32)
    names = {"floor": "floor.pfm", "env": "env.pfm", "gonio": "gonio.pfm"}
    for key, img in (("floor", floor), ("env", env), ("gonio", gon)):
        write_pfm(os.path.join(out_dir, names[key]), img)
    return names


def textured_museum(out_dir: str, tex_res: int = 2048, env_res=(2048, 1024),
                    gonio_res=(256, 128), seed: int = 5, **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings) with its
    appearance made real: an imagemap Kd on the floor (`float uv`, uscale /
    vscale 4, so that grazing views pick coarse MIP levels and the
    anisotropic taps), a closed-form antialiased checkerboard on the back
    wall, marble Kd and wrinkled (turbulence) Ks on the statues, and in
    place of the distant light an environment-mapped infinite light and a
    goniometric light; the ceiling's area light stays. Writes
    textured_museum.pbrt beside museum.pbrt and returns its path."""
    import os
    import re

    from tpupt_torch.tools import genscene

    path = genscene.museum(out_dir, **size)
    maps = _write_appearance_maps(out_dir, tex_res, env_res, gonio_res, seed)
    lines = open(path).read().splitlines()
    out = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith('LightSource "distant"'):
            out += [
                f'LightSource "infinite" "string mapname" ["{maps["env"]}"] '
                '"rgb L" [1 1 1]',
                "AttributeBegin",
                "  Translate 0 -4 4.5",
                f'  LightSource "goniometric" "rgb I" [40 38 34] '
                f'"string mapname" ["{maps["gonio"]}"]',
                "AttributeEnd"]
        elif line == "# floor + back wall":
            out += [
                line,
                f'Texture "floor" "spectrum" "imagemap" "string filename" '
                f'["{maps["floor"]}"] "float uscale" [4] "float vscale" [4]',
                'Texture "wall" "spectrum" "checkerboard" "float uscale" [16] '
                '"float vscale" [16] "rgb tex1" [0.7 0.68 0.62] '
                '"rgb tex2" [0.25 0.24 0.22]',
                'Texture "marble" "spectrum" "marble" "float scale" [1.5]',
                'Texture "wrinkled" "spectrum" "wrinkled"',
                'Material "matte" "texture Kd" "floor"']
            i += 1  # the untextured floor material
            for k in range(2):  # floor, then the back wall
                if k == 1:
                    out.append('Material "matte" "texture Kd" "wall"')
                out.append(lines[i + 1])
                out.append(lines[i + 2] + ' "float uv" [0 0 1 0 1 1 0 1]')
                i += 2
        elif line.startswith('Material "plastic"'):
            out.append(re.sub(r'"rgb Kd" \[[^\]]*\] "rgb Ks" \[[^\]]*\]',
                              '"texture Kd" "marble" "texture Ks" "wrinkled"',
                              line))
        else:
            out.append(line)
        i += 1
    text = "\n".join(out) + "\n"
    if ('"texture Kd" "marble"' not in text or '"infinite"' not in text
            or text.count('"float uv"') != 2):
        raise ValueError("the museum's scene file changed: cannot texture it")
    dst = os.path.join(out_dir, "textured_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


def fourier_test_table(n_mu: int = 12, m_max: int = 5, seed: int = 9,
                       eta: float = 1.5) -> dict:
    """A synthetic three-channel Fourier BSDF table (the dict that
    materials/fourier.py reads and writes), made with numpy from `seed`: a
    glossy reflection lobe whose series order per (muI, muO) knot pair
    varies from 1 to `m_max` (a_k = a_0 r^k cos-series, r in [0.3, 0.7]),
    with a per-channel tint; knots uniform in [-1, 1]; the marginal cdf
    rows the trapezoid integral of 2 pi a_0 (luminance) over muI, as the
    file format stores them (fourier.cpp:188)."""
    rng = np.random.default_rng(seed)
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    tint = rng.uniform(0.4, 0.9, 3)
    m = np.zeros(n_mu * n_mu, np.int32)
    aoffset = np.zeros(n_mu * n_mu, np.int32)
    coeffs = []
    a0_of = np.zeros((n_mu, n_mu))        # [muO index, muI index]
    for oj in range(n_mu):
        for oi in range(n_mu):
            if mu[oi] * mu[oj] >= 0:      # reflection only: -wi and wo apart
                continue
            idx = oj * n_mu + oi
            k_n = int(rng.integers(1, m_max + 1))
            r = rng.uniform(0.3, 0.7)
            a0 = 0.5 / np.pi * abs(mu[oi]) * (0.6 + 0.4 * abs(mu[oj]))
            series = a0 * r ** np.arange(k_n)
            rgb = series[None, :] * tint[:, None]
            y = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
            aoffset[idx] = len(coeffs)
            m[idx] = k_n
            # channel order Y, R, B (fourier.cpp: luminance first)
            coeffs.extend(np.concatenate([y, rgb[0], rgb[2]]))
            a0_of[oj, oi] = y[0]
    cdf = np.zeros((n_mu, n_mu), np.float32)
    for oj in range(n_mu):
        for oi in range(1, n_mu):
            cdf[oj, oi] = cdf[oj, oi - 1] + 2.0 * np.pi * 0.5 * (
                a0_of[oj, oi] + a0_of[oj, oi - 1]) * (mu[oi] - mu[oi - 1])
    return dict(mu=mu, a=np.asarray(coeffs, np.float32), cdf=cdf.reshape(-1),
                aoffset=aoffset, m=m, m_max=int(m.max()), n_mu=n_mu,
                n_channels=3, eta=float(eta))


# the statues' materials of `materials_museum`, statue i taking entry
# i % len(...); the mix's children are named materials
MATERIALS_MUSEUM_MATERIALS = (
    'Material "disney" "rgb color" [0.8 0.55 0.3] "float metallic" [0.8] '
    '"float roughness" [0.3] "float clearcoat" [0.7] '
    '"float clearcoatgloss" [0.8] "float sheen" [0.5] "float anisotropic" [0.4]',
    'Material "disney" "rgb color" [0.75 0.85 0.9] "float spectrans" [0.8] '
    '"float roughness" [0.2] "float eta" [1.45]',
    'Material "disney" "rgb color" [0.4 0.7 0.35] "bool thin" "true" '
    '"float difftrans" [0.6] "float flatness" [0.5] "float roughness" [0.5] '
    '"float spectrans" [0.3]',
    'Material "mix" "string namedmaterial1" "statue_plastic" '
    '"string namedmaterial2" "statue_metal" "rgb amount" [0.2 0.5 0.8]',
    'Material "fourier" "string bsdffile" ["statue.bsdf"]',
    'Material "subsurface" "rgb sigma_a" [0.02 0.05 0.12] '
    '"rgb sigma_prime_s" [1.8 2.2 2.6] "float scale" [2] "float eta" [1.4]',
    'Material "kdsubsurface" "rgb Kd" [0.7 0.45 0.35] "float mfp" [0.3]',
    'Material "plastic" "rgb Kd" [0.32 0.30 0.34] "rgb Ks" [0.35 0.35 0.35] '
    '"float roughness" [0.08]',
)


def materials_museum(out_dir: str, n_hairs: int = 256, seed: int = 11,
                     **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings; the statues the
    same triangles) with pbrt-v3's other materials on its statues, statue i
    taking MATERIALS_MUSEUM_MATERIALS[i % 8]: Disney (metallic with
    clearcoat and sheen; specTrans; thin), a mix of plastic and metal with
    a spectrum amount, a Fourier BSDF from statue.bsdf (written beside the
    scene by materials/fourier.py's writer from `fourier_test_table`), a
    subsurface with explicit sigma_a / sigma_prime_s, a kdsubsurface and
    the original plastic; a tuft of `n_hairs` cubic curves in hair in
    front of the statues; the area and distant lights; Sampler "sobol".
    At least 7 statues (grid >= 3) put every family in the scene. Writes
    materials_museum.pbrt (and one PLY a material) beside museum.pbrt and
    returns its path."""
    import os

    from tpupt_torch.materials.fourier import write_bsdf_file

    write_bsdf_file(os.path.join(out_dir, "statue.bsdf"),
                    fourier_test_table())
    mats = MATERIALS_MUSEUM_MATERIALS
    head = [
        'MakeNamedMaterial "statue_plastic" "string type" "plastic" '
        '"rgb Kd" [0.6 0.2 0.15] "rgb Ks" [0.4 0.4 0.4] "float roughness" '
        '[0.05]',
        'MakeNamedMaterial "statue_metal" "string type" "metal" '
        '"float roughness" [0.15]']
    # the hair tuft: curves rising from the floor in front of the statues
    rng = np.random.default_rng(seed)
    front = -(size.get("grid", 8) * 3.0) / 2.0 - 0.5
    hair = ['Material "hair" "float eumelanin" [0.8] "float beta_m" [0.25] '
            '"float beta_n" [0.3]']
    for _ in range(n_hairs):
        x0, y0 = rng.uniform(-1.5, 1.5), front + rng.uniform(-0.4, 0.4)
        lean = rng.normal(0, 0.25, 2)
        cps = [(x0, y0, 0.0),
               (x0 + lean[0] * 0.3, y0 + lean[1] * 0.3, 0.5),
               (x0 + lean[0] * 0.7, y0 + lean[1] * 0.7, 1.0),
               (x0 + lean[0], y0 + lean[1], 1.4 + rng.uniform(0, 0.4))]
        p_str = " ".join(f"{v:.4f}" for c in cps for v in c)
        hair.append(f'Shape "curve" "point P" [{p_str}] "float width" '
                    '[0.03] "string type" "flat"')
    text = _split_statues(
        out_dir, len(mats),
        lambda k, name, P, faces: [
            mats[k], f'Shape "plymesh" "string filename" ["{name}"]'],
        head=head, tail=hair, **size)
    text = text.replace('Sampler "halton"', 'Sampler "sobol"')
    if 'Sampler "sobol"' not in text:
        raise ValueError("the museum's scene file changed: cannot dress it")
    dst = os.path.join(out_dir, "materials_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


# a lens of this package's own devising (pbrt's lens-file rows, in mm:
# curvature radius, thickness toward the film, eta of the medium behind,
# aperture diameter): two positive elements, an aperture stop (the radius-0
# row; eta 0 reads as air), a negative and a positive element, about 37 mm
# of focal length, so that on pbrt's 35 mm film diagonal it sees about 51
# degrees, near the museum's perspective camera
TEST_LENS_ROWS = ((21.0, 3.75, 1.65, 19.5),
                  (90.0, 2.25, 1.0, 18.0),
                  (0.0, 3.0, 0.0, 10.5),
                  (-30.0, 1.5, 1.6, 15.0),
                  (45.0, 4.5, 1.65, 16.5),
                  (-27.0, 22.5, 1.0, 18.0))


def write_lens_file(path: str, rows=TEST_LENS_ROWS) -> str:
    """Write `rows` as a pbrt lens description file; returns `path`."""
    with open(path, "w") as f:
        f.write("# radius  thickness  eta  aperture-diameter (mm)\n")
        for r in rows:
            f.write("  ".join(f"{v:g}" for v in r) + "\n")
    return path


def motion_museum(out_dir: str, shift=(0.45, 0.0, 0.15), turn: float = 40.0,
                  camera_shift: float = 0.6, **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings; the same
    triangles) with its statues moving over the shutter: statue 0 turns by
    `turn` degrees about its own vertical axis (so its vertex deltas differ
    vertex by vertex), the others translate by `shift`, each through an
    `ActiveTransform EndTime` key; and the camera animated, its shutter-close
    LookAt moved `camera_shift` along x. Writes motion_museum.pbrt (and one
    PLY a group) beside museum.pbrt and returns its path."""
    import os
    import re

    from tpupt_torch.scene.plyio import read_ply, write_ply
    from tpupt_torch.tools import genscene

    path = genscene.museum(out_dir, **size)
    grid = size.get("grid", 8)
    mesh = read_ply(os.path.join(out_dir, "museum.ply"))
    faces = mesh["indices"].reshape(grid * grid, -1, 3)
    turning = faces[0].reshape(-1)
    c = mesh["P"][np.unique(turning)].mean(0)
    groups = [("statue_turning.ply",
               f"  Translate {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n"
               f"  Rotate {turn:g} 0 0 1\n"
               f"  Translate {-c[0]:.6f} {-c[1]:.6f} {-c[2]:.6f}\n",
               faces[:1]),
              ("statues_moving.ply",
               "  Translate {:g} {:g} {:g}\n".format(*shift), faces[1:])]
    lines = []
    for name, key, fs in groups:
        write_ply(os.path.join(out_dir, name), mesh["P"], fs.reshape(-1, 3),
                  N=mesh.get("N"))
        lines += ["AttributeBegin", "  ActiveTransform EndTime", key.rstrip(),
                  "  ActiveTransform All",
                  f'  Shape "plymesh" "string filename" ["{name}"]',
                  "AttributeEnd"]
    text = open(path).read()
    look = re.search(r"^LookAt ([^\n]*)$", text, re.M)
    v = [float(x) for x in look.group(1).split()]
    moved = v[:]
    moved[0] += camera_shift
    moved[3] += camera_shift
    text = text.replace(
        look.group(0),
        "ActiveTransform StartTime\nLookAt "
        + " ".join(f"{x:g}" for x in v) + "\nActiveTransform EndTime\nLookAt "
        + " ".join(f"{x:g}" for x in moved) + "\nActiveTransform All")
    text, n = re.subn(r'Shape "plymesh" "string filename" \["museum.ply"\]',
                      "\n".join(lines), text)
    if n != 1:
        raise ValueError("the museum's scene file changed: cannot move it")
    dst = os.path.join(out_dir, "motion_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


def realistic_museum(out_dir: str, focus: float = None,
                     aperture_mm: float = 10.0, **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings) seen through
    the realistic camera with the lens of `write_lens_file` (written beside
    it as test_lens.dat), focused at `focus` (default: the museum's centre)
    with an aperture stop of `aperture_mm`. Writes realistic_museum.pbrt and
    returns its path."""
    import os

    from tpupt_torch.tools import genscene

    path = genscene.museum(out_dir, **size)
    write_lens_file(os.path.join(out_dir, "test_lens.dat"))
    grid = size.get("grid", 8)
    if focus is None:
        focus = grid * 3.0 * 1.1
    text = open(path).read()
    old = 'Camera "perspective" "float fov" [52]'
    if old not in text:
        raise ValueError("the museum's scene file changed: cannot refocus it")
    text = text.replace(old, (
        'Camera "realistic" "string lensfile" ["test_lens.dat"] '
        f'"float aperturediameter" [{aperture_mm:g}] '
        f'"float focusdistance" [{focus:g}]'))
    dst = os.path.join(out_dir, "realistic_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


# saturated rows of the spectral museum: under spectral transport their
# products with the blackbody light are metamer products, and some samples
# come out of gamut
SPECTRAL_MUSEUM_MATERIALS = (
    'Material "matte" "rgb Kd" [0.85 0.04 0.03]',
    'Material "matte" "rgb Kd" [0.03 0.8 0.06]',
    'Material "plastic" "rgb Kd" [0.04 0.06 0.85] "rgb Ks" [0.3 0.3 0.3] '
    '"float roughness" [0.1]',
    'Material "plastic" "rgb Kd" [0.8 0.7 0.02] "rgb Ks" [0.25 0.25 0.25] '
    '"float roughness" [0.05]',
    'Material "matte" "rgb Kd" [0.7 0.02 0.75]',
    'Material "matte" "rgb Kd" [0.02 0.7 0.8]',
)


def _split_statues(out_dir: str, groups: int, lines_for, head=(),
                   tail=(), **size) -> str:
    """The scene text of tools/genscene.py's museum (`size`: grid, seg,
    rings; written to out_dir) with its one statue mesh replaced by one PLY
    a group of statues (group k: statues k, k + groups, ...), each group's
    lines from `lines_for(k, ply name, vertices, its faces)` around its
    `Shape "plymesh"` line, after the lines `head` and before `tail`."""
    import os
    import re

    from tpupt_torch.scene.plyio import read_ply, write_ply
    from tpupt_torch.tools import genscene

    path = genscene.museum(out_dir, **size)
    grid = size.get("grid", 8)
    mesh = read_ply(os.path.join(out_dir, "museum.ply"))
    n_statues = grid * grid
    faces = mesh["indices"].reshape(n_statues, -1, 3)
    if faces.shape[1] != 2 * size.get("seg", 96) * size.get("rings", 48):
        raise ValueError("the museum's statues changed: cannot split them")
    lines = list(head)
    for k in range(groups):
        ids = np.arange(k, n_statues, groups)
        if not len(ids):
            continue
        name = f"statues_{k}.ply"
        write_ply(os.path.join(out_dir, name), mesh["P"],
                  faces[ids].reshape(-1, 3), N=mesh.get("N"))
        lines += lines_for(k, name, mesh["P"], faces[ids])
    text, n = re.subn(r'Material "plastic"[^\n]*\nShape "plymesh"[^\n]*\n',
                      "\n".join(lines + list(tail)) + "\n", open(path).read())
    if n != 1:
        raise ValueError("the museum's scene file changed: cannot split it")
    return text


def spectral_museum(out_dir: str, temperature: float = 3200.0,
                    **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings; the same
    triangles) for spectral transport: its statues in the saturated matte
    and plastic rows of SPECTRAL_MUSEUM_MATERIALS (statue i takes row
    i % 6), its floor a saturated orange, and its area light a blackbody
    of `temperature` K. Writes spectral_museum.pbrt beside museum.pbrt and
    returns its path; render it with `Renderer(..., spectral=True)` or the
    CLI's --spectral."""
    import os

    mats = SPECTRAL_MUSEUM_MATERIALS

    text = _split_statues(
        out_dir, len(mats),
        lambda k, name, P, faces: [
            mats[k], f'Shape "plymesh" "string filename" ["{name}"]'],
        **size)
    old_light, old_floor = ('"rgb L" [14 13 11]',
                            'Material "matte" "rgb Kd" [0.55 0.52 0.48]')
    if old_light not in text or old_floor not in text:
        raise ValueError("the museum's scene file changed: cannot dress it")
    text = text.replace(old_light, f'"blackbody L" [{temperature:g} 16]')
    text = text.replace(old_floor, 'Material "matte" "rgb Kd" [0.8 0.3 0.02]')
    dst = os.path.join(out_dir, "spectral_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


def plume_density(res: int, seed: int = 7) -> np.ndarray:
    """(res, res, res) float32 density of a smoke plume in the unit cube,
    made with numpy from `seed`: a column rising along z that widens and
    thins with height, modulated by trilinearly upsampled value noise."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    width = 0.12 + 0.22 * z
    r2 = (x - 0.5 - 0.08 * np.sin(5.0 * z)) ** 2 + (y - 0.5) ** 2
    column = np.exp(-r2 / (2.0 * width ** 2)) * (1.0 - 0.6 * z)
    lattice = rng.random((9, 9, 9))
    g = c * 8.0
    i0 = np.minimum(g.astype(int), 7)
    f = g - i0
    noise = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (np.where(dz, f, 1 - f)[:, None, None]
                     * np.where(dy, f, 1 - f)[None, :, None]
                     * np.where(dx, f, 1 - f)[None, None, :])
                noise = noise + w * lattice[np.ix_(i0 + dz, i0 + dy, i0 + dx)]
    return (column * (0.4 + 1.2 * noise)).astype(np.float32)


def _box_mesh(lo, hi) -> str:
    """A closed box's trianglemesh lines, faces wound outward."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    p = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    idx = (0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7, 0, 1, 5, 0, 5, 4,
           1, 2, 6, 1, 6, 5, 2, 3, 7, 2, 7, 6, 3, 0, 4, 3, 4, 7)
    p_str = " ".join(f"{v:g}" for q in p for v in q)
    return (f'Shape "trianglemesh" "point P" [{p_str}] "integer indices" '
            f'[{" ".join(map(str, idx))}]')


FOG_ROOM = ('MakeNamedMedium "room" "string type" "homogeneous" '
            '"rgb sigma_a" [0.004 0.005 0.007] '
            '"rgb sigma_s" [0.018 0.02 0.024] "float g" [0.2]')
FOG_TINT = ('MakeNamedMedium "tint" "string type" "homogeneous" '
            '"rgb sigma_a" [0.5 0.15 0.04] "rgb sigma_s" [0.08 0.08 0.08] '
            '"float g" [0.0]')


def fog_museum(out_dir: str, grid_res: int = 128, seed: int = 7,
               **size) -> str:
    """tools/genscene.py's museum (`size`: grid, seg, rings) under the
    volpath integrator with three media: a homogeneous fog ("room") that
    the camera and the room sit in; a grid medium ("plume") of
    grid_res^3 float32 density made from `seed` (`plume_density`) inside a
    null-material box in front of the statues, whose MediumInterface is a
    transition (plume inside, room outside); and a homogeneous coloured
    medium ("tint") inside statue 0, which is glass. Writes fog_museum.pbrt
    beside museum.pbrt and returns its path."""
    import os

    grid = size.get("grid", 8)
    pitch = 3.0

    def lines_for(k, name, P, faces):
        shape = f'Shape "plymesh" "string filename" ["{name}"]'
        if k:
            return [_MUSEUM_STATUE, shape]
        # statue 0 in glass around the tint medium: inside is the side its
        # raw normals point away from (medium.h), so check the winding
        tri = P[faces.reshape(-1, 3)]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        out = float(np.sum(n * (tri.mean(1) - P[faces].reshape(-1, 3)
                                .mean(0)))) > 0.0
        iface = '"tint" "room"' if out else '"room" "tint"'
        return ["AttributeBegin", f"MediumInterface {iface}",
                'Material "glass" "float index" [1.5]', shape, "AttributeEnd"]
    text = _split_statues(out_dir, 2, lines_for, **size)
    half = grid * pitch / 2
    lo = (-0.25 * half - 0.4, -half - 2.6, 0.01)
    hi = (0.25 * half + 0.4, -half - 0.4, 0.3 * half + 2.5)
    dens = plume_density(grid_res, seed)
    d_str = " ".join(f"{v:.4g}" for v in dens.reshape(-1))
    plume = (
        'MakeNamedMedium "plume" "string type" "heterogeneous" '
        '"rgb sigma_a" [0.15 0.15 0.15] "rgb sigma_s" [1.2 1.2 1.2] '
        '"float g" [0.4] '
        f'"integer nx" [{grid_res}] "integer ny" [{grid_res}] '
        f'"integer nz" [{grid_res}] "point p0" [{lo[0]:g} {lo[1]:g} {lo[2]:g}] '
        f'"point p1" [{hi[0]:g} {hi[1]:g} {hi[2]:g}] "float density" [{d_str}]')
    world = "\n".join([
        "WorldBegin", 'MediumInterface "room" "room"', plume, FOG_TINT,
        "AttributeBegin", 'MediumInterface "plume" "room"', 'Material "none"',
        _box_mesh(lo, hi), "AttributeEnd"])
    if "WorldBegin" not in text or 'Integrator "path"' not in text:
        raise ValueError("the museum's scene file changed: cannot fog it")
    text = text.replace("WorldBegin", world, 1)
    text = text.replace('Integrator "path"', 'Integrator "volpath"')
    text = text.replace('Camera "perspective"', FOG_ROOM
                        + '\nMediumInterface "" "room"\nCamera "perspective"')
    dst = os.path.join(out_dir, "fog_museum.pbrt")
    with open(dst, "w") as f:
        f.write(text)
    return dst


_MUSEUM_STATUE = ('Material "plastic" "rgb Kd" [0.32 0.30 0.34] '
                  '"rgb Ks" [0.35 0.35 0.35] "float roughness" [0.08]')
