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
