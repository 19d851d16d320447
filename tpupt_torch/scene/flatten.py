"""SceneDescription -> FlatScene: flat SoA tensors for the device.

Features this package does not render yet (media) raise NotImplementedError
here, naming the ROADMAP.md item that will bring them; nothing is silently
dropped.

This is the flat-table replacement for the reference's pointer-graph scene
(GeometricPrimitive / TransformedPrimitive, core/primitive.h): instancing is
baked out by instantiation, every shape becomes rows in a triangle or sphere
table, materials/lights become parameter tables indexed by int32 ids, and all
geometry is pre-transformed to world space (so the hot intersection kernels
never chase transforms; sphere rows keep their o2w/w2o for analytic hits).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpupt_torch.core.transforms import Transform
from tpupt_torch.scene.api import MaterialSpec, SceneDescription, ShapeRecord
from tpupt_torch.scene import quadrics, subdiv
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.scene.plyio import read_ply
from tpupt_torch.textures.textures import TextureTable, load_image
from tpupt_torch.utils import logging as tlog

# --- enums (device-side type ids) ---

(MAT_MATTE, MAT_PLASTIC, MAT_MIRROR, MAT_GLASS, MAT_METAL, MAT_UBER,
 MAT_SUBSTRATE, MAT_TRANSLUCENT, MAT_NONE, MAT_DISNEY, MAT_HAIR,
 MAT_MIX, MAT_SUBSURFACE, MAT_KDSUBSURFACE, MAT_FOURIER) = range(15)

def _burley_d(rho, mfp):
    """Diffusion radius d from albedo + mean free path (Christensen-Burley
    2015 eq. 8: s = 1.85 - rho + 7|rho - 0.8|^3; pbrt's BSSRDF table plays
    this role for the reference, core/bssrdf.cpp ComputeBeamDiffusionBSSRDF)."""
    rho = np.clip(np.asarray(rho, np.float64), 1e-4, 1.0)
    s = 1.85 - rho + 7.0 * np.abs(rho - 0.8) ** 3
    return np.maximum(np.asarray(mfp, np.float64), 1e-6) / s


_MATERIAL_IDS = {
    "matte": MAT_MATTE, "plastic": MAT_PLASTIC, "mirror": MAT_MIRROR,
    "glass": MAT_GLASS, "metal": MAT_METAL, "uber": MAT_UBER,
    "substrate": MAT_SUBSTRATE, "translucent": MAT_TRANSLUCENT,
    "none": MAT_NONE, "": MAT_NONE, "disney": MAT_DISNEY,
    "hair": MAT_HAIR, "mix": MAT_MIX, "subsurface": MAT_SUBSURFACE,
    "kdsubsurface": MAT_KDSUBSURFACE, "fourier": MAT_FOURIER,
}


(LIGHT_POINT, LIGHT_DISTANT, LIGHT_AREA, LIGHT_INFINITE, LIGHT_SPOT,
 LIGHT_GONIO, LIGHT_PROJECTION) = range(7)

CAM_PERSPECTIVE, CAM_ORTHOGRAPHIC, CAM_ENVIRONMENT, CAM_REALISTIC = range(4)

FILTER_BOX, FILTER_TRIANGLE, FILTER_GAUSSIAN, FILTER_MITCHELL, FILTER_SINC = range(5)
_FILTER_IDS = {"box": FILTER_BOX, "triangle": FILTER_TRIANGLE,
               "gaussian": FILTER_GAUSSIAN, "mitchell": FILTER_MITCHELL,
               "sinc": FILTER_SINC}
_FILTER_DEFAULT_RADIUS = {"box": 0.5, "triangle": 2.0, "gaussian": 2.0,
                          "mitchell": 2.0, "sinc": 4.0}

# Approximate RGB eta/k for copper, the reference metal default
# (materials/metal.cpp uses tabulated Cu spectra).
_CU_ETA = np.array([0.200, 0.924, 1.102])
_CU_K = np.array([3.912, 2.448, 2.138])


@dataclass
class Triangles:
    """World-space triangle SoA (cf. TriangleMesh, shapes/triangle.h)."""

    p0: np.ndarray  # (T,3) f32
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray  # shading normals, (T,3) f32
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (T,2) f32
    uv1: np.ndarray
    uv2: np.ndarray
    mat: np.ndarray  # (T,) i32
    light: np.ndarray  # (T,) i32, -1 if not emissive
    # MediumInterface (medium.h): media ids into FlatScene.media_order,
    # -1 = vacuum. inside = the side OPPOSITE the geometric normal.
    med_in: np.ndarray = None   # (T,) i32
    med_out: np.ndarray = None  # (T,) i32
    # Per-vertex motion deltas over the shutter: p(t) = p + t * dp with
    # t in [0,1] normalized shutter time. Wavefront substitution for the
    # reference's per-ray AnimatedTransform interpolation
    # (transform.cpp:1144 + TransformedPrimitive::Intersect): geometry is
    # baked at shutter open AND close and vertex-lerped per ray — the
    # standard motion-BVH representation of GPU ray tracers, exact for
    # translations, chordal (2nd-order) for rotations between the 2 keys.
    dp0: np.ndarray = None  # (T,3) f32, None = static scene
    dp1: np.ndarray = None
    dp2: np.ndarray = None
    # per-triangle ptex faceIndex ("integer faceIndices" on trianglemesh;
    # triangle.cpp:344 threads it into SurfaceInteraction.faceIndex)
    face: np.ndarray = None  # (T,) i32

    @property
    def count(self) -> int:
        return len(self.p0)

    @property
    def has_motion(self) -> bool:
        return self.dp0 is not None and bool(np.any(self.dp0) or
                                             np.any(self.dp1) or
                                             np.any(self.dp2))


@dataclass
class Spheres:
    """Analytic quadrics with their transforms (cf. shapes/{sphere,cylinder,
    disk,cone,paraboloid,hyperboloid}.cpp). Historically named Spheres; each
    row's `kind` selects the implicit surface (shapes/quadric.py), with
    kind-specific scalars in q1/q2."""

    o2w: np.ndarray  # (S,4,4) f32
    w2o: np.ndarray  # (S,4,4) f32
    radius: np.ndarray  # (S,) f32
    zmin: np.ndarray
    zmax: np.ndarray
    phimax: np.ndarray  # radians
    mat: np.ndarray  # (S,) i32
    light: np.ndarray  # (S,) i32
    reverse: np.ndarray  # (S,) bool (reverse orientation ^ swaps handedness)
    med_in: np.ndarray = None   # (S,) i32, -1 = vacuum
    med_out: np.ndarray = None  # (S,) i32
    kind: np.ndarray = None     # (S,) i32 quadric kind (0 = sphere)
    q1: np.ndarray = None       # (S,) f32 kind-specific scalar
    q2: np.ndarray = None

    @property
    def count(self) -> int:
        return len(self.radius)


@dataclass
class Materials:
    """Material parameter table (registry api.cpp:557-627)."""

    type: np.ndarray  # (M,) i32
    kd: np.ndarray  # (M,3)
    ks: np.ndarray  # (M,3)
    kr: np.ndarray  # (M,3)
    kt: np.ndarray  # (M,3)
    roughness: np.ndarray  # (M,)
    urough: np.ndarray
    vrough: np.ndarray
    eta: np.ndarray  # (M,3) index of refraction (scalar broadcast for glass)
    k: np.ndarray  # (M,3) absorption for conductors
    sigma: np.ndarray  # (M,) oren-nayar sigma degrees
    remap_roughness: np.ndarray  # (M,) bool
    kd_tex: np.ndarray  # (M,) i32 texture id, -1 = constant kd
    ks_tex: np.ndarray
    extra: np.ndarray  # (M,12) material-specific scalars:
    #   disney: metallic, sheen, sheenTint, specTint, clearcoat,
    #           clearcoatGloss, anisotropic, specTrans, thin, diffTrans,
    #           flatness               (disney.cpp params, full set)
    #   hair:   beta_m, beta_n, alpha_deg    (hair.cpp params)
    #   mix:    amount_luminance, child1 id, child2 id (mixmat.cpp)
    #   uber:   opacity_luminance (slot 7; uber.cpp opacity pass-through)

    @property
    def count(self) -> int:
        return len(self.type)


@dataclass
class Lights:
    """Light parameter table (registry api.cpp:749-788)."""

    type: np.ndarray  # (L,) i32
    L: np.ndarray  # (L,3) radiance (area/infinite) or intensity (point/spot)
    pos: np.ndarray  # (L,3) position (point/spot) or "from" (distant)
    dir: np.ndarray  # (L,3) unit direction (distant/spot axis)
    prim: np.ndarray  # (L,) i32 global prim id for area lights, -1 otherwise
    nsamples: np.ndarray  # (L,) i32
    twosided: np.ndarray  # (L,) bool
    cos_total: np.ndarray  # (L,) spot total cosine / projection fov cosine
    cos_falloff: np.ndarray  # (L,) spot falloff-start cosine
    w2l: np.ndarray = None  # (L,3,3) world->light rotation (gonio/projection)
    img_off: np.ndarray = None  # (L,) i32 offset into img atlas, -1 = none
    img_w: np.ndarray = None  # (L,) i32
    img_h: np.ndarray = None  # (L,) i32
    img: np.ndarray = None  # (sum(w*h), 3) angular/projection map atlas

    def __post_init__(self):
        n = len(self.type)
        if self.w2l is None:
            self.w2l = np.broadcast_to(np.eye(3, dtype=np.float32),
                                       (n, 3, 3)).copy()
        if self.img_off is None:
            self.img_off = np.full(n, -1, np.int32)
        if self.img_w is None:
            self.img_w = np.zeros(n, np.int32)
        if self.img_h is None:
            self.img_h = np.zeros(n, np.int32)
        if self.img is None:
            self.img = np.zeros((1, 3), np.float32)

    @property
    def count(self) -> int:
        return len(self.type)


@dataclass
class CameraConfig:
    type: int
    cam_to_world: np.ndarray  # (4,4) f32
    raster_to_camera: np.ndarray  # (4,4) f32
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    fov: float
    lens_data: np.ndarray = None  # (E,4) lens stack (realistic camera)
    lens_z: np.ndarray = None     # (E,) interface vertex z positions
    film_diag: float = 0.035      # physical film diagonal in meters
    # shutter-close camera-to-world for animated cameras (per-ray slerp in
    # raygen, AnimatedTransform::InterpolateRay parity); None = static
    cam_to_world_end: np.ndarray = None


@dataclass
class FilmConfig:
    xres: int
    yres: int
    crop: Tuple[float, float, float, float]
    filename: str
    filter_type: int
    filter_radius: Tuple[float, float]
    filter_params: Tuple[float, ...]  # gaussian alpha / mitchell B,C / sinc tau
    scale: float
    max_sample_luminance: float
    diagonal: float


@dataclass
class SamplerConfig:
    name: str
    spp: int
    seed: int = 0
    jitter: bool = True
    xsamples: int = 4
    ysamples: int = 4


@dataclass
class IntegratorConfig:
    name: str
    max_depth: int
    rr_threshold: float = 1.0
    light_strategy: str = "spatial"
    # direct-lighting strategy / AO params
    strategy: str = "all"
    cos_sample: bool = True
    n_ao_samples: int = 64


@dataclass
class FlatScene:
    triangles: Triangles
    spheres: Spheres
    materials: Materials
    lights: Lights
    camera: CameraConfig
    film: FilmConfig
    sampler: SamplerConfig
    integrator: IntegratorConfig
    accelerator_name: str = "bvh"
    accelerator_params: Optional[ParamSet] = None
    textures: Optional[dict] = None       # flat texture tables (numpy)
    media: Optional[dict] = None          # named MediumRecords (host objects)
    env_map: Optional[np.ndarray] = None  # (H, W, 3) equirect radiance
    fourier_table: Optional[dict] = None  # shared .bsdf table (fourier.py)
    env_light_id: int = -1                # light row using the env map
    env_w2l: Optional[np.ndarray] = None  # (3,3) world-to-light rotation
    media_order: Optional[list] = None    # medium-id -> name (prim med_in/out)
    camera_medium: int = -1               # medium the camera rays start in

    @property
    def prim_count(self) -> int:
        """Global prim ids: [0, T) triangles, [T, T+S) spheres."""
        return self.triangles.count + self.spheres.count

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        los, his = [], []
        if self.triangles.count:
            t = self.triangles
            p = np.concatenate([t.p0, t.p1, t.p2])
            if t.has_motion:  # union over the shutter (BoundPointMotion)
                p = np.concatenate(
                    [p, t.p0 + t.dp0, t.p1 + t.dp1, t.p2 + t.dp2])
            los.append(p.min(0))
            his.append(p.max(0))
        if self.spheres.count:
            lo, hi = _sphere_world_bounds(self.spheres)
            los.append(lo.min(0))
            his.append(hi.max(0))
        if not los:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        return np.min(los, 0).astype(np.float32), np.max(his, 0).astype(np.float32)


def _sphere_world_bounds(s: Spheres):
    """Transformed AABB of each quadric's object bounds (Shape::ObjectBound
    through o2w, as each reference shape's WorldBound does)."""
    from tpupt_torch.shapes.quadric import quadric_object_bounds

    kind = s.kind if s.kind is not None else np.zeros(s.count, np.int32)
    lo, hi = quadric_object_bounds(kind, s.radius, s.zmin, s.zmax, s.q1, s.q2)
    corners = np.stack([np.where(np.array(m)[None, :] > 0, hi, lo)
                        for m in np.ndindex(2, 2, 2)], 1)  # (S,8,3)
    m = s.o2w.astype(np.float64)
    world = np.einsum("sij,spj->spi", m[:, :3, :3], corners) \
        + m[:, None, :3, 3]
    return world.min(1), world.max(1)


# ---------------------------------------------------------------------------


def _resolve_spectrum(params: ParamSet, name: str, default,
                      textures: Dict, warn_ctx: str) -> np.ndarray:
    """Constant value for a spectrum param; a non-constant texture gives a
    representative value here and is evaluated per hit through the row's
    kd_tex / ks_tex id (see _MaterialTable)."""
    tex = params.find_texture(name)
    if tex is None:
        return params.find_one_spectrum(name, default)
    td = textures.get(tex)
    if td is None:
        warnings.warn(f"{warn_ctx}: unknown texture {tex!r}")
        return np.asarray(default, np.float64)
    if td.klass == "constant":
        return td.params.find_one_spectrum("value", [1, 1, 1])
    if td.klass == "scale":
        base = td.params.find_one_spectrum("tex1", [1, 1, 1])
        s = td.params.find_one_spectrum("tex2", [1, 1, 1])
        return base * s
    if td.klass == "checkerboard":
        t1 = td.params.find_one_spectrum("tex1", [1, 1, 1])
        t2 = td.params.find_one_spectrum("tex2", [0, 0, 0])
        return 0.5 * (np.asarray(t1) + np.asarray(t2))
    return np.asarray(default, np.float64)


def _resolve_float(params: ParamSet, name: str, default: float,
                   textures: Dict, warn_ctx: str) -> float:
    tex = params.find_texture(name)
    if tex is None:
        return params.find_one_float(name, default)
    td = textures.get(tex)
    if td is not None and td.klass == "constant":
        return td.params.find_one_float("value", default)
    warnings.warn(f"{warn_ctx}: float texture {tex!r} -> default {default}")
    return default


class _MaterialTable:
    """Deduplicating material table. Non-constant Kd / Ks textures are
    registered in the scene's TextureTable and referenced by row id for
    per-hit evaluation (textures/textures.py); constant ones are folded
    into the row."""

    def __init__(self, textures: Dict, tex_table=None, named_materials=None):
        self.textures = textures
        self.tex_table = tex_table
        self.named_materials = named_materials
        self.rows: List[dict] = []
        self.cache: Dict = {}

    def _tex_id(self, params: ParamSet, name: str) -> int:
        if self.tex_table is None:
            return -1
        ref = params.find_texture(name)
        if ref is None or ref not in self.textures:
            return -1
        if self.textures[ref].klass == "constant":
            return -1  # folded to the constant value
        return self.tex_table.name_to_id.get(ref, -1)

    def add(self, spec: MaterialSpec) -> int:
        key = id(spec)
        if key in self.cache:
            return self.cache[key]
        mid = len(self.rows)
        self.rows.append(None)  # reserve the slot: mix recurses into add()
        self.cache[key] = mid
        self.rows[mid] = self._make_row(spec)
        return mid

    def _make_row(self, spec: MaterialSpec) -> dict:
        p = spec.params
        t = _MATERIAL_IDS.get(spec.type)
        if t is None:
            warnings.warn(f"material {spec.type!r} not yet supported; using matte")
            t = MAT_MATTE
        ctx = f"material {spec.type!r}"
        row = dict(
            type=t,
            kd=np.asarray([0.5, 0.5, 0.5], np.float64),
            ks=np.zeros(3), kr=np.zeros(3), kt=np.zeros(3),
            roughness=0.0, urough=-1.0, vrough=-1.0,
            eta=np.full(3, 1.5), k=np.zeros(3), sigma=0.0,
            remap=True, kd_tex=-1, ks_tex=-1, extra=np.zeros(12),
        )
        row["kd_tex"] = self._tex_id(p, "Kd")
        row["ks_tex"] = self._tex_id(p, "Ks")
        if t == MAT_MATTE:
            row["kd"] = _resolve_spectrum(p, "Kd", [0.5] * 3, self.textures, ctx)
            row["sigma"] = _resolve_float(p, "sigma", 0.0, self.textures, ctx)
        elif t == MAT_PLASTIC:
            row["kd"] = _resolve_spectrum(p, "Kd", [0.25] * 3, self.textures, ctx)
            row["ks"] = _resolve_spectrum(p, "Ks", [0.25] * 3, self.textures, ctx)
            row["roughness"] = _resolve_float(p, "roughness", 0.1, self.textures, ctx)
            row["remap"] = p.find_one_bool("remaproughness", True)
        elif t == MAT_MIRROR:
            row["kr"] = _resolve_spectrum(p, "Kr", [0.9] * 3, self.textures, ctx)
        elif t == MAT_GLASS:
            row["kr"] = _resolve_spectrum(p, "Kr", [1.0] * 3, self.textures, ctx)
            row["kt"] = _resolve_spectrum(p, "Kt", [1.0] * 3, self.textures, ctx)
            row["eta"] = np.full(3, _resolve_float(p, "eta", p.find_one_float("index", 1.5), self.textures, ctx))
            row["roughness"] = _resolve_float(p, "uroughness", 0.0, self.textures, ctx)
            row["remap"] = p.find_one_bool("remaproughness", True)
        elif t == MAT_METAL:
            row["eta"] = _resolve_spectrum(p, "eta", _CU_ETA, self.textures, ctx)
            row["k"] = _resolve_spectrum(p, "k", _CU_K, self.textures, ctx)
            row["roughness"] = _resolve_float(p, "roughness", 0.01, self.textures, ctx)
            row["urough"] = _resolve_float(p, "uroughness", -1.0, self.textures, ctx)
            row["vrough"] = _resolve_float(p, "vroughness", -1.0, self.textures, ctx)
            row["remap"] = p.find_one_bool("remaproughness", True)
        elif t == MAT_UBER:
            row["kd"] = _resolve_spectrum(p, "Kd", [0.25] * 3, self.textures, ctx)
            row["ks"] = _resolve_spectrum(p, "Ks", [0.25] * 3, self.textures, ctx)
            row["kr"] = _resolve_spectrum(p, "Kr", [0.0] * 3, self.textures, ctx)
            row["kt"] = _resolve_spectrum(p, "Kt", [0.0] * 3, self.textures, ctx)
            row["roughness"] = _resolve_float(p, "roughness", 0.1, self.textures, ctx)
            row["eta"] = np.full(3, _resolve_float(p, "eta", 1.5, self.textures, ctx))
            row["remap"] = p.find_one_bool("remaproughness", True)
            # opacity < 1 adds the (1-op) pass-through delta lobe
            # (uber.cpp:60 SpecularTransmission(1-op, 1, 1))
            op = _resolve_spectrum(p, "opacity", [1.0] * 3, self.textures, ctx)
            row["extra"][7] = float(np.clip(np.mean(op), 0.0, 1.0))
        elif t == MAT_SUBSTRATE:
            row["kd"] = _resolve_spectrum(p, "Kd", [0.5] * 3, self.textures, ctx)
            row["ks"] = _resolve_spectrum(p, "Ks", [0.5] * 3, self.textures, ctx)
            row["urough"] = _resolve_float(p, "uroughness", 0.1, self.textures, ctx)
            row["vrough"] = _resolve_float(p, "vroughness", 0.1, self.textures, ctx)
            row["remap"] = p.find_one_bool("remaproughness", True)
        elif t == MAT_TRANSLUCENT:
            row["kd"] = _resolve_spectrum(p, "Kd", [0.25] * 3, self.textures, ctx)
            row["ks"] = _resolve_spectrum(p, "Ks", [0.25] * 3, self.textures, ctx)
            row["kr"] = _resolve_spectrum(p, "reflect", [0.5] * 3, self.textures, ctx)
            row["kt"] = _resolve_spectrum(p, "transmit", [0.5] * 3, self.textures, ctx)
            row["roughness"] = _resolve_float(p, "roughness", 0.1, self.textures, ctx)
        elif t == MAT_DISNEY:
            self._disney_row(p, row, ctx)
        elif t == MAT_HAIR:
            self._hair_row(p, row, ctx)
        elif t in (MAT_SUBSURFACE, MAT_KDSUBSURFACE):
            self._subsurface_row(p, row, t, ctx)
        elif t == MAT_FOURIER:
            # materials/fourier.cpp: tabulated BSDF from a .bsdf file; the
            # table itself is attached scene-wide at flatten() (one table a
            # scene)
            row["fourier_file"] = p.find_one_string("bsdffile", "")
        elif t == MAT_MIX:
            self._mix_row(p, row, ctx)
        p.report_unused(ctx)
        return row

    def _disney_row(self, p, row, ctx):
        """disney.cpp CreateDisneyMaterial's parameter set, the eleven
        scalars in extra[0:11]; the roughness is used as given."""
        row["kd"] = _resolve_spectrum(p, "color", [0.5] * 3, self.textures, ctx)
        row["roughness"] = _resolve_float(p, "roughness", 0.5, self.textures, ctx)
        row["eta"] = np.full(3, _resolve_float(p, "eta", 1.5, self.textures, ctx))
        row["remap"] = False
        for i, (name, default) in enumerate((
                ("metallic", 0.0), ("sheen", 0.0), ("sheentint", 0.5),
                ("speculartint", 0.0), ("clearcoat", 0.0),
                ("clearcoatgloss", 1.0), ("anisotropic", 0.0),
                ("spectrans", 0.0))):
            row["extra"][i] = _resolve_float(p, name, default, self.textures,
                                             ctx)
        row["extra"][8] = float(p.find_one_bool("thin", False))
        row["extra"][9] = _resolve_float(p, "difftrans", 1.0, self.textures, ctx)
        row["extra"][10] = _resolve_float(p, "flatness", 0.0, self.textures, ctx)

    def _hair_row(self, p, row, ctx):
        """hair.cpp CreateHairMaterial: sigma_a from sigma_a, else color,
        else the melanin concentrations; beta_m / beta_n roughness and the
        alpha tilt in extra[0:3]."""
        sig = p.find_one_spectrum("sigma_a", [-1.0] * 3)
        if sig[0] < 0:
            col = p.find_one_spectrum("color", [-1.0] * 3)
            if col[0] >= 0:
                # HairBSDF::SigmaAFromReflectance (hair.cpp:61)
                bn = _resolve_float(p, "beta_n", 0.3, self.textures, ctx)
                c = np.asarray(col, np.float64)
                denom = (5.969 - 0.215 * bn + 2.532 * bn**2
                         - 10.73 * bn**3 + 5.574 * bn**4 + 0.245 * bn**5)
                sig = (np.log(np.maximum(c, 1e-4)) / denom) ** 2
            else:
                eu = p.find_one_float("eumelanin", 1.3)
                ph = p.find_one_float("pheomelanin", 0.0)
                # SigmaAFromConcentration (hair.cpp:52)
                sig = (eu * np.array([0.419, 0.697, 1.37])
                       + ph * np.array([0.187, 0.4, 1.05]))
        row["kd"] = np.asarray(sig, np.float64)
        row["eta"] = np.full(3, _resolve_float(p, "eta", 1.55, self.textures, ctx))
        row["extra"][0] = _resolve_float(p, "beta_m", 0.3, self.textures, ctx)
        row["extra"][1] = _resolve_float(p, "beta_n", 0.3, self.textures, ctx)
        row["extra"][2] = _resolve_float(p, "alpha", 2.0, self.textures, ctx)

    def _subsurface_row(self, p, row, t, ctx):
        """materials/subsurface.cpp and kdsubsurface.cpp: the diffuse
        reflectance rho in kd, the Burley radius d in extra[0:3], sigma_t in
        extra[3:6] and the single-scatter albedo in extra[6:9]; the surface
        interface keeps eta and roughness."""
        from tpupt_torch.materials.bssrdf_table import (
            compute_beam_diffusion_table, subsurface_from_diffuse)

        row["eta"] = np.full(3, _resolve_float(
            p, "eta", 1.33 if t == MAT_SUBSURFACE else 1.3, self.textures,
            ctx))
        row["roughness"] = _resolve_float(p, "uroughness", 0.0,
                                          self.textures, ctx)
        row["remap"] = p.find_one_bool("remaproughness", True)
        scale = p.find_one_float("scale", 1.0)
        tab = compute_beam_diffusion_table(float(row["eta"][0]))
        if t == MAT_SUBSURFACE:
            sig_a = np.asarray(_resolve_spectrum(
                p, "sigma_a", [0.0011, 0.0024, 0.014], self.textures,
                ctx)) * scale
            sig_s = np.asarray(_resolve_spectrum(
                p, "sigma_prime_s", [2.55, 3.21, 3.77], self.textures,
                ctx)) * scale
            sig_t = np.maximum(sig_a + sig_s, 1e-6)
            mfp = 1.0 / sig_t
        else:
            # kdsubsurface.cpp: invert the tabulated rho -> rho_eff curve
            # (SubsurfaceFromDiffuse, bssrdf.cpp:700)
            kd_t = np.clip(np.asarray(_resolve_spectrum(
                p, "Kd", [0.5] * 3, self.textures, ctx)), 0.0, 0.995)
            mfp = np.full(3, p.find_one_float("mfp", 1.0))
            sig_a, sig_s = subsurface_from_diffuse(tab, kd_t, mfp)
            sig_t = np.maximum(sig_a + sig_s, 1e-6)
        alpha = sig_s / sig_t
        # diffuse reflectance = the table's effective albedo at the
        # single-scatter albedo (ComputeBeamDiffusionBSSRDF rhoEff)
        rho = np.clip(np.interp(alpha, tab.rho, tab.rho_eff), 0.0, 0.995)
        row["kd"] = rho
        row["extra"][0:3] = _burley_d(rho, mfp)  # Burley fallback
        row["extra"][3:6] = sig_t                # tabulated profile
        row["extra"][6:9] = np.clip(alpha, 0.0, float(tab.rho[-1]))

    def _mix_row(self, p, row, ctx):
        """mixmat.cpp: two named materials, scaled by amount / (1 - amount):
        the amount in kd, its luminance in extra[0], the two child rows in
        extra[1:3] (an unknown name becomes a matte row, with a warning)."""
        amt = np.asarray(_resolve_spectrum(p, "amount", [0.5] * 3,
                                           self.textures, ctx))
        children = []
        for key in ("namedmaterial1", "namedmaterial2"):
            name = p.find_one_string(key, "")
            cid = 0
            if self.named_materials is not None:
                spec = self.named_materials.get(name)
                if spec is None:
                    warnings.warn(f"mix material: unknown {name!r}; using matte")
                    spec = MaterialSpec("matte", ParamSet())
                cid = self.add(spec)
            children.append(cid)
        lum = float(0.2126 * amt[0] + 0.7152 * amt[1] + 0.0722 * amt[2])
        row["kd"] = amt
        row["extra"][0] = min(max(lum, 0.0), 1.0)
        row["extra"][1:3] = children

    def finalize(self) -> Materials:
        if not self.rows:
            self.rows.append(self._make_row(MaterialSpec("matte", ParamSet())))
        g = lambda k: np.asarray([r[k] for r in self.rows])
        return Materials(
            type=g("type").astype(np.int32),
            kd=g("kd").astype(np.float32), ks=g("ks").astype(np.float32),
            kr=g("kr").astype(np.float32), kt=g("kt").astype(np.float32),
            roughness=g("roughness").astype(np.float32),
            urough=g("urough").astype(np.float32),
            vrough=g("vrough").astype(np.float32),
            eta=g("eta").astype(np.float32), k=g("k").astype(np.float32),
            sigma=g("sigma").astype(np.float32),
            remap_roughness=g("remap").astype(bool),
            kd_tex=g("kd_tex").astype(np.int32),
            ks_tex=g("ks_tex").astype(np.int32),
            extra=g("extra").astype(np.float32),
        )


_QUADRIC_TYPES = ("sphere", "cylinder", "disk", "cone", "paraboloid",
                  "hyperboloid")


def _quadric_row(rec: ShapeRecord):
    """Analytic-quadric row for the unified table (shapes/quadric.py), or
    None to fall through to tessellation. Non-sphere quadrics with area
    lights or animated transforms tessellate instead (the emissive-shape
    sampler and motion deltas are triangle-based)."""
    if rec.type not in _QUADRIC_TYPES:
        return None
    if rec.type != "sphere" and (rec.area_light is not None
                                 or rec.object_to_world_end is not None):
        return None
    from tpupt_torch.shapes import quadric as qd

    p = rec.params
    phimax = np.deg2rad(np.clip(p.find_one_float("phimax", 360.0),
                                1e-3, 360.0))
    if rec.type == "sphere":
        r = p.find_one_float("radius", 1.0)
        return dict(kind=qd.KIND_SPHERE, radius=r,
                    zmin=max(p.find_one_float("zmin", -r), -r),
                    zmax=min(p.find_one_float("zmax", r), r),
                    phimax=phimax, q1=0.0, q2=0.0)
    if rec.type == "cylinder":
        return dict(kind=qd.KIND_CYLINDER,
                    radius=p.find_one_float("radius", 1.0),
                    zmin=p.find_one_float("zmin", -1.0),
                    zmax=p.find_one_float("zmax", 1.0),
                    phimax=phimax, q1=0.0, q2=0.0)
    if rec.type == "disk":
        h = p.find_one_float("height", 0.0)
        return dict(kind=qd.KIND_DISK,
                    radius=p.find_one_float("radius", 1.0),
                    zmin=h, zmax=h, phimax=phimax,
                    q1=p.find_one_float("innerradius", 0.0), q2=0.0)
    if rec.type == "cone":
        return dict(kind=qd.KIND_CONE,
                    radius=p.find_one_float("radius", 1.0),
                    zmin=0.0, zmax=p.find_one_float("height", 1.0),
                    phimax=phimax, q1=0.0, q2=0.0)
    if rec.type == "paraboloid":
        r = p.find_one_float("radius", 1.0)
        zmax_p = p.find_one_float("zmax", 1.0)
        return dict(kind=qd.KIND_PARABOLOID, radius=r,
                    zmin=p.find_one_float("zmin", 0.0), zmax=zmax_p,
                    phimax=phimax, q1=zmax_p / max(r * r, 1e-12), q2=0.0)
    # hyperboloid: solve a (x^2+y^2) - c z^2 = 1 through p1 and p2
    # (hyperboloid.cpp:42-78 does this iteratively; the 2x2 linear solve is
    # exact). Degenerate configurations tessellate instead.
    p1 = np.asarray(p.find_one_point("p1", [0, 0, 0]), np.float64)
    p2 = np.asarray(p.find_one_point("p2", [1, 1, 1]), np.float64)
    s1, s2 = p1[0] ** 2 + p1[1] ** 2, p2[0] ** 2 + p2[1] ** 2
    z1, z2 = p1[2], p2[2]
    det = -s1 * z2 * z2 + s2 * z1 * z1
    if abs(det) < 1e-12:
        return None
    ah = (z1 * z1 - z2 * z2) / det
    ch = (s1 - s2) / det
    if not np.isfinite(ah) or not np.isfinite(ch) or ah <= 0:
        return None
    rmax = max(np.sqrt(s1), np.sqrt(s2))
    return dict(kind=qd.KIND_HYPERBOLOID, radius=float(rmax),
                zmin=float(min(z1, z2)), zmax=float(max(z1, z2)),
                phimax=phimax, q1=float(ah), q2=float(ch))


def _shape_to_mesh(rec: ShapeRecord, scene_dir: str):
    """Return (P, N, uv, F) in OBJECT space, or None for analytic spheres /
    unsupported shapes. Cites the Create* factories (api.cpp:446-553)."""
    p = rec.params
    if rec.type == "trianglemesh":
        P = p.find_points("P")
        F = p.find_ints("indices")
        if P is None or F is None:
            warnings.warn("trianglemesh without P/indices; skipped")
            return None
        N = p.find_points("N")
        uv = p.find_point2s("uv")
        if uv is None:
            uv = p.find_point2s("st")
        if uv is None:
            fl = p.find_floats("uv")
            fl = fl if fl is not None else p.find_floats("st")
            if fl is not None:
                uv = fl.reshape(-1, 2)
        fi = p.find_ints("faceIndices")
        return P, N, uv, F.reshape(-1, 3), fi
    if rec.type == "plymesh":
        fn = p.find_one_string("filename", "")
        path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
        if not os.path.isfile(path):
            alt = os.path.join(scene_dir, os.path.basename(fn))
            if os.path.isfile(alt):
                path = alt
            else:
                warnings.warn(f"plymesh {fn!r} not found; skipped")
                return None
        d = read_ply(path)
        return d["P"], d.get("N"), d.get("uv"), d["indices"]
    if rec.type == "loopsubdiv":
        P = p.find_points("P")
        F = p.find_ints("indices")
        if P is None or F is None:
            return None
        nlevels = p.find_one_int("nlevels", p.find_one_int("levels", 3))
        P2, F2, N2 = subdiv.loop_subdivide(P, F.reshape(-1, 3), nlevels)
        return P2, N2, None, F2
    if rec.type == "cylinder":
        return quadrics.tessellate_cylinder(
            p.find_one_float("radius", 1.0), p.find_one_float("zmin", -1.0),
            p.find_one_float("zmax", 1.0), p.find_one_float("phimax", 360.0))
    if rec.type == "disk":
        return quadrics.tessellate_disk(
            p.find_one_float("height", 0.0), p.find_one_float("radius", 1.0),
            p.find_one_float("innerradius", 0.0), p.find_one_float("phimax", 360.0))
    if rec.type == "cone":
        return quadrics.tessellate_cone(
            p.find_one_float("height", 1.0), p.find_one_float("radius", 1.0),
            p.find_one_float("phimax", 360.0))
    if rec.type == "paraboloid":
        return quadrics.tessellate_paraboloid(
            p.find_one_float("radius", 1.0), p.find_one_float("zmin", 0.0),
            p.find_one_float("zmax", 1.0), p.find_one_float("phimax", 360.0))
    if rec.type == "hyperboloid":
        return quadrics.tessellate_hyperboloid(
            p.find_one_point("p1", [0, 0, 0]), p.find_one_point("p2", [1, 1, 1]),
            p.find_one_float("phimax", 360.0))
    if rec.type == "heightfield":
        nx = p.find_one_int("nu", 0)
        ny = p.find_one_int("nv", 0)
        z = p.find_floats("Pz")
        if not nx or z is None:
            return None
        return quadrics.tessellate_heightfield(nx, ny, z)
    if rec.type == "curve":
        P = p.find_points("P")
        if P is None:
            return None
        w = p.find_one_float("width", 1.0)
        out = quadrics.tessellate_curve(
            P,
            p.find_one_float("width0", w), p.find_one_float("width1", w),
            curve_type=p.find_one_string("type", "flat"),
            basis=p.find_one_string("basis", "bezier"),
            degree=p.find_one_int("degree", 3),
            normals=p.find_points("N"))
        if out is None:
            warnings.warn("curve with too few control points; skipped")
        return out
    if rec.type == "nurbs":
        nu_ = p.find_one_int("nu", 0)
        nv_ = p.find_one_int("nv", 0)
        P = p.find_points("P")
        pw = p.find_floats("Pw")
        w = None
        if P is None and pw is not None:
            pw = np.asarray(pw, np.float64).reshape(-1, 4)
            w = pw[:, 3]
            P = pw[:, :3] * np.where(w[:, None] != 0, 1.0 / np.where(
                w[:, None] == 0, 1.0, w[:, None]), 1.0)
        if not nu_ or not nv_ or P is None:
            return None
        uknots = p.find_floats("uknots")
        vknots = p.find_floats("vknots")
        uo = p.find_one_int("uorder", 3)
        vo = p.find_one_int("vorder", 3)
        return quadrics.tessellate_nurbs(
            nu_, nv_, uo, vo, uknots, vknots,
            p.find_one_float("u0", float(uknots[uo - 1])),
            p.find_one_float("u1", float(uknots[nu_])),
            p.find_one_float("v0", float(vknots[vo - 1])),
            p.find_one_float("v1", float(vknots[nv_])),
            P, w)
    warnings.warn(f"shape {rec.type!r} not yet supported; skipped")
    return None


def flatten(desc: SceneDescription, scene_dir: str = ".") -> FlatScene:
    """Bake the parsed scene into flat world-space tensors, in a
    `scene.flatten` span."""
    with tlog.annotate("scene.flatten"):
        return _flatten(desc, scene_dir)


def _flatten(desc: SceneDescription, scene_dir: str) -> FlatScene:
    # 1. instantiate objects (TransformedPrimitive flattening)
    all_shapes: List[ShapeRecord] = list(desc.shapes)
    for inst in desc.instances:
        at = inst.instance_to_world
        i2w_open = at.interpolate(at.start_time)
        i2w_close = at.interpolate(at.end_time) if at.animated else None
        for rec in desc.objects.get(inst.name, []):
            all_shapes.append(
                ShapeRecord(rec.type, rec.params,
                            i2w_open * rec.object_to_world,
                            rec.material, rec.area_light, rec.reverse_orientation,
                            rec.medium_interface, rec.filename,
                            object_to_world_end=(
                                i2w_close * rec.object_to_world
                                if i2w_close is not None else None)))

    tex_table = TextureTable.build(desc.textures, scene_dir)
    mats = _MaterialTable(desc.textures, tex_table, desc.named_materials)
    tri_chunks: List[dict] = []
    sph_rows: List[dict] = []
    light_rows: List[dict] = []
    tri_count = 0

    # media: name -> id (MediumInterface per primitive, medium.h)
    media_order = list(desc.media.keys())

    def med_id(name: str) -> int:
        return media_order.index(name) if name in media_order else -1

    camera_medium = med_id(getattr(desc, "camera_medium", ""))
    any_interface = any(r.medium_interface.inside or r.medium_interface.outside
                        for r in all_shapes)
    if media_order and not any_interface and camera_medium < 0:
        # compat / common fog configuration: named media but no interfaces
        # anywhere -> the first medium is the global camera medium
        camera_medium = 0

    def add_area_lights_for_tris(n_tris: int, area_params, start_prim: int):
        name, lp = area_params
        L = lp.find_one_spectrum("L", [1, 1, 1]) * lp.find_one_float("scale", 1.0)
        two = lp.find_one_bool("twosided", False)
        ns = lp.find_one_int("samples", lp.find_one_int("nsamples", 1))
        ids = []
        for k in range(n_tris):
            ids.append(len(light_rows))
            light_rows.append(dict(type=LIGHT_AREA, L=L, pos=np.zeros(3),
                                   dir=np.array([0, 0, 1.0]), prim=start_prim + k,
                                   nsamples=ns, twosided=two,
                                   cos_total=0.0, cos_falloff=0.0))
        return ids

    for rec in all_shapes:
        # raw ids; -1 = vacuum. A prim changes the ray's medium ONLY when
        # inside != outside (MediumInterface::IsMediumTransition, medium.h);
        # equal ids (incl. the no-interface default -1/-1) keep the medium.
        mi_in = med_id(rec.medium_interface.inside)
        mi_out = med_id(rec.medium_interface.outside)
        qrow = _quadric_row(rec)
        if qrow is not None:
            qrow.update(dict(
                o2w=rec.object_to_world.m, w2o=rec.object_to_world.m_inv,
                mat=mats.add(rec.material), light=-1,
                reverse=rec.reverse_orientation ^ rec.object_to_world.swaps_handedness(),
                area=rec.area_light, med_in=mi_in, med_out=mi_out))
            sph_rows.append(qrow)
            continue
        mesh = _shape_to_mesh(rec, scene_dir)
        if mesh is None:
            continue
        P, N, uv, F = mesh[:4]
        face_ids = mesh[4] if len(mesh) > 4 else None
        t = rec.object_to_world
        flip = rec.reverse_orientation ^ t.swaps_handedness()
        if flip:
            # Bake the orientation flip into the winding so the raw geometric
            # normal IS the emission/shading side (the reference flips the
            # interaction normal instead, shape.h reverseOrientation).
            F = F[:, [0, 2, 1]]
        Pw = t.apply_point(P)
        p0, p1, p2 = Pw[F[:, 0]], Pw[F[:, 1]], Pw[F[:, 2]]
        if rec.object_to_world_end is not None:
            Pe = rec.object_to_world_end.apply_point(P)
            dp0_, dp1_, dp2_ = (Pe[F[:, 0]] - p0, Pe[F[:, 1]] - p1,
                                Pe[F[:, 2]] - p2)
        else:
            dp0_ = dp1_ = dp2_ = np.zeros_like(p0)
        gn = np.cross(p1 - p0, p2 - p0)
        gl = np.linalg.norm(gn, axis=-1, keepdims=True)
        degenerate = gl[:, 0] < 1e-20
        gn = gn / np.where(gl > 0, gl, 1.0)
        if N is not None:
            Nw = t.apply_normal(N)
            nl = np.linalg.norm(Nw, axis=-1, keepdims=True)
            Nw = Nw / np.where(nl > 0, nl, 1.0)
            if rec.reverse_orientation:
                Nw = -Nw
            n0, n1, n2 = Nw[F[:, 0]], Nw[F[:, 1]], Nw[F[:, 2]]
        else:
            n0 = n1 = n2 = gn
        if uv is not None:
            uv0, uv1, uv2 = uv[F[:, 0]], uv[F[:, 1]], uv[F[:, 2]]
        else:
            uv0 = np.tile([0.0, 0.0], (len(F), 1))
            uv1 = np.tile([1.0, 0.0], (len(F), 1))
            uv2 = np.tile([1.0, 1.0], (len(F), 1))
        keep = ~degenerate
        mid = mats.add(rec.material)
        n_tris = int(keep.sum())
        lids = np.full(len(F), -1, np.int64)
        if rec.area_light is not None:
            ids = add_area_lights_for_tris(n_tris, rec.area_light, tri_count)
            lids[keep] = ids
        fi_arr = (np.asarray(face_ids).reshape(-1)[: len(F)]
                  if face_ids is not None and len(face_ids) >= len(F)
                  else np.zeros(len(F), np.int64))
        tri_chunks.append(dict(
            p0=p0[keep], p1=p1[keep], p2=p2[keep],
            n0=n0[keep], n1=n1[keep], n2=n2[keep],
            uv0=uv0[keep], uv1=uv1[keep], uv2=uv2[keep],
            dp0=dp0_[keep], dp1=dp1_[keep], dp2=dp2_[keep],
            mat=np.full(n_tris, mid), light=lids[keep],
            med_in=np.full(n_tris, mi_in), med_out=np.full(n_tris, mi_out),
            face=fi_arr[keep]))
        tri_count += n_tris

    tris = Triangles(
        **{k: (np.concatenate([c[k] for c in tri_chunks]).astype(
            np.int32 if k in ("mat", "light", "med_in", "med_out", "face")
            else np.float32)
            if tri_chunks else _empty_tri_field(k))
           for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                     "mat", "light", "med_in", "med_out",
                     "dp0", "dp1", "dp2", "face")})

    # sphere area lights: prim ids come after triangles, so assign them now
    # that tri_count is final
    sph_light = np.full(len(sph_rows), -1, np.int64)
    sph_i = 0
    for rec in all_shapes:
        if rec.type != "sphere":
            continue
        if rec.area_light is not None:
            name, lp = rec.area_light
            L = lp.find_one_spectrum("L", [1, 1, 1]) * lp.find_one_float("scale", 1.0)
            lid = len(light_rows)
            light_rows.append(dict(
                type=LIGHT_AREA, L=L, pos=np.zeros(3), dir=np.array([0, 0, 1.0]),
                prim=tri_count + sph_i,
                nsamples=lp.find_one_int("samples", lp.find_one_int("nsamples", 1)),
                twosided=lp.find_one_bool("twosided", False),
                cos_total=0.0, cos_falloff=0.0))
            sph_light[sph_i] = lid
        sph_i += 1

    spheres = Spheres(
        o2w=np.stack([r["o2w"] for r in sph_rows]).astype(np.float32)
        if sph_rows else np.zeros((0, 4, 4), np.float32),
        w2o=np.stack([r["w2o"] for r in sph_rows]).astype(np.float32)
        if sph_rows else np.zeros((0, 4, 4), np.float32),
        radius=np.asarray([r["radius"] for r in sph_rows], np.float32),
        zmin=np.asarray([r["zmin"] for r in sph_rows], np.float32),
        zmax=np.asarray([r["zmax"] for r in sph_rows], np.float32),
        phimax=np.asarray([r["phimax"] for r in sph_rows], np.float32),
        mat=np.asarray([r["mat"] for r in sph_rows], np.int32),
        light=sph_light.astype(np.int32),
        reverse=np.asarray([r["reverse"] for r in sph_rows], bool),
        med_in=np.asarray([r["med_in"] for r in sph_rows], np.int32),
        med_out=np.asarray([r["med_out"] for r in sph_rows], np.int32),
        kind=np.asarray([r["kind"] for r in sph_rows], np.int32),
        q1=np.asarray([r["q1"] for r in sph_rows], np.float32),
        q2=np.asarray([r["q2"] for r in sph_rows], np.float32),
    )

    # 3. non-area lights
    env_state = {"map": None, "id": -1, "w2l": None}
    light_imgs: List[np.ndarray] = []  # gonio/projection map atlas
    for lr in desc.lights:
        p = lr.params
        t = lr.light_to_world
        scale = p.find_one_spectrum("scale", [1, 1, 1])
        if lr.type == "point":
            I = p.find_one_spectrum("I", [1, 1, 1]) * scale
            pos = t.apply_point([p.find_one_point("from", [0, 0, 0])])[0]
            light_rows.append(dict(type=LIGHT_POINT, L=I, pos=pos,
                                   dir=np.array([0, 0, 1.0]), prim=-1, nsamples=1,
                                   twosided=False, cos_total=0.0, cos_falloff=0.0))
        elif lr.type == "distant":
            L = p.find_one_spectrum("L", [1, 1, 1]) * scale
            frm = p.find_one_point("from", [0, 0, 0])
            to = p.find_one_point("to", [0, 0, 1])
            d = t.apply_vector([np.asarray(to) - np.asarray(frm)])[0]
            d = d / np.linalg.norm(d)
            light_rows.append(dict(type=LIGHT_DISTANT, L=L, pos=frm,
                                   dir=-d,  # dir = direction TOWARD the light
                                   prim=-1, nsamples=1, twosided=False,
                                   cos_total=0.0, cos_falloff=0.0))
        elif lr.type in ("spot",):
            I = p.find_one_spectrum("I", [1, 1, 1]) * scale
            frm = t.apply_point([p.find_one_point("from", [0, 0, 0])])[0]
            to = t.apply_point([p.find_one_point("to", [0, 0, 1])])[0]
            axis = to - frm
            axis = axis / np.linalg.norm(axis)
            cone = p.find_one_float("coneangle", 30.0)
            delta = p.find_one_float("conedeltaangle", 5.0)
            light_rows.append(dict(type=LIGHT_SPOT, L=I, pos=frm, dir=axis,
                                   prim=-1, nsamples=1, twosided=False,
                                   cos_total=np.cos(np.deg2rad(cone)),
                                   cos_falloff=np.cos(np.deg2rad(cone - delta))))
        elif lr.type == "infinite":
            L = p.find_one_spectrum("L", [1, 1, 1]) * scale
            mapname = p.find_one_string("mapname", "")
            if mapname:
                path = mapname if os.path.isabs(mapname) else os.path.join(
                    scene_dir, mapname)
                img = load_image(path)
                if img is not None:
                    if env_state["map"] is not None:
                        warnings.warn("multiple env-mapped infinite lights; "
                                      "only the first gets the map")
                    else:
                        # the map carries L (infinite.cpp scales Lmap by L)
                        env_state["map"] = (img * np.asarray(L)).astype(np.float32)
                        env_state["id"] = len(light_rows)
                        env_state["w2l"] = t.m_inv[:3, :3].astype(np.float32)
                else:
                    warnings.warn(f"env map {mapname!r} not found; constant L")
            light_rows.append(dict(type=LIGHT_INFINITE, L=L, pos=np.zeros(3),
                                   dir=np.array([0, 0, 1.0]), prim=-1,
                                   nsamples=p.find_one_int("samples", p.find_one_int("nsamples", 1)),
                                   twosided=False, cos_total=0.0, cos_falloff=0.0))
        elif lr.type in ("goniometric", "projection"):
            # goniometric.cpp / projection.cpp: point intensity modulated by
            # an angular map (equirect) / a projected image (perspective)
            I = p.find_one_spectrum("I", [1, 1, 1]) * scale
            frm = t.apply_point([np.zeros(3)])[0]
            mapname = p.find_one_string("mapname", "")
            img = None
            if mapname:
                path = mapname if os.path.isabs(mapname) else os.path.join(
                    scene_dir, mapname)
                img = load_image(path)
                if img is None:
                    warnings.warn(f"light map {mapname!r} not found")
            if img is None:
                img = np.ones((1, 1, 3), np.float32)
            off = sum(i.shape[0] * i.shape[1] for i in light_imgs)
            light_imgs.append(np.asarray(img, np.float32))
            fov = p.find_one_float("fov", 45.0)
            typ = (LIGHT_GONIO if lr.type == "goniometric"
                   else LIGHT_PROJECTION)
            light_rows.append(dict(
                type=typ, L=I, pos=frm, dir=np.array([0, 0, 1.0]), prim=-1,
                nsamples=1, twosided=False,
                cos_total=np.cos(np.deg2rad(fov) / 2.0), cos_falloff=0.0,
                w2l=t.m_inv[:3, :3], img_off=off,
                img_w=img.shape[1], img_h=img.shape[0]))
        else:
            warnings.warn(f"light {lr.type!r} not yet supported; skipped")

    lights = Lights(
        type=np.asarray([r["type"] for r in light_rows], np.int32),
        L=np.asarray([r["L"] for r in light_rows], np.float32).reshape(-1, 3),
        pos=np.asarray([r["pos"] for r in light_rows], np.float32).reshape(-1, 3),
        dir=np.asarray([r["dir"] for r in light_rows], np.float32).reshape(-1, 3),
        prim=np.asarray([r["prim"] for r in light_rows], np.int32),
        nsamples=np.asarray([r["nsamples"] for r in light_rows], np.int32),
        twosided=np.asarray([r["twosided"] for r in light_rows], bool),
        cos_total=np.asarray([r["cos_total"] for r in light_rows], np.float32),
        cos_falloff=np.asarray([r["cos_falloff"] for r in light_rows], np.float32),
        w2l=np.asarray([r.get("w2l", np.eye(3)) for r in light_rows],
                       np.float32).reshape(-1, 3, 3),
        img_off=np.asarray([r.get("img_off", -1) for r in light_rows], np.int32),
        img_w=np.asarray([r.get("img_w", 0) for r in light_rows], np.int32),
        img_h=np.asarray([r.get("img_h", 0) for r in light_rows], np.int32),
        img=(np.concatenate([i.reshape(-1, 3) for i in light_imgs])
             if light_imgs else np.zeros((1, 3), np.float32)),
    )

    # 4. camera / film / sampler / integrator configs
    film = _film_config(desc)
    camera = _camera_config(desc, film, scene_dir)
    sampler = _sampler_config(desc)
    integ = _integrator_config(desc)

    return FlatScene(tris, spheres, mats.finalize(), lights, camera, film,
                     sampler, integ, desc.accelerator_name,
                     desc.accelerator_params,
                     textures=tex_table.arrays(),
                     media=dict(desc.media), env_map=env_state["map"],
                     env_light_id=env_state["id"], env_w2l=env_state["w2l"],
                     fourier_table=_fourier_table(mats.rows, scene_dir),
                     media_order=media_order, camera_medium=camera_medium)


def _fourier_table(rows, scene_dir: str):
    """The shared Fourier BSDF table: the first readable .bsdf file that a
    fourier material names (one table a scene; a second file is ignored
    with a warning, a missing one warned about), or None."""
    from tpupt_torch.materials.fourier import read_bsdf_file

    table = None
    for row in rows:
        fn = (row or {}).get("fourier_file")
        if not fn:
            continue
        path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
        if not os.path.isfile(path):
            warnings.warn(f"fourier bsdffile {fn!r} not found")
            continue
        t = read_bsdf_file(path)
        if t is None:
            continue
        if table is not None:
            warnings.warn("multiple .bsdf files; using the first")
        else:
            table = t
    return table


def with_resolution(scene: FlatScene, xres: int, yres: int) -> FlatScene:
    """Return a copy of the scene at a different film resolution with the
    raster-to-camera matrix recomputed (screen window from the new aspect)."""
    import dataclasses

    film = dataclasses.replace(scene.film, xres=xres, yres=yres)
    cam = scene.camera
    aspect = xres / yres
    if aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    screen_to_raster = (
        Transform.scale([xres, yres, 1.0])
        * Transform.scale([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0])
        * Transform.translate([-x0, -y1, 0.0])
    )
    if cam.type == CAM_ORTHOGRAPHIC:
        cam_to_screen = Transform.orthographic(0.0, 1.0)
    else:
        cam_to_screen = Transform.perspective(cam.fov, 1e-2, 1000.0)
    r2c = (cam_to_screen.inverse() * screen_to_raster.inverse()).m.astype(np.float32)
    camera = dataclasses.replace(cam, raster_to_camera=r2c)
    return dataclasses.replace(scene, film=film, camera=camera)


def _empty_tri_field(k: str):
    if k in ("mat", "light", "med_in", "med_out", "face"):
        return np.zeros(0, np.int32)
    return np.zeros((0, 2 if k.startswith("uv") else 3), np.float32)


def _film_config(desc: SceneDescription) -> FilmConfig:
    p = desc.film_params
    fp = desc.filter_params
    fname = desc.filter_name
    rad_default = _FILTER_DEFAULT_RADIUS.get(fname, 2.0)
    xw = fp.find_one_float("xwidth", rad_default)
    yw = fp.find_one_float("ywidth", rad_default)
    extra: Tuple[float, ...] = ()
    if fname == "gaussian":
        extra = (fp.find_one_float("alpha", 2.0),)
    elif fname == "mitchell":
        extra = (fp.find_one_float("B", 1.0 / 3.0), fp.find_one_float("C", 1.0 / 3.0))
    elif fname == "sinc":
        extra = (fp.find_one_float("tau", 3.0),)
    crop = p.find_floats("cropwindow")
    crop = tuple(crop) if crop is not None and len(crop) == 4 else (0.0, 1.0, 0.0, 1.0)
    return FilmConfig(
        xres=p.find_one_int("xresolution", 1280),
        yres=p.find_one_int("yresolution", 720),
        crop=crop,
        filename=p.find_one_string("filename", "out.exr"),
        filter_type=_FILTER_IDS.get(fname, FILTER_BOX),
        filter_radius=(xw, yw),
        filter_params=extra,
        scale=p.find_one_float("scale", 1.0),
        max_sample_luminance=p.find_one_float("maxsampleluminance", np.inf),
        diagonal=p.find_one_float("diagonal", 35.0),
    )


def _camera_config(desc: SceneDescription, film: FilmConfig,
                   scene_dir: str = ".") -> CameraConfig:
    p = desc.camera_params
    name = desc.camera_name
    ctype = {"perspective": CAM_PERSPECTIVE, "orthographic": CAM_ORTHOGRAPHIC,
             "environment": CAM_ENVIRONMENT,
             "realistic": CAM_REALISTIC}.get(name)
    if ctype is None:
        warnings.warn(f"camera {name!r} not yet supported; using perspective")
        ctype = CAM_PERSPECTIVE
    lens_data = lens_z = None
    if ctype == CAM_REALISTIC:
        # lens stack + paraxial focusing (realistic.cpp:42-70)
        from tpupt_torch.cameras.realistic import (element_z_positions,
                                                   focus_thick_lens,
                                                   load_lens_file)

        lf = p.find_one_string("lensfile", "")
        path = lf if os.path.isabs(lf) else os.path.join(scene_dir, lf)
        if lf and os.path.isfile(path):
            lens_data = load_lens_file(path)
            ap_d = p.find_one_float("aperturediameter", 1.0) * 1e-3
            stop = lens_data[:, 0] == 0
            lens_data[stop, 3] = np.minimum(lens_data[stop, 3], ap_d / 2)
            fd = p.find_one_float("focusdistance", 10.0)
            lens_data = focus_thick_lens(lens_data, fd)
            lens_z = element_z_positions(lens_data)
        else:
            warnings.warn(f"realistic camera: lensfile {lf!r} not found; "
                          "using perspective")
            ctype = CAM_PERSPECTIVE
    fov = p.find_one_float("fov", 90.0)
    aspect = p.find_one_float("frameaspectratio", film.xres / film.yres)
    sw = p.find_floats("screenwindow")
    if sw is not None and len(sw) == 4:
        x0, x1, y0, y1 = sw
    elif aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    # raster -> screen -> camera (cameras/perspective.cpp ProjectiveCamera ctor)
    screen_to_raster = (
        Transform.scale([film.xres, film.yres, 1.0])
        * Transform.scale([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0])
        * Transform.translate([-x0, -y1, 0.0])
    )
    if ctype == CAM_ORTHOGRAPHIC:
        cam_to_screen = Transform.orthographic(0.0, 1.0)
    else:
        cam_to_screen = Transform.perspective(fov, 1e-2, 1000.0)
    raster_to_camera = cam_to_screen.inverse() * screen_to_raster.inverse()
    at = desc.camera_to_world
    c2w = at.interpolate(at.start_time)
    c2w_end = (at.interpolate(at.end_time).m.astype(np.float32)
               if at.animated else None)
    return CameraConfig(
        type=ctype,
        cam_to_world=c2w.m.astype(np.float32),
        cam_to_world_end=c2w_end,
        raster_to_camera=raster_to_camera.m.astype(np.float32),
        lens_radius=p.find_one_float("lensradius", 0.0),
        focal_distance=p.find_one_float("focaldistance", 1e6),
        shutter_open=p.find_one_float("shutteropen", 0.0),
        shutter_close=p.find_one_float("shutterclose", 1.0),
        fov=fov,
        lens_data=lens_data,
        lens_z=lens_z,
        film_diag=film.diagonal * 1e-3,
    )


def _sampler_config(desc: SceneDescription) -> SamplerConfig:
    p = desc.sampler_params
    name = desc.sampler_name
    spp = p.find_one_int("pixelsamples", 16)
    xs = p.find_one_int("xsamples", 4)
    ys = p.find_one_int("ysamples", 4)
    if name == "stratified":
        spp = xs * ys
    return SamplerConfig(name=name, spp=spp, jitter=p.find_one_bool("jitter", True),
                         xsamples=xs, ysamples=ys)


def _integrator_config(desc: SceneDescription) -> IntegratorConfig:
    p = desc.integrator_params
    return IntegratorConfig(
        name=desc.integrator_name,
        max_depth=p.find_one_int("maxdepth", 5),
        rr_threshold=p.find_one_float("rrthreshold", 1.0),
        light_strategy=p.find_one_string("lightsamplestrategy", "spatial"),
        strategy=p.find_one_string("strategy", "all"),
        cos_sample=p.find_one_bool("cossample", True),
        n_ao_samples=p.find_one_int("nsamples", 64),
    )
