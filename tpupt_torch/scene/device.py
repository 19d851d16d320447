"""DeviceScene: the FlatScene + wide BVH uploaded as one bundle of tensors.

This is the tensor bundle every kernel takes; static ints (table sizes,
max leaf size) live on the side in `SceneStatics`. Field names are those of
the JAX package's `tpupt.scene.device`, so that a reader finds the
counterpart; fields that only its TPU kernels read (tiled node copies, padded
prim rows) and fields of features this package does not render yet are absent.
A scene whose node and prim tables reach TWO_LEVEL_MIN_BYTES also gets the
two-level tables of accel/treelets.py (same switch as the JAX package, so a
scene is walked through the same tree by both), in that module's packed
layout, not in the JAX package's padded one."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpupt_torch.accel.bvh import (BVHArrays, build_bvh, build_bvh_split,
                                   collapse_to_wide, scene_prim_bounds)
from tpupt_torch.accel.treelets import (TREELET_NODES, TREELET_PRIMS,
                                        build_treelets)
from tpupt_torch.scene.flatten import FlatScene

# above this many prims the serial sweep-SAH build (O(n log^2 n)) gives
# way to the vectorized LBVH
NATIVE_SAH_MAX_PRIMS = 400_000
# node + prim table bytes from which `upload` builds the two-level tables
TWO_LEVEL_MIN_BYTES = 12 * 1024 * 1024
# the two-level fields of DeviceScene (accel/treelets.py); one-row dummies
# in a single-level scene
TWO_LEVEL_FIELDS = ("top_nodes", "tl_nodes", "tl_prims", "tl_offsets")


class DeviceScene(NamedTuple):
    # triangles
    tri_p0: torch.Tensor
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    tri_face: torch.Tensor     # (T,) i32 faceIndex per triangle
    # quadrics ("spheres" for historical reasons; shapes/quadric.py)
    sph_o2w: torch.Tensor
    sph_w2o: torch.Tensor
    sph_radius: torch.Tensor
    sph_zmin: torch.Tensor
    sph_zmax: torch.Tensor
    sph_phimax: torch.Tensor
    sph_mat: torch.Tensor
    sph_light: torch.Tensor
    sph_reverse: torch.Tensor
    sph_kind: torch.Tensor     # (S,) i32 quadric kind
    sph_q1: torch.Tensor       # (S,) f32 kind-specific scalar
    sph_q2: torch.Tensor
    # wide BVH (packed rows, the hot traversal path)
    wide_nodes: torch.Tensor   # (Nw, 64) f32, int32 meta bit-cast in 48-55
    prim_rows: torch.Tensor    # (P, 32) f32: tri verts or quadric w2o+params
    # two-level tables (accel/treelets.py); one-row dummies when single-level
    top_nodes: torch.Tensor    # (Ntop, 64) f32, leaves are treelet references
    tl_nodes: torch.Tensor     # (sum Nt, 64) f32, treelet-local ids
    tl_prims: torch.Tensor     # (P, 32) f32 in treelet order
    tl_offsets: torch.Tensor   # (NT, 2) i32 first node row, first prim row
    # materials
    mat_type: torch.Tensor
    mat_kd: torch.Tensor
    mat_ks: torch.Tensor
    mat_kr: torch.Tensor
    mat_kt: torch.Tensor
    mat_roughness: torch.Tensor
    mat_urough: torch.Tensor
    mat_vrough: torch.Tensor
    mat_eta: torch.Tensor
    mat_k: torch.Tensor
    mat_sigma: torch.Tensor
    mat_remap: torch.Tensor
    mat_extra: torch.Tensor
    # lights
    light_type: torch.Tensor
    light_L: torch.Tensor
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    light_prim: torch.Tensor
    light_nsamples: torch.Tensor
    light_twosided: torch.Tensor
    light_cos_total: torch.Tensor
    light_cos_falloff: torch.Tensor
    light_pdf: torch.Tensor       # discrete choice pmf per light
    # spatial light distribution (lightdistrib.h:100): per-voxel light-choice
    # cdf over a G^3 grid of the world bounds; (1,1) when disabled
    light_grid_cdf: torch.Tensor
    # camera
    cam_to_world: torch.Tensor
    raster_to_camera: torch.Tensor
    # world bounds
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    # per-interface media: one-row dummies until media are ported
    med_sigma_a: torch.Tensor
    med_sigma_s: torch.Tensor
    med_g: torch.Tensor
    med_majorant: torch.Tensor
    med_is_grid: torch.Tensor
    med_density: torch.Tensor
    med_dens_off: torch.Tensor
    med_dens_dims: torch.Tensor
    med_w2m: torch.Tensor
    prim_med_in: torch.Tensor     # (P,) i32 global prim order, -1 vacuum
    prim_med_out: torch.Tensor


class SceneStatics(NamedTuple):
    n_tris: int
    n_spheres: int
    n_lights: int
    max_leaf: int
    n_nodes: int
    n_wide_nodes: int
    env_w: int = 0
    env_h: int = 0
    env_light_id: int = -1
    has_textures: bool = False
    mat_features: frozenset = frozenset()
    spatial_lights: bool = False  # light_grid_cdf is a real G^3 grid
    has_light_imgs: bool = False
    n_media: int = 0
    camera_medium: int = -1
    any_grid_media: bool = False
    has_med_interfaces: bool = False
    has_motion: bool = False
    cam_animated: bool = False
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    n_channels: int = 3
    two_level: bool = False
    n_treelets: int = 0
    tl_tn: int = 0
    tl_tp: int = 0


# statics that must be off in tables handed over from the JAX package: each
# names a feature this package does not render yet
_UNPORTED_STATICS = dict(
    env_w=0, has_textures=False, mat_features=frozenset(),
    has_light_imgs=False, n_media=0, has_motion=False, cam_animated=False,
    n_channels=3)


def pack_prim_rows(scene: FlatScene, prim_ids: np.ndarray) -> np.ndarray:
    """One 32-float row per prim IN BVH-LEAF ORDER (prim_ids permutation),
    so the traversal loop needs exactly one row gather per prim test and
    per-leaf prim loads are contiguous. Layout:
      floats 0-8  : triangle p0 p1 p2        (triangles)
      floats 0-11 : w2o upper 3x4            (spheres)
      slot 12/13/14/15 : radius zmin zmax phimax (spheres)
      slot 16 (i32): global prim id (bitcast)    [both]
      slot 17 (i32): 1 = triangle, 0 = sphere    [both]
      rest pad."""
    t, s = scene.triangles, scene.spheres
    prim_ids = np.asarray(prim_ids, np.int64)
    n = len(prim_ids)
    rows = np.zeros((max(n, 1), 32), np.float32)
    iview = rows.view(np.int32)
    tri_mask = prim_ids < t.count
    tid = prim_ids[tri_mask]
    if tid.size:
        rows[tri_mask, 0:3] = t.p0[tid]
        rows[tri_mask, 3:6] = t.p1[tid]
        rows[tri_mask, 6:9] = t.p2[tid]
    sph_mask = ~tri_mask
    sid = prim_ids[sph_mask] - t.count
    if sid.size:
        rows[sph_mask, 0:12] = s.w2o[sid][:, :3, :].reshape(len(sid), 12)
        rows[sph_mask, 12] = s.radius[sid]
        rows[sph_mask, 13] = s.zmin[sid]
        rows[sph_mask, 14] = s.zmax[sid]
        rows[sph_mask, 15] = s.phimax[sid]
        kind = (s.kind[sid] if s.kind is not None
                else np.zeros(len(sid), np.int32))
        rows[sph_mask, 20] = kind.astype(np.float32)
        rows[sph_mask, 21] = (s.q1[sid] if s.q1 is not None
                              else 0.0)
        rows[sph_mask, 22] = (s.q2[sid] if s.q2 is not None
                              else 0.0)
        rows[sph_mask, 23] = np.sin(s.phimax[sid])
        rows[sph_mask, 24] = np.cos(s.phimax[sid])
    iview[:n, 16] = prim_ids.astype(np.int32)
    iview[:n, 17] = tri_mask.astype(np.int32)
    # float-coded copies of the two ints (kept so that the rows are the
    # JAX package's rows, array-equal)
    rows[:n, 18] = prim_ids.astype(np.float32)
    rows[:n, 19] = tri_mask.astype(np.float32)
    return rows



def _pad1(a: np.ndarray, fill=0):
    """Ensure at least one row so device gathers with clamped indices work."""
    if len(a) > 0:
        return a
    shape = (1,) + a.shape[1:]
    return np.full(shape, fill, a.dtype)



SPATIAL_GRID_RES = 16


def _spatial_light_grid(scene: FlatScene, lt, wlo, whi):
    """Voxelized light-choice distributions (SpatialLightDistribution,
    lightdistrib.cpp:100-180 re-architected for a wavefront: instead of a lazily
    filled hash table, a dense G^3 grid of per-voxel cdfs is precomputed at
    upload — each voxel weights every light by an unoccluded contribution
    estimate at the voxel center, like the reference's sampled estimate)."""
    from tpupt_torch.scene.flatten import (LIGHT_AREA, LIGHT_DISTANT,
                                     LIGHT_INFINITE, LIGHT_POINT,
                                     LIGHT_SPOT)

    g = SPATIAL_GRID_RES
    ax = [np.linspace(wlo[a], whi[a], g, endpoint=False)
          + (whi[a] - wlo[a]) / (2 * g) for a in range(3)]
    cx, cy, cz = np.meshgrid(*ax, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], -1)  # (V,3)
    diag2 = float(np.sum((whi - wlo) ** 2)) / (g * g)

    lum = 0.2126 * lt.L[:, 0] + 0.7152 * lt.L[:, 1] + 0.0722 * lt.L[:, 2]
    weights = np.zeros((len(centers), lt.count), np.float64)
    t, s = scene.triangles, scene.spheres
    for li in range(lt.count):
        typ = int(lt.type[li])
        if typ in (LIGHT_POINT, LIGHT_SPOT) or typ > LIGHT_SPOT:
            d2 = np.sum((centers - lt.pos[li]) ** 2, -1)
            w = lum[li] / np.maximum(d2, diag2)
            if typ == LIGHT_SPOT:  # cone culling at the voxel center
                to_c = centers - lt.pos[li]
                to_c /= np.maximum(np.linalg.norm(to_c, axis=-1,
                                                  keepdims=True), 1e-12)
                w = w * (to_c @ lt.dir[li] > lt.cos_total[li] - 0.2)
        elif typ in (LIGHT_DISTANT, LIGHT_INFINITE):
            w = np.full(len(centers), lum[li] * np.pi)
        elif typ == LIGHT_AREA:
            prim = int(lt.prim[li])
            if prim < t.count:
                c = (t.p0[prim] + t.p1[prim] + t.p2[prim]) / 3.0
                area = 0.5 * np.linalg.norm(
                    np.cross(t.p1[prim] - t.p0[prim], t.p2[prim] - t.p0[prim]))
            else:
                sid = prim - t.count
                c = s.o2w[sid][:3, 3]
                area = 4 * np.pi * s.radius[sid] ** 2
            d2 = np.sum((centers - c) ** 2, -1)
            w = lum[li] * area / np.maximum(d2, diag2)
        else:
            w = np.full(len(centers), lum[li])
        weights[:, li] = np.maximum(w, 0.0)
    tot = weights.sum(-1, keepdims=True)
    # all-zero voxels fall back to uniform (reference does the same)
    pmf = np.where(tot > 0, weights / np.maximum(tot, 1e-300),
                   1.0 / lt.count)
    return np.cumsum(pmf, -1).astype(np.float32)


def build_scene_bvh(scene: FlatScene) -> BVHArrays:
    """The binary BVH the wide tables are collapsed from: the scene's
    `splitmethod`, else exact sweep-SAH in native code up to
    NATIVE_SAH_MAX_PRIMS prims and the vectorized LBVH above. A native
    build that fails raises."""
    lo, hi = scene_prim_bounds(scene)
    params = scene.accelerator_params
    max_leaf = params.find_one_int("maxnodeprims", 4) if params else 4
    icost = params.find_one_float("intersectcost", 8.0) if params else 8.0
    tcost = params.find_one_float("traversalcost", 1.0) if params else 1.0
    split = (params.find_one_string("splitmethod", "sah")
             if params else "sah").lower()
    if split in ("middle", "equal", "equalcounts") and len(lo):
        # research comparators (bvhOld.h:58-65 Middle/EqualCounts)
        return build_bvh_split(
            lo, hi, "middle" if split == "middle" else "equalcounts",
            max_leaf)
    if 0 < len(lo) <= NATIVE_SAH_MAX_PRIMS:
        from tpupt_torch.native import build_bvh_sah

        return build_bvh_sah(lo, hi, icost, tcost, max_leaf)
    return build_bvh(lo, hi, max_leaf, icost, tcost)


def _two_level_fields(tla) -> dict:
    if tla is None:
        return dict(top_nodes=np.zeros((1, 64), np.float32),
                    tl_nodes=np.zeros((1, 64), np.float32),
                    tl_prims=np.zeros((1, 32), np.float32),
                    tl_offsets=np.zeros((1, 2), np.int32))
    return dict(top_nodes=tla.top_nodes, tl_nodes=tla.tl_nodes,
                tl_prims=tla.tl_prims, tl_offsets=tla.tl_offsets)


def host_tables(scene: FlatScene, bvh: BVHArrays = None,
                light_strategy: str = "uniform", two_level: bool = None,
                treelet_budget: tuple = None):
    """(fields: dict of numpy arrays, SceneStatics) for a flattened scene,
    before anything touches a device. two_level forces the two-level tables
    on or off (default: built from TWO_LEVEL_MIN_BYTES of node + prim rows);
    treelet_budget=(tn, tp) overrides the treelet capacities (tests cut small
    scenes into many treelets with it)."""
    t, s, m, lt = scene.triangles, scene.spheres, scene.materials, scene.lights
    if t.has_motion or scene.camera.cam_to_world_end is not None:
        raise NotImplementedError(
            "motion blur is not in the PyTorch port yet (ROADMAP.md queue 1, "
            "items 3 and 4)")
    if scene.media or scene.env_map is not None or scene.fourier_table:
        raise NotImplementedError(
            "media, environment maps and Fourier tables are not in the "
            "PyTorch port yet (ROADMAP.md queue 1, item 10)")
    if bvh is None:
        bvh = build_scene_bvh(scene)
    wlo, whi = scene.world_bounds()
    wide_nodes, _ = collapse_to_wide(bvh)
    prim_rows = pack_prim_rows(scene, bvh.prim_ids)
    if two_level is None:
        two_level = (wide_nodes.nbytes + prim_rows.nbytes
                     >= TWO_LEVEL_MIN_BYTES)
    tla = None
    if two_level:
        # fatter leaves under treelets, as the JAX package collapses them
        wide_nodes, _ = collapse_to_wide(bvh, leaf_merge=8)
        tn, tp = treelet_budget or (TREELET_NODES, TREELET_PRIMS)
        tla = build_treelets(wide_nodes, prim_rows, tn, tp)

    n_prims = scene.prim_count
    med_in = np.full(max(n_prims, 1), -1, np.int32)
    med_out = np.full(max(n_prims, 1), -1, np.int32)

    n_lights = lt.count
    if light_strategy == "power" and n_lights > 0:
        power = np.maximum(lt.L.sum(-1), 1e-12)
        light_pdf = power / power.sum()
    else:
        light_pdf = np.full(max(n_lights, 1), 1.0 / max(n_lights, 1), np.float32)
    light_grid_cdf = np.zeros((1, 1), np.float32)
    if light_strategy == "spatial" and 0 < n_lights <= 256:
        light_grid_cdf = _spatial_light_grid(scene, lt, wlo, whi)

    eye = np.eye(4, dtype=np.float32)[None]
    f32, i32 = np.float32, np.int32
    fields = dict(
        tri_p0=_pad1(t.p0), tri_p1=_pad1(t.p1), tri_p2=_pad1(t.p2),
        tri_n0=_pad1(t.n0), tri_n1=_pad1(t.n1), tri_n2=_pad1(t.n2),
        tri_uv0=_pad1(t.uv0), tri_uv1=_pad1(t.uv1), tri_uv2=_pad1(t.uv2),
        tri_mat=_pad1(t.mat), tri_light=_pad1(t.light, -1),
        tri_face=_pad1(t.face if t.face is not None
                       else np.zeros(t.count, i32)),
        sph_o2w=s.o2w if s.count else eye,
        sph_w2o=s.w2o if s.count else eye,
        sph_radius=_pad1(s.radius, 1), sph_zmin=_pad1(s.zmin, -1),
        sph_zmax=_pad1(s.zmax, 1), sph_phimax=_pad1(s.phimax, 2 * np.pi),
        sph_mat=_pad1(s.mat), sph_light=_pad1(s.light, -1),
        sph_reverse=_pad1(s.reverse),
        sph_kind=_pad1(s.kind if s.kind is not None
                       else np.zeros(s.count, i32)),
        sph_q1=_pad1(s.q1 if s.q1 is not None else np.zeros(s.count, f32)),
        sph_q2=_pad1(s.q2 if s.q2 is not None else np.zeros(s.count, f32)),
        wide_nodes=wide_nodes, prim_rows=prim_rows,
        **_two_level_fields(tla),
        mat_type=m.type, mat_kd=m.kd, mat_ks=m.ks, mat_kr=m.kr, mat_kt=m.kt,
        mat_roughness=m.roughness, mat_urough=m.urough, mat_vrough=m.vrough,
        mat_eta=m.eta, mat_k=m.k, mat_sigma=m.sigma,
        mat_remap=m.remap_roughness, mat_extra=m.extra,
        light_type=_pad1(lt.type), light_L=_pad1(lt.L),
        light_pos=_pad1(lt.pos), light_dir=_pad1(lt.dir, 1),
        light_prim=_pad1(lt.prim, -1), light_nsamples=_pad1(lt.nsamples, 1),
        light_twosided=_pad1(lt.twosided),
        light_cos_total=_pad1(lt.cos_total),
        light_cos_falloff=_pad1(lt.cos_falloff),
        light_pdf=light_pdf.astype(f32), light_grid_cdf=light_grid_cdf,
        cam_to_world=scene.camera.cam_to_world,
        raster_to_camera=scene.camera.raster_to_camera,
        world_lo=wlo, world_hi=whi,
        med_sigma_a=np.zeros((1, 3), f32), med_sigma_s=np.zeros((1, 3), f32),
        med_g=np.zeros(1, f32), med_majorant=np.ones(1, f32),
        med_is_grid=np.zeros(1, bool), med_density=np.ones(1, f32),
        med_dens_off=np.zeros(1, i32), med_dens_dims=np.ones((1, 3), i32),
        med_w2m=eye.copy(), prim_med_in=med_in, prim_med_out=med_out,
    )
    # wide-leaf prim counts (leaf-merged fat leaves; collapse_to_wide)
    metas = wide_nodes[:, 48:56].view(np.int32)
    leaf_metas = metas[(metas < 0) & (metas != -2**31)]
    wide_max_leaf = (int(((-leaf_metas - 1) & 63).max())
                     if leaf_metas.size else 1)
    cam = scene.camera
    statics = SceneStatics(
        n_tris=t.count, n_spheres=s.count, n_lights=n_lights,
        max_leaf=max(wide_max_leaf, 1), n_nodes=bvh.n_nodes,
        n_wide_nodes=len(wide_nodes),
        spatial_lights=light_grid_cdf.shape[0] > 1,
        camera_medium=scene.camera_medium,
        shutter_open=float(cam.shutter_open),
        shutter_close=float(cam.shutter_close),
        two_level=bool(two_level),
        n_treelets=tla.n_treelets if tla else 0,
        tl_tn=tla.tn if tla else 0, tl_tp=tla.tp if tla else 0)
    return fields, statics


def _to_device(fields: dict, device) -> DeviceScene:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    out = {}
    for name in DeviceScene._fields:
        a = np.ascontiguousarray(fields[name])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(a.copy()).to(device)
    return DeviceScene(**out)


def upload(scene: FlatScene, bvh: BVHArrays = None,
           light_strategy: str = "uniform", device="cuda",
           two_level: bool = None, treelet_budget: tuple = None):
    """Build (DeviceScene, SceneStatics) from a flattened scene on `device`.
    With device="cuda" and no card this raises; it never drops to the CPU.
    two_level / treelet_budget: see `host_tables`."""
    fields, statics = host_tables(scene, bvh, light_strategy, two_level,
                                  treelet_budget)
    return _to_device(fields, device), statics


def from_numpy(ds_fields: dict, st_fields: dict, device="cuda"):
    """(DeviceScene, SceneStatics) from the JAX package's tables: every
    field of its DeviceScene as a numpy array and of its SceneStatics as a
    Python value. Fields only its TPU kernels read are dropped; its padded
    two-level tables are not read either: the treelets are cut again from
    the carried `wide_nodes` and `prim_rows` with the carried capacities,
    which gives the same treelets in this package's layout. A static that
    switches on a feature this package lacks raises."""
    for name, off in _UNPORTED_STATICS.items():
        if st_fields.get(name, off) != off:
            raise NotImplementedError(
                f"tables with {name}={st_fields[name]!r} need a feature the "
                "PyTorch port does not have yet (ROADMAP.md queue 1)")
    statics = SceneStatics(**{k: st_fields[k] for k in SceneStatics._fields
                              if k in st_fields})
    tla = None
    if statics.two_level:
        tla = build_treelets(np.asarray(ds_fields["wide_nodes"]),
                             np.asarray(ds_fields["prim_rows"]),
                             statics.tl_tn, statics.tl_tp)
    return _to_device({**ds_fields, **_two_level_fields(tla)}, device), statics
