"""DeviceScene: the FlatScene + wide BVH uploaded as one bundle of tensors.

This is the tensor bundle every kernel takes; static ints (table sizes,
max leaf size) live on the side in `SceneStatics`. Field names are those of
the JAX package's `tpupt.scene.device`, so that a reader finds the
counterpart; fields that only its TPU kernels read (tiled node copies, padded
prim rows) and fields of features this package does not render yet are absent.
A scene whose node and prim tables reach TWO_LEVEL_MIN_BYTES also gets the
two-level tables of accel/treelets.py (same switch as the JAX package, so a
scene is walked through the same tree by both), in that module's packed
layout, not in the JAX package's padded one.

Motion blur (vertex lerp at the ray's shutter time, AnimatedTransform
parity): `prim_rows_dt` holds each prim row's triangle vertex deltas dp0 dp1
dp2 in the rows' leaf order, padded to 12 floats a row (the JAX package keeps
9) so that the wide-BVH kernel reads a row as three aligned float4 loads in
the layout of the first three float4 of a prim row; quadric rows and static
scenes have zeros (a static scene a one-row dummy). `tri_dp0..2` are the
same deltas in global triangle order (the brute-force walker's). The
animated camera's keys are `cam_q` (2,4) [w,x,y,z] and `cam_tr` (2,3)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpupt_torch.accel.bvh import (BVHArrays, build_bvh, build_bvh_split,
                                   collapse_to_wide, scene_prim_bounds)
from tpupt_torch.accel.treelets import (TREELET_NODES, TREELET_PRIMS,
                                        build_treelets)
from tpupt_torch.core.sampling import build_distribution2d
from tpupt_torch.media.media import build_media_table
from tpupt_torch.scene.flatten import FlatScene
from tpupt_torch.textures.textures import present_types
from tpupt_torch.utils import logging as tlog

# above this many prims the serial sweep-SAH build (O(n log^2 n)) gives
# way to the vectorized LBVH
NATIVE_SAH_MAX_PRIMS = 400_000
# node + prim table bytes from which `upload` builds the two-level tables
TWO_LEVEL_MIN_BYTES = 12 * 1024 * 1024
# the two-level fields of DeviceScene (accel/treelets.py); one-row dummies
# in a single-level scene
TWO_LEVEL_FIELDS = ("top_nodes", "tl_nodes", "tl_prims", "tl_offsets")
# the kd / RBSP / BSP fields of DeviceScene (accel/kdbsp.py); one-row dummies
# in a scene without such a tree, whose ALT_STATICS are then 0 / False
ALT_FIELDS = ("alt_prim_rows", "alt_nodes")
ALT_STATICS = ("alt_max_leaf", "alt_tree_depth")


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
    # vertex-lerp motion blur: one-row dummies for a static scene
    prim_rows_dt: torch.Tensor  # (P, 12) f32 leaf-order dp0 dp1 dp2 | pad
    tri_dp0: torch.Tensor      # (T, 3) f32 global triangle order
    tri_dp1: torch.Tensor
    tri_dp2: torch.Tensor
    # two-level tables (accel/treelets.py); one-row dummies when single-level
    top_nodes: torch.Tensor    # (Ntop, 64) f32, leaves are treelet references
    tl_nodes: torch.Tensor     # (sum Nt, 64) f32, treelet-local ids
    tl_prims: torch.Tensor     # (P, 32) f32 in treelet order
    tl_offsets: torch.Tensor   # (NT, 2) i32 first node row, first prim row
    # kd / RBSP / BSP tree (accel/kdbsp.py); one-row dummies for a BVH scene.
    # The plain walker and the CUDA kernel read the same two tables; the
    # builders' flat arrays (array-equal to the JAX package's) stay on the
    # host, `accel.kdbsp.node_rows` packs `alt_nodes` from them.
    alt_prim_rows: torch.Tensor  # (P4, 32) f32 prim rows in leaf order
    alt_nodes: torch.Tensor    # (K,8) f32 one 32-byte row a node: direction,
    #                            split | leaf flag, above / first prim, nprims
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
    light_w2l: torch.Tensor       # (L,3,3) world->light rotations (gonio/projection)
    light_img_off: torch.Tensor   # (L,) i32 into light_img, -1 = none
    light_img_w: torch.Tensor
    light_img_h: torch.Tensor
    light_img: torch.Tensor       # angular / projection map atlas (P,3)
    # spatial light distribution (lightdistrib.h:100): per-voxel light-choice
    # cdf over a G^3 grid of the world bounds; (1,1) when disabled
    light_grid_cdf: torch.Tensor
    # textures (flat tables + texel atlas; textures/textures.py); one-row
    # dummies without textures
    tex_type: torch.Tensor
    tex_v1: torch.Tensor
    tex_v2: torch.Tensor
    tex_uvscale: torch.Tensor
    tex_f1: torch.Tensor
    tex_f2: torch.Tensor
    tex_img_off: torch.Tensor
    tex_img_w: torch.Tensor
    tex_img_h: torch.Tensor
    tex_atlas: torch.Tensor       # (X,3) every image's MIP pyramid, ptex faces
    tex_mip_off: torch.Tensor     # (T,16) per-level atlas offsets
    tex_mips: torch.Tensor        # (T,) level counts
    tex_w2t: torch.Tensor         # (T,4,4) world->texture (3D checkerboard)
    tex_ptex_off: torch.Tensor    # (F,) atlas offset per ptex face
    tex_ptex_w: torch.Tensor
    tex_ptex_h: torch.Tensor
    mat_kd_tex: torch.Tensor      # (M,) i32 texture row of Kd, -1 = constant
    mat_ks_tex: torch.Tensor
    # environment map (equirect) and its Distribution2D tables, built on the
    # host from the uploaded map and not differentiated
    env_map: torch.Tensor         # (H*W,3) flat radiance (1 texel if none)
    env_w2l: torch.Tensor         # (3,3)
    env_cond_func: torch.Tensor   # (H,W)
    env_cond_cdf: torch.Tensor    # (H,W+1)
    env_cond_integral: torch.Tensor
    env_marg_func: torch.Tensor
    env_marg_cdf: torch.Tensor
    env_marg_integral: torch.Tensor
    # camera
    cam_to_world: torch.Tensor
    raster_to_camera: torch.Tensor
    cam_q: torch.Tensor           # (2,4) animated camera's rotation keys
    cam_tr: torch.Tensor          # (2,3) and translation keys
    # world bounds
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    # per-interface media (media/media.py MediaTable; one-row dummies in a
    # scene without media)
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
    # the shared Fourier BSDF table (materials/fourier.py; one-row dummies
    # when the scene has none); its sizes are SceneStatics.fourier
    four_mu: torch.Tensor         # (n_mu,) knots
    four_a: torch.Tensor          # (n_coeffs,) coefficient runs
    four_m: torch.Tensor          # (n_mu*n_mu,) i32 run lengths
    four_aoff: torch.Tensor       # (n_mu*n_mu,) i32 run offsets
    four_cdf: torch.Tensor        # (n_mu*n_mu,) marginal cdf (sampling)
    # tabulated beam-diffusion BSSRDF (bssrdf.cpp:145): per-material row
    # [sigma_t(3) | rho_eff(3) | profile 3x64 | inverse-cdf 3x64] over the
    # shared unitless radius grid (materials/bssrdf_table.py); a one-row
    # dummy when SceneStatics.has_bssrdf_table is False
    sss_pack: torch.Tensor        # (M, 390) f32


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
    # the material families of the scene among "disney", "hair", "mix",
    # "sss" and "fourier": only those are computed (materials/bsdf.py)
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
    # kd / RBSP / BSP tree: 0 levels = no such tables
    alt_max_leaf: int = 0
    alt_tree_depth: int = 0
    # (Kd, Ks) texture types the materials refer to (textures.
    # present_types): the only ones eval_texture computes
    tex_types: tuple = (frozenset(), frozenset())
    # the Fourier table's static sizes (m_max, n_mu, n_channels, eta), or
    # None without one
    fourier: object = None
    # tabulated beam-diffusion BSSRDF rows present (sss_pack)
    has_bssrdf_table: bool = False
    # the families of the rows that mix rows name as children
    # (mix_child_features): the only ones computed for the children (a
    # port-only static; from_numpy derives it from the carried tables)
    mix_features: frozenset = frozenset()


# floats of a prim row's motion deltas on the device (the JAX package: 9)
DT_WIDTH = 12


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


def pack_prim_row_deltas(scene: FlatScene, prim_ids: np.ndarray) -> np.ndarray:
    """Leaf-order vertex motion deltas matching pack_prim_rows: (P,
    DT_WIDTH) with triangle dp0 dp1 dp2 in cols 0-8 (zeros for quadrics,
    static prims and the pad), read beside prim_rows when st.has_motion so
    that the wide traversal lerps vertices at the ray's shutter time."""
    t = scene.triangles
    prim_ids = np.asarray(prim_ids, np.int64)
    n = len(prim_ids)
    rows = np.zeros((max(n, 1), DT_WIDTH), np.float32)
    tri_mask = prim_ids < t.count
    tid = prim_ids[tri_mask]
    if tid.size and t.dp0 is not None:
        rows[tri_mask, 0:3] = t.dp0[tid]
        rows[tri_mask, 3:6] = t.dp1[tid]
        rows[tri_mask, 6:9] = t.dp2[tid]
    return rows


def camera_keys(cam):
    """(cam_q (2,4), cam_tr (2,3)) float32 of an animated camera: the
    rotation quaternions [w,x,y,z] (the second taken on the first's
    hemisphere) and translations of its shutter-open and shutter-close
    camera-to-world; identity keys when the camera does not move."""
    if cam.cam_to_world_end is None:
        return (np.array([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32),
                np.zeros((2, 3), np.float32))
    from tpupt_torch.core.transforms import decompose

    t0_, q0_, _ = decompose(np.asarray(cam.cam_to_world, np.float64))
    t1_, q1_, _ = decompose(np.asarray(cam.cam_to_world_end, np.float64))
    if np.dot(q0_, q1_) < 0.0:
        q1_ = -q1_
    return (np.stack([q0_, q1_]).astype(np.float32),
            np.stack([t0_, t1_]).astype(np.float32))


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


def _no_alt_fields() -> dict:
    """The alt_* fields of a scene without a kd / RBSP / BSP tree."""
    return dict(alt_prim_rows=np.zeros((1, 32), np.float32),
                alt_nodes=np.zeros((1, 8), np.float32))


def host_tables(scene: FlatScene, bvh: BVHArrays = None,
                light_strategy: str = "uniform", two_level: bool = None,
                treelet_budget: tuple = None, spectral: bool = False):
    """(fields: dict of numpy arrays, SceneStatics) for a flattened scene,
    before anything touches a device. two_level forces the two-level tables
    on or off (default: built from TWO_LEVEL_MIN_BYTES of node + prim rows);
    treelet_budget=(tn, tp) overrides the treelet capacities (tests cut small
    scenes into many treelets with it); spectral=True sets n_channels to 60
    (the path and volpath integrators then carry 60-bin sampled spectra)."""
    t, s, m, lt = scene.triangles, scene.spheres, scene.materials, scene.lights
    if bvh is None:
        with tlog.annotate("upload.bvh"):
            bvh = build_scene_bvh(scene)
    wlo, whi = scene.world_bounds()
    wide_nodes, _ = collapse_to_wide(bvh)
    prim_rows = pack_prim_rows(scene, bvh.prim_ids)
    has_motion = t.has_motion
    prim_rows_dt = (pack_prim_row_deltas(scene, bvh.prim_ids) if has_motion
                    else np.zeros((1, DT_WIDTH), np.float32))
    cam_q, cam_tr = camera_keys(scene.camera)
    if two_level is None:
        two_level = (wide_nodes.nbytes + prim_rows.nbytes
                     >= TWO_LEVEL_MIN_BYTES)
    tla = None
    if two_level:
        # fatter leaves under treelets, as the JAX package collapses them
        wide_nodes, _ = collapse_to_wide(bvh, leaf_merge=8)
        tn, tp = treelet_budget or (TREELET_NODES, TREELET_PRIMS)
        with tlog.annotate("upload.treelets"):
            tla = build_treelets(wide_nodes, prim_rows, tn, tp)

    # the per-interface media table (one-row dummies without media) and
    # each prim's MediumInterface in global prim order
    n_prims = scene.prim_count
    med_in = np.full(max(n_prims, 1), -1, np.int32)
    med_out = np.full(max(n_prims, 1), -1, np.int32)
    for lo, hi, shapes in ((0, t.count, t), (t.count, n_prims, s)):
        if hi > lo and shapes.med_in is not None:
            med_in[lo:hi] = shapes.med_in
            med_out[lo:hi] = shapes.med_out
    media, any_grid = build_media_table(scene)

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
        wide_nodes=wide_nodes, prim_rows=prim_rows, prim_rows_dt=prim_rows_dt,
        **{f"tri_dp{k}": (_pad1(getattr(t, f"dp{k}")) if has_motion
                          else np.zeros((1, 3), np.float32)) for k in range(3)},
        **_two_level_fields(tla), **_no_alt_fields(),
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
        light_w2l=_pad1(lt.w2l.reshape(-1, 9)).reshape(-1, 3, 3),
        light_img_off=_pad1(lt.img_off, -1), light_img_w=_pad1(lt.img_w),
        light_img_h=_pad1(lt.img_h), light_img=lt.img,
        **texture_fields(scene.textures, m), **env_fields(scene),
        cam_to_world=scene.camera.cam_to_world,
        raster_to_camera=scene.camera.raster_to_camera,
        cam_q=cam_q, cam_tr=cam_tr,
        world_lo=wlo, world_hi=whi,
        **(media or dict(
            med_sigma_a=np.zeros((1, 3), f32),
            med_sigma_s=np.zeros((1, 3), f32), med_g=np.zeros(1, f32),
            med_majorant=np.ones(1, f32), med_is_grid=np.zeros(1, bool),
            med_density=np.ones(1, f32), med_dens_off=np.zeros(1, i32),
            med_dens_dims=np.ones((1, 3), i32), med_w2m=eye.copy())),
        prim_med_in=med_in, prim_med_out=med_out,
        **fourier_fields(scene.fourier_table),
    )
    sss_pack = sss_pack_rows(m)
    fields["sss_pack"] = (sss_pack if sss_pack is not None
                          else np.zeros((1, 390), f32))
    ft = scene.fourier_table
    # wide-leaf prim counts (leaf-merged fat leaves; collapse_to_wide)
    metas = wide_nodes[:, 48:56].view(np.int32)
    leaf_metas = metas[(metas < 0) & (metas != -2**31)]
    wide_max_leaf = (int(((-leaf_metas - 1) & 63).max())
                     if leaf_metas.size else 1)
    cam = scene.camera
    env_h, env_w = ((scene.env_map.shape[0], scene.env_map.shape[1])
                    if scene.env_map is not None else (0, 0))
    statics = SceneStatics(
        n_tris=t.count, n_spheres=s.count, n_lights=n_lights,
        max_leaf=max(wide_max_leaf, 1), n_nodes=bvh.n_nodes,
        n_wide_nodes=len(wide_nodes),
        env_w=env_w, env_h=env_h, env_light_id=scene.env_light_id,
        has_textures=bool((m.kd_tex >= 0).any() or (m.ks_tex >= 0).any()),
        has_light_imgs=bool((lt.img_off >= 0).any()),
        tex_types=present_types(fields["tex_type"], m.kd_tex, m.ks_tex),
        mat_features=material_features(m.type),
        mix_features=mix_child_features(m.type, m.extra),
        fourier=(dict(m_max=ft["m_max"], n_mu=ft["n_mu"],
                      n_channels=ft["n_channels"], eta=ft["eta"])
                 if ft else None),
        has_bssrdf_table=sss_pack is not None,
        spatial_lights=light_grid_cdf.shape[0] > 1,
        n_media=len(scene.media_order or []),
        camera_medium=scene.camera_medium,
        any_grid_media=any_grid,
        has_med_interfaces=bool((med_in != med_out).any()),
        n_channels=60 if spectral else 3,
        has_motion=bool(has_motion),
        cam_animated=cam.cam_to_world_end is not None,
        shutter_open=float(cam.shutter_open),
        shutter_close=float(cam.shutter_close),
        two_level=bool(two_level),
        n_treelets=tla.n_treelets if tla else 0,
        tl_tn=tla.tn if tla else 0, tl_tp=tla.tp if tla else 0)
    return fields, statics


def material_features(mat_type) -> frozenset:
    """The material families present among the rows' types (the static
    SceneStatics.mat_features), as the JAX package names them."""
    from tpupt_torch.scene.flatten import (MAT_DISNEY, MAT_FOURIER,
                                           MAT_HAIR, MAT_KDSUBSURFACE,
                                           MAT_MIX, MAT_SUBSURFACE)

    mat_type = np.asarray(mat_type)
    return frozenset(
        name for name, tid in (("disney", MAT_DISNEY), ("hair", MAT_HAIR),
                               ("mix", MAT_MIX), ("sss", MAT_SUBSURFACE),
                               ("sss", MAT_KDSUBSURFACE),
                               ("fourier", MAT_FOURIER))
        if (mat_type == tid).any())


def mix_child_features(mat_type, mat_extra) -> frozenset:
    """The material families of the rows that the mix rows name as their
    two children (extra[1:3])."""
    from tpupt_torch.scene.flatten import MAT_MIX

    mat_type = np.asarray(mat_type)
    mix = mat_type == MAT_MIX
    if not mix.any():
        return frozenset()
    children = np.asarray(mat_extra)[mix][:, 1:3].astype(np.int64).ravel()
    return material_features(mat_type[children]) - {"mix"}


def fourier_fields(ft) -> dict:
    """The four_* fields from a FlatScene's Fourier table (one-row dummies
    without one)."""
    if not ft:
        return dict(four_mu=np.zeros(1, np.float32),
                    four_a=np.zeros(1, np.float32),
                    four_m=np.zeros(1, np.int32),
                    four_aoff=np.zeros(1, np.int32),
                    four_cdf=np.zeros(1, np.float32))
    return dict(four_mu=ft["mu"], four_a=ft["a"], four_m=ft["m"],
                four_aoff=ft["aoffset"],
                four_cdf=ft.get("cdf", np.zeros(1, np.float32)))


def sss_pack_rows(m):
    """Per-material tabulated-BSSRDF rows, or None when the scene has no
    subsurface materials. Row layout (390 f32): sigma_t (3) | rho_eff (3) |
    per-channel profile P_c over the shared 64-point optical radius grid
    (3x64) | per-channel inverse radial cdf r_opt(u) at 64 uniform u nodes
    (3x64). P_c = 2 pi r_opt Sr_1(r_opt) at sigma_t = 1
    (ComputeBeamDiffusionBSSRDF; materials/bssrdf_table.py)."""
    from tpupt_torch.materials.bssrdf_table import \
        compute_beam_diffusion_table
    from tpupt_torch.scene.flatten import MAT_KDSUBSURFACE, MAT_SUBSURFACE

    is_sss = (m.type == MAT_SUBSURFACE) | (m.type == MAT_KDSUBSURFACE)
    if not is_sss.any():
        return None
    pack = np.zeros((len(m.type), 390), np.float32)
    u_nodes = np.linspace(0.0, 1.0, 64)
    for mi in np.nonzero(is_sss)[0]:
        tab = compute_beam_diffusion_table(float(m.eta[mi, 0]))
        sig_t = np.maximum(m.extra[mi, 3:6], 1e-6)
        alpha = np.clip(m.extra[mi, 6:9], 0.0, float(tab.rho[-1]))
        pack[mi, 0:3] = sig_t
        pack[mi, 3:6] = np.interp(alpha, tab.rho, tab.rho_eff)
        for c in range(3):
            # interpolate the profile / cdf rows to this channel's albedo
            k = np.clip(np.searchsorted(tab.rho, alpha[c]), 1,
                        len(tab.rho) - 1)
            w = ((alpha[c] - tab.rho[k - 1])
                 / max(tab.rho[k] - tab.rho[k - 1], 1e-12))
            prof = (1 - w) * tab.profile[k - 1] + w * tab.profile[k]
            cdf = np.maximum.accumulate(
                (1 - w) * tab.cdf[k - 1] + w * tab.cdf[k])
            pack[mi, 6 + 64 * c: 6 + 64 * (c + 1)] = prof
            # piecewise-linear inverse cdf at uniform u nodes
            pack[mi, 198 + 64 * c: 198 + 64 * (c + 1)] = np.interp(
                u_nodes, cdf, tab.radius)
    return pack


def texture_fields(textures, m) -> dict:
    """The tex_* and mat_*_tex fields from a FlatScene's texture tables
    (one-row dummies for each table a scene without textures lacks)."""
    tx = textures or {}
    defaults = dict(
        tex_type=np.zeros(1, np.int32),
        tex_v1=np.full((1, 3), 0.5, np.float32),
        tex_v2=np.zeros((1, 3), np.float32),
        tex_uvscale=np.ones((1, 2), np.float32),
        tex_f1=np.zeros(1, np.float32), tex_f2=np.zeros(1, np.float32),
        tex_img_off=np.zeros(1, np.int32), tex_img_w=np.zeros(1, np.int32),
        tex_img_h=np.zeros(1, np.int32),
        tex_mip_off=np.zeros((1, 16), np.int32),
        tex_mips=np.ones(1, np.int32),
        tex_atlas=np.full((1, 3), 0.5, np.float32),
        tex_w2t=np.eye(4, dtype=np.float32)[None],
        tex_ptex_off=np.zeros(1, np.int32),
        tex_ptex_w=np.ones(1, np.int32),
        tex_ptex_h=np.ones(1, np.int32))
    out = {k: tx.get(k, v) for k, v in defaults.items()}
    out["mat_kd_tex"] = m.kd_tex
    out["mat_ks_tex"] = m.ks_tex
    return out


def env_fields(scene: FlatScene) -> dict:
    """The env_* fields: the flat map and its Distribution2D tables over
    luminance * sin(theta) (lights/infinite.cpp:65), built here once."""
    if scene.env_map is None:
        z = np.zeros(1, np.float32)
        return dict(env_map=np.zeros((1, 3), np.float32),
                    env_w2l=np.eye(3, dtype=np.float32),
                    env_cond_func=np.zeros((1, 1), np.float32),
                    env_cond_cdf=np.zeros((1, 2), np.float32),
                    env_cond_integral=z, env_marg_func=z,
                    env_marg_cdf=np.zeros(2, np.float32),
                    env_marg_integral=np.zeros((), np.float32))
    img = scene.env_map
    h, _ = img.shape[:2]
    lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    theta = (np.arange(h) + 0.5) / h * np.pi
    func = lum * np.sin(theta)[:, None]
    (cond_func, cond_cdf, cond_integral, marg_func, marg_cdf,
     marg_integral) = build_distribution2d(func)
    return dict(
        env_map=img.reshape(-1, 3),
        env_w2l=(scene.env_w2l if scene.env_w2l is not None
                 else np.eye(3, dtype=np.float32)),
        env_cond_func=cond_func, env_cond_cdf=cond_cdf,
        env_cond_integral=cond_integral, env_marg_func=marg_func,
        env_marg_cdf=marg_cdf, env_marg_integral=marg_integral)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    a = np.ascontiguousarray(a) if a.ndim else a  # keeps a 0-d table 0-d
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _to_device(fields: dict, device) -> DeviceScene:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return DeviceScene(**{name: _tensor(fields[name], device)
                          for name in DeviceScene._fields})


def upload(scene: FlatScene, bvh: BVHArrays = None,
           light_strategy: str = "uniform", device="cuda",
           two_level: bool = None, treelet_budget: tuple = None,
           spectral: bool = False):
    """Build (DeviceScene, SceneStatics) from a flattened scene on `device`.
    With device="cuda" and no card this raises; it never drops to the CPU.
    two_level / treelet_budget / spectral: see `host_tables`. Spans:
    `upload.tables` (`host_tables`, holding `upload.bvh` and
    `upload.treelets`: its own time is the rest) and `upload.copy`."""
    with tlog.annotate("upload.tables"):
        fields, statics = host_tables(scene, bvh, light_strategy, two_level,
                                      treelet_budget, spectral)
    with tlog.annotate("upload.copy"):
        return _to_device(fields, device), statics


def with_alt_accel(ds: DeviceScene, st: SceneStatics, nodes: dict, dirs):
    """(ds, st) with the kd / RBSP / BSP tree `nodes`, `dirs` of
    accel/kdbsp.py `build_alt_accel` (of this package or, as numpy arrays, of
    the JAX package) in the alt_* tables, on the device `ds` lies on."""
    from tpupt_torch.accel.kdbsp import alt_tables

    fields, statics = alt_tables(nodes, dirs)
    dev = ds.world_lo.device
    return (ds._replace(**{k: _tensor(v, dev) for k, v in fields.items()}),
            st._replace(**statics))


def from_numpy(ds_fields: dict, st_fields: dict, device="cuda"):
    """(DeviceScene, SceneStatics) from the JAX package's tables: every
    field of its DeviceScene as a numpy array and of its SceneStatics as a
    Python value. Fields only its TPU kernels read are dropped; its padded
    two-level tables are not read either: the treelets are cut again from
    the carried `wide_nodes` and `prim_rows` with the carried capacities,
    which gives the same treelets in this package's layout. Its kd / RBSP /
    BSP tables (alt_flags ... alt_dirs, where its Renderer built them) are
    carried as the node rows packed from them and the prim rows. Its motion
    deltas `prim_rows_dt` (P,9) are padded to DT_WIDTH columns. Spectral
    transport (n_channels) and the media tables and statics come across as
    they are."""
    statics = SceneStatics(**{k: st_fields[k] for k in SceneStatics._fields
                              if k in st_fields})
    statics = statics._replace(
        tex_types=present_types(ds_fields["tex_type"],
                                ds_fields["mat_kd_tex"],
                                ds_fields["mat_ks_tex"]),
        mix_features=mix_child_features(ds_fields["mat_type"],
                                        ds_fields["mat_extra"]))
    if ds_fields.get("sss_pack") is None:
        ds_fields = {**ds_fields, "sss_pack": np.zeros((1, 390), np.float32)}
    dt = np.asarray(ds_fields["prim_rows_dt"], np.float32)
    ds_fields = {**ds_fields, "prim_rows_dt": np.pad(
        dt, ((0, 0), (0, DT_WIDTH - dt.shape[1])))}
    tla = None
    if statics.two_level:
        tla = build_treelets(np.asarray(ds_fields["wide_nodes"]),
                             np.asarray(ds_fields["prim_rows"]),
                             statics.tl_tn, statics.tl_tp)
    alt_fields = _no_alt_fields()
    if ds_fields.get("alt_flags") is not None:
        from tpupt_torch.accel.kdbsp import alt_tables

        nodes = {k: ds_fields["alt_" + k] for k in
                 ("flags", "split", "above", "nprims", "prim_rows", "ndir")
                 if ds_fields.get("alt_" + k) is not None}
        alt_fields, alt_statics = alt_tables(nodes, ds_fields["alt_dirs"])
        statics = statics._replace(**alt_statics)
    return _to_device({**ds_fields, **_two_level_fields(tla), **alt_fields},
                      device), statics
