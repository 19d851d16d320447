"""Texture evaluation on flat tables (counterpart of src/textures/ and
core/texture.* / mipmap.h).

Host side: `TextureTable.build` resolves the scene's named-texture DAG into
  * a flat texel atlas (all image maps and their MIP pyramids, and every
    ptex face, concatenated into one (X, 3) array; per-level offsets in an
    int table), and
  * a parameter table per texture row (type id, constant values, nested
    refs resolved one level deep, uv scaling, noise parameters).
Device side: `eval_texture` computes a texture row per lane of a hit batch.
Procedural noise is a hash-based Perlin (core/texture.cpp Noise's
permutation table replaced by PCG gradient hashing, core/rng.py), image
maps are bilinear gathers from the atlas at a MIP level picked from the
ray-cone footprint, trilinear between two levels, with an optional 4-tap
line filter along the footprint's major axis (mipmap.h EWA with a fixed
tap count).

Only the texture types named in `types` are computed: a scene's set is
known on the host (`present_types`), and in eager PyTorch every type costs
its launches whether or not a lane uses it (about 30 Perlin evaluations of
8 hashed corners a lookup if all were computed).

Every float gather of a table (atlas, parameter rows) is an `index_select`,
whose backward adds the cotangents of repeated rows with atomics."""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpupt_torch.core.rng import uniform_float, uniform_u32

(TEX_CONSTANT, TEX_SCALE, TEX_MIX, TEX_CHECKER, TEX_UV, TEX_IMAGEMAP,
 TEX_FBM, TEX_WRINKLED, TEX_MARBLE, TEX_WINDY, TEX_DOTS,
 TEX_BILERP, TEX_CHECKER3D, TEX_PTEX) = range(14)
ALL_TYPES = frozenset(range(14))

_TEX_IDS = {"constant": TEX_CONSTANT, "scale": TEX_SCALE, "mix": TEX_MIX,
            "checkerboard": TEX_CHECKER, "uv": TEX_UV, "imagemap": TEX_IMAGEMAP,
            "fbm": TEX_FBM, "wrinkled": TEX_WRINKLED, "marble": TEX_MARBLE,
            "windy": TEX_WINDY, "dots": TEX_DOTS, "bilerp": TEX_BILERP,
            "ptex": TEX_PTEX}

# the fields of DeviceScene that `eval_texture` reads, by their names there
TEX_FIELDS = ("tex_type", "tex_v1", "tex_v2", "tex_uvscale", "tex_f1",
              "tex_f2", "tex_img_off", "tex_img_w", "tex_img_h",
              "tex_mip_off", "tex_mips", "tex_atlas", "tex_w2t",
              "tex_ptex_off", "tex_ptex_w", "tex_ptex_h")
MAX_MIP = 16


class TextureTable:
    """Flat texture tables + name -> row id map."""

    def __init__(self):
        self.type: List[int] = []
        self.v1: List[np.ndarray] = []   # (3,) main value / tex1 constant
        self.v2: List[np.ndarray] = []   # (3,) secondary / tex2 constant
        self.uvscale: List[Tuple[float, float]] = []
        self.f1: List[float] = []        # octaves / omega / variation
        self.f2: List[float] = []
        self.img_off: List[int] = []     # atlas offset (level 0)
        self.img_w: List[int] = []
        self.img_h: List[int] = []
        self.atlas: List[np.ndarray] = []
        self.atlas_len = 0
        self.mip_off: List[np.ndarray] = []   # (MAX_MIP,) atlas offsets
        self.mips: List[int] = []
        self.w2t: List[np.ndarray] = []       # (4,4) world->texture (3D tex)
        # global per-face tables for ptex rows (textures/ptex.py): a ptex
        # row's img_off = first face index here, img_w = its face count
        self.ptex_off: List[int] = []
        self.ptex_w: List[int] = []
        self.ptex_h: List[int] = []
        self.name_to_id: Dict[str, int] = {}

    @staticmethod
    def build(textures: Dict, scene_dir: str) -> "TextureTable":
        t = TextureTable()
        for name, td in textures.items():
            t._add(name, td, textures, scene_dir)
        return t

    def _resolve_const(self, pname, params, textures, default):
        ref = params.find_texture(pname)
        if ref is not None and ref in textures:
            td = textures[ref]
            if td.klass == "constant":
                return np.asarray(
                    td.params.find_one_spectrum("value", default), np.float64)
            warnings.warn(f"nested non-constant texture {ref!r} folded to mean")
        return params.find_one_spectrum(pname, default)

    def _add_image(self, row, img):
        """Level 0 and its box-filtered halvings down to 1x1, back to back
        in the atlas (MIPMap ctor, mipmap.h)."""
        row["off"] = self.atlas_len
        row["w"] = img.shape[1]
        row["h"] = img.shape[0]
        lvl = img.astype(np.float32)
        offs = []
        while True:
            offs.append(self.atlas_len)
            flat = lvl.reshape(-1, 3).astype(np.float32)
            self.atlas.append(flat)
            self.atlas_len += len(flat)
            h_, w_ = lvl.shape[:2]
            if w_ <= 1 and h_ <= 1:
                break
            w2, h2 = max(w_ // 2, 1), max(h_ // 2, 1)
            sy = 2 if h_ > 1 else 1
            sx = 2 if w_ > 1 else 1
            lvl = lvl[: h2 * sy, : w2 * sx].reshape(
                h2, sy, w2, sx, 3).mean((1, 3))
        row["mip_off"] = offs
        row["mips"] = len(offs)

    def _add_ptex(self, row, path, fn, gamma):
        faces = None
        if os.path.isfile(path):
            from tpupt_torch.textures.ptex import read_ptex
            try:
                faces, _mesh = read_ptex(path)
            except Exception as e:
                warnings.warn(f"ptex {fn!r} unreadable ({e}); gray")
        else:
            warnings.warn(f"ptex {fn!r} not found; gray")
        if not faces:
            row["type"] = TEX_CONSTANT
            return
        row["off"] = len(self.ptex_off)  # first face index
        row["w"] = len(faces)            # face count
        for f in faces:
            f = np.asarray(f, np.float32)
            if f.shape[-1] == 1:
                f = np.repeat(f, 3, -1)
            # gamma decode at load (ptex.cpp:159 applies pow(gamma) to
            # in-gamut results; per texel at load is the same computation
            # hoisted out of the lookup)
            if gamma != 1.0:
                f = np.where((f >= 0) & (f <= 1), f ** np.float32(gamma), f)
            self.ptex_off.append(self.atlas_len)
            self.ptex_h.append(f.shape[0])
            self.ptex_w.append(f.shape[1])
            self.atlas.append(f[..., :3].reshape(-1, 3))
            self.atlas_len += f.shape[0] * f.shape[1]

    def _add(self, name, td, textures, scene_dir):
        p = td.params
        ttype = _TEX_IDS.get(td.klass)
        if ttype is None:
            warnings.warn(f"texture class {td.klass!r} unsupported; constant 0.5")
            ttype = TEX_CONSTANT
        row = dict(type=ttype, v1=np.array([0.5] * 3), v2=np.zeros(3),
                   uvscale=(p.find_one_float("uscale", 1.0),
                            p.find_one_float("vscale", 1.0)),
                   f1=0.0, f2=0.0, off=0, w=0, h=0)
        if ttype == TEX_CONSTANT:
            row["v1"] = p.find_one_spectrum("value", [1, 1, 1])
        elif ttype in (TEX_SCALE, TEX_MIX, TEX_CHECKER, TEX_DOTS, TEX_BILERP):
            d1 = [1, 1, 1] if ttype != TEX_MIX else [0, 0, 0]
            row["v1"] = self._resolve_const("tex1", p, textures, d1)
            row["v2"] = self._resolve_const("tex2", p, textures, [1, 1, 1]
                                            if ttype != TEX_CHECKER else [0, 0, 0])
            if ttype == TEX_MIX:
                row["f1"] = p.find_one_float("amount", 0.5)
            if ttype == TEX_CHECKER:
                # dimension 3 -> solid checkerboard over texture space
                # (Checkerboard3DTexture, checkerboard.h:250); 2D carries the
                # closed-form box-filter AA flag (checkerboard.h:108
                # AAMethod::ClosedForm, the pbrt default)
                if p.find_one_int("dimension", 2) == 3:
                    row["type"] = TEX_CHECKER3D
                else:
                    row["f1"] = float(
                        p.find_one_string("aamode", "closedform")
                        == "closedform")
        elif ttype == TEX_IMAGEMAP:
            fn = p.find_one_string("filename", "")
            path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
            img = load_image(path)
            if img is None:
                warnings.warn(f"imagemap {fn!r} not found; gray")
                row["type"] = TEX_CONSTANT
            else:
                self._add_image(row, img * p.find_one_float("scale", 1.0))
        elif ttype == TEX_PTEX:
            fn = p.find_one_string("filename", "")
            path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
            self._add_ptex(row, path, fn, p.find_one_float("gamma", 2.2))
        elif ttype in (TEX_FBM, TEX_WRINKLED):
            row["f1"] = float(p.find_one_int("octaves", 8))
            row["f2"] = p.find_one_float("roughness", 0.5)
        elif ttype == TEX_MARBLE:
            row["f1"] = float(p.find_one_int("octaves", 8))
            row["f2"] = p.find_one_float("scale", 1.0)
        self.name_to_id[name] = len(self.type)
        w2t = np.eye(4, dtype=np.float64)
        if getattr(td, "tex2world", None) is not None:
            try:
                w2t = td.tex2world.m_inv
            except Exception:
                pass
        self.w2t.append(np.asarray(w2t, np.float64))
        self.type.append(row["type"])
        self.v1.append(np.asarray(row["v1"], np.float64))
        self.v2.append(np.asarray(row["v2"], np.float64))
        self.uvscale.append(row["uvscale"])
        self.f1.append(row["f1"])
        self.f2.append(row["f2"])
        self.img_off.append(row["off"])
        self.img_w.append(row["w"])
        self.img_h.append(row["h"])
        mo = np.full(MAX_MIP, row["off"], np.int64)
        offs = row.get("mip_off", [])
        mo[: min(len(offs), MAX_MIP)] = offs[:MAX_MIP]
        if offs:
            mo[len(offs):] = offs[-1]  # clamp to the 1x1 level
        self.mip_off.append(mo)
        self.mips.append(row.get("mips", 1))

    def arrays(self):
        atlas = (np.concatenate(self.atlas) if self.atlas
                 else np.ones((1, 3), np.float32) * 0.5)
        return dict(
            tex_type=np.asarray(self.type or [0], np.int32),
            tex_v1=np.asarray(self.v1 or [[0.5] * 3], np.float32),
            tex_v2=np.asarray(self.v2 or [[0.0] * 3], np.float32),
            tex_uvscale=np.asarray(self.uvscale or [(1.0, 1.0)], np.float32),
            tex_f1=np.asarray(self.f1 or [0.0], np.float32),
            tex_f2=np.asarray(self.f2 or [0.0], np.float32),
            tex_img_off=np.asarray(self.img_off or [0], np.int32),
            tex_img_w=np.asarray(self.img_w or [0], np.int32),
            tex_img_h=np.asarray(self.img_h or [0], np.int32),
            tex_mip_off=(np.stack(self.mip_off).astype(np.int32)
                         if self.mip_off
                         else np.zeros((1, MAX_MIP), np.int32)),
            tex_mips=np.asarray(self.mips or [1], np.int32),
            tex_atlas=atlas,
            tex_w2t=(np.stack(self.w2t).astype(np.float32) if self.w2t
                     else np.eye(4, dtype=np.float32)[None]),
            tex_ptex_off=np.asarray(self.ptex_off or [0], np.int32),
            tex_ptex_w=np.asarray(self.ptex_w or [1], np.int32),
            tex_ptex_h=np.asarray(self.ptex_h or [1], np.int32),
        )


def load_image(path):
    """(H, W, 3) float32 image, or None: EXR and PFM read here, PNG / TGA /
    JPEG through PIL (imported only then). A missing file is looked for
    under the other extensions."""
    from tpupt_torch.utils import imageio as io

    if not os.path.isfile(path):
        base = os.path.splitext(path)[0]
        for ext in (".png", ".tga", ".exr", ".pfm"):
            if os.path.isfile(base + ext):
                path = base + ext
                break
        else:
            return None
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".exr":
            return io.read_exr(path)
        if ext == ".pfm":
            return io.read_pfm(path)
        return io.read_png(path)
    except Exception as e:
        warnings.warn(f"failed to load {path}: {e}")
        return None


def present_types(tex_type, kd_tex, ks_tex) -> tuple:
    """(types of the Kd textures, types of the Ks textures) the materials
    refer to (numpy tables): the static sets `eval_texture` computes."""
    tex_type = np.asarray(tex_type)

    def types(ids):
        ids = np.asarray(ids).ravel()
        ids = ids[(ids >= 0) & (ids < len(tex_type))]
        return frozenset(int(x) for x in np.unique(tex_type[ids]))
    return types(kd_tex), types(ks_tex)


# ------------------------------ perlin noise --------------------------------


def _gradient(h, fx, fy, fz):
    """12-direction gradient dot product (texture.cpp Grad)."""
    h = h & 15
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return (torch.where((h & 1) != 0, -u, u)
            + torch.where((h & 2) != 0, -v, v))


# the 8 lattice corners of a cell, in the order their terms are summed
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def perlin(p):
    """3D gradient noise in [-1,1] (core/texture.cpp Noise; permutation
    table replaced by hashing) of points p (..., 3). Lattice coordinates
    are hashed as uint32: a negative one wraps (as_u32 masks it to 32
    bits). The 8 corners are computed as one stacked tensor, one launch an
    operation, and summed in the reference order."""
    pi = torch.floor(p)
    pf = p - pi
    off = torch.tensor(_CORNERS, device=p.device).view(
        (8,) + (1,) * (p.dim() - 1) + (3,))
    key = pi.to(torch.int64).unsqueeze(0) + off
    h = uniform_u32(key[..., 0], key[..., 1], key[..., 2])
    f = pf.unsqueeze(0) - off.to(p.dtype)
    g = _gradient(h, f[..., 0], f[..., 1], f[..., 2])
    # quintic smoothstep (NoiseWeight); a corner weighs w or 1 - w an axis
    w = (pf * pf * pf * (pf * (pf * 6 - 15) + 10)).unsqueeze(0)
    wsel = torch.where(off != 0, w, 1 - w)
    vals = g * (wsel[..., 0] * wsel[..., 1] * wsel[..., 2])
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def _octaves(p, octaves: int):
    """perlin(p * lambda) for each octave's lambda = 1.99^k, all octaves as
    one stacked call: (octaves, ...)."""
    lams, lam = [], 1.0
    for _ in range(octaves):
        lams.append(lam)
        lam *= 1.99
    lam_t = torch.tensor(lams, dtype=p.dtype, device=p.device).view(
        (octaves,) + (1,) * p.dim())
    return perlin(p.unsqueeze(0) * lam_t)


def fbm(p, omega, octaves: int):
    """texture.cpp FBm (without the ray-differential octave clamp)."""
    s, o = 0.0, 1.0
    for n in _octaves(p, octaves):
        s = s + o * n
        o *= omega
    return s


def abs_tie_up(x):
    """|x| whose derivative at x = 0 is +1, as jnp.abs's is (torch.abs's
    is 0 there). Noise is exactly 0 on the lattice lines of its cells (a
    hit with two coordinates 0 meets them in every octave), so the tie
    rule decides the gradient of turbulence there."""
    return torch.where(x >= 0, x, -x)


def turbulence(p, omega, octaves: int):
    s, o = 0.0, 1.0
    for n in _octaves(p, octaves):
        s = s + o * abs_tie_up(n)
        o *= omega
    return s


# ------------------------------ evaluation ----------------------------------


def rows(table, idx):
    """table[idx] for a float table and an index tensor of any shape:
    index_select, whose backward adds the cotangents of repeated rows with
    atomics (indexing's sorts them)."""
    return torch.index_select(table, 0, idx.reshape(-1).long()).reshape(
        idx.shape + table.shape[1:])


def bilinear(fx, fy, texel):
    """Bilinear fetch at continuous texel coordinates (fx, fy) (..., N):
    `texel(xi, yi)` gathers the rows of integer corners, here of all four
    at once ((4, ..., N) coordinates, one gather), summed in the reference
    order. Returns (..., N, 3)."""
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    t = texel(torch.stack([x0, x0 + 1, x0, x0 + 1]),
              torch.stack([y0, y0, y0 + 1, y0 + 1]))
    return ((1 - ax) * (1 - ay) * t[0] + ax * (1 - ay) * t[1]
            + (1 - ax) * ay * t[2] + ax * ay * t[3])


# anisotropic line filter: 4 Gaussian taps (offset along the major axis,
# weight) over the footprint's full major diameter
_ANISO_TAPS = ((-0.375, 0.274), (-0.125, 0.323), (0.125, 0.323),
               (0.375, 0.274))


def _imagemap(tx, tex_id, uv, us, u, v, width, aniso):
    """Trilinear fetch from the MIP pyramid (MIPMap::Lookup, mipmap.h:
    bilinear at the two bracketing levels, lerped), with `aniso` the 4-tap
    line filter along the uv major axis, each tap at the minor axis's
    level; level 0 alone without a `width`. Taps, levels and corners are
    stacked into one gather of the atlas (lanes last)."""
    w_img = tx["tex_img_w"][tex_id]
    h_img = tx["tex_img_h"][tex_id]
    mips = tx["tex_mips"][tex_id]
    mip_off = tx["tex_mip_off"][tex_id].reshape(-1)  # (N * MAX_MIP,)
    lane = torch.arange(tex_id.shape[0], device=tex_id.device) * MAX_MIP
    atlas = tx["tex_atlas"]
    n_atlas = atlas.shape[0]

    def fetch_level(lvl, wu_, wv_):
        off_l = mip_off[lane + lvl]
        w_l = (w_img >> lvl).clamp_min(1)
        h_l = (h_img >> lvl).clamp_min(1)

        def texel(xi, yi):
            # floor-mod (jnp's integer %, torch.remainder): wraps negatives
            xi = torch.remainder(xi.to(torch.int32), w_l).clamp_min(0)
            yi = torch.remainder(yi.to(torch.int32), h_l).clamp_min(0)
            return rows(atlas, (off_l + yi * w_l + xi).clamp(0, n_atlas - 1))

        # v = 0 at the image's bottom row
        return bilinear(wu_ * w_l - 0.5, (1.0 - wv_) * h_l - 0.5, texel)

    if width is None:
        return fetch_level(torch.zeros_like(w_img), u - torch.floor(u),
                           v - torch.floor(v))
    top = (mips - 1).clamp_min(0)
    lvl_f = (mips - 1).to(torch.float32) + torch.log2(width.clamp_min(1e-8))
    lvl_f = torch.minimum(lvl_f.clamp_min(0.0), top.to(torch.float32))
    l0 = torch.floor(lvl_f).to(torch.int32)
    lvls = torch.stack([l0, torch.minimum(l0 + 1, top)])   # (2, N)
    tt = (lvl_f - l0)[:, None]
    if aniso is None:
        f = fetch_level(lvls, (u - torch.floor(u))[None],
                        (v - torch.floor(v))[None])
        return (1.0 - tt) * f[0] + tt * f[1]
    offs = torch.tensor([o for o, _ in _ANISO_TAPS], dtype=uv.dtype,
                        device=uv.device)[:, None]
    tu = (uv[:, 0] + offs * aniso[:, 0]) * us[:, 0]          # (4, N)
    tv = (uv[:, 1] + offs * aniso[:, 1]) * us[:, 1]
    f = fetch_level(lvls[None], (tu - torch.floor(tu))[:, None],
                    (tv - torch.floor(tv))[:, None])      # (4, 2, N, 3)
    tri = (1.0 - tt) * f[:, 0] + tt * f[:, 1]
    img_val = 0.0
    wsum = sum(w for _, w in _ANISO_TAPS)
    for k, (_, wgt) in enumerate(_ANISO_TAPS):
        img_val = img_val + (wgt / wsum) * tri[k]
    return img_val


def _ptex(tx, tex_id, uv, face):
    """Per-face texel grid picked by the hit's faceIndex (PtexTexture::
    Evaluate, ptex.cpp:137-165; interaction.h:156), bilinear with clamped
    face edges: the local uv addresses the face's own grid, no wrap."""
    pw_all = tx["tex_ptex_w"]
    atlas = tx["tex_atlas"]
    first = tx["tex_img_off"][tex_id]          # first face index
    nf = tx["tex_img_w"][tex_id].clamp_min(1)
    fidx = (first + torch.minimum(face.clamp_min(0), nf - 1)).clamp(
        0, pw_all.shape[0] - 1).long()
    f_off = tx["tex_ptex_off"][fidx]
    f_w = pw_all[fidx]
    f_h = tx["tex_ptex_h"][fidx]
    fx = uv[:, 0].clamp(0.0, 1.0) * f_w - 0.5
    fy = (1.0 - uv[:, 1].clamp(0.0, 1.0)) * f_h - 0.5

    def ptexel(xi, yi):
        xi = torch.minimum(xi.to(torch.int32).clamp_min(0), f_w - 1)
        yi = torch.minimum(yi.to(torch.int32).clamp_min(0), f_h - 1)
        return rows(atlas, (f_off + yi * f_w + xi).clamp(
            0, atlas.shape[0] - 1))

    return bilinear(fx, fy, ptexel)


def _checker_aa(u, v, width, v1, v2, f1, chk_val):
    """The closed-form box-filtered 2D checkerboard (checkerboard.h:116-147)
    over the uv footprint, on the rows whose aamode is closedform."""
    def bump_int(x):  # integral of the 1D square wave's tex2 indicator
        fh = torch.floor(x / 2.0)
        return fh + 2.0 * (x / 2.0 - fh - 0.5).clamp_min(0.0)

    du = width.clamp_min(1e-8)
    s0, s1 = u - du, u + du
    t0_, t1_ = v - du, v + du
    sint = (bump_int(s1) - bump_int(s0)) / (2.0 * du)
    tint = (bump_int(t1_) - bump_int(t0_)) / (2.0 * du)
    area2 = (sint + tint - 2.0 * sint * tint).clamp(0.0, 1.0)
    aa_val = v1 * (1.0 - area2)[:, None] + v2 * area2[:, None]
    return torch.where((f1 > 0.5)[:, None], aa_val, chk_val)


def eval_texture(tx, tex_id, uv, p_world, width=None, aniso=None,
                 face=None, types=ALL_TYPES):
    """Texture rows `tex_id` (N,) (valid ids) for a hit batch: (N, 3).
    tx: dict of the TEX_FIELDS tensors; uv (N,2); p_world (N,3).
    `width` (N,) is the uv-space footprint for MIP selection (mipmap.h
    Lookup(st, width): level = nLevels - 1 + log2(max(width, eps))); None
    reads level 0. `aniso` (N,2) is the uv-space major-axis diameter of the
    footprint ellipse and adds the anisotropic line filter (eccentricity
    clamped by the caller, like the reference's MaxAnisotropy, mipmap.h:180).
    `face` (N,) is the ptex faceIndex. `types`: the static set of texture
    types to compute; a lane of another type gets its row's v1."""
    t = tx["tex_type"][tex_id]
    v1 = rows(tx["tex_v1"], tex_id)
    v2 = rows(tx["tex_v2"], tex_id)
    us = rows(tx["tex_uvscale"], tex_id)
    f1 = rows(tx["tex_f1"], tex_id)
    f2 = rows(tx["tex_f2"], tex_id)
    u = uv[:, 0] * us[:, 0]
    v = uv[:, 1] * us[:, 1]

    vals = {}
    if TEX_SCALE in types:
        vals[TEX_SCALE] = v1 * v2
    if TEX_MIX in types:
        vals[TEX_MIX] = (1.0 - f1)[:, None] * v1 + f1[:, None] * v2
    if TEX_CHECKER in types:
        check = torch.remainder(torch.floor(u).to(torch.int32)
                                + torch.floor(v).to(torch.int32), 2) == 0
        chk_val = torch.where(check[:, None], v1, v2)
        if width is not None:
            chk_val = _checker_aa(u, v, width, v1, v2, f1, chk_val)
        vals[TEX_CHECKER] = chk_val
    if TEX_CHECKER3D in types:
        # solid checkerboard in texture space (Checkerboard3DTexture,
        # checkerboard.h:250: parity of the world->texture-mapped point)
        m = rows(tx["tex_w2t"], tex_id)  # (N,4,4)
        pt = torch.einsum("nij,nj->ni", m[:, :3, :3], p_world) + m[:, :3, 3]
        c3 = torch.remainder(torch.floor(pt).to(torch.int32).sum(-1), 2) == 0
        vals[TEX_CHECKER3D] = torch.where(c3[:, None], v1, v2)
    if TEX_UV in types:
        vals[TEX_UV] = torch.stack([u - torch.floor(u), v - torch.floor(v),
                                    torch.zeros_like(u)], -1)
    if TEX_BILERP in types:
        # corners v00 = v1, v11 = v2 (the subset the rows carry)
        vals[TEX_BILERP] = ((1 - u)[:, None] * (1 - v)[:, None] * v1
                            + (u * v)[:, None] * v2)
    if TEX_DOTS in types:
        # textures/dots.h: one random dot a cell
        cu = torch.floor(u + 0.5).to(torch.int32)
        cv = torch.floor(v + 0.5).to(torch.int32)
        has_dot = uniform_float(cu, cv, 1) < 1.0
        dcx = cu + (uniform_float(cu, cv, 2) - 0.5) * 0.7
        dcy = cv + (uniform_float(cu, cv, 3) - 0.5) * 0.7
        rad = 0.35 * uniform_float(cu, cv, 4)
        inside = has_dot & ((u - dcx) ** 2 + (v - dcy) ** 2 < rad * rad)
        vals[TEX_DOTS] = torch.where(inside[:, None], v1, v2)
    # procedural noise family (static octave count: no ray-differential
    # clamp)
    octaves = 6
    if TEX_FBM in types or TEX_WINDY in types:
        fbm6 = fbm(p_world, 0.5, octaves)
        if TEX_FBM in types:
            vals[TEX_FBM] = fbm6[:, None].expand(-1, 3)
        if TEX_WINDY in types:
            # textures/windy.h: FBm(0.1 p) * |FBm(p)|
            wind = fbm(p_world * 0.1, 0.5, 3)
            vals[TEX_WINDY] = (wind * abs_tie_up(fbm6))[:, None].expand(-1, 3)
    if TEX_WRINKLED in types:
        vals[TEX_WRINKLED] = turbulence(
            p_world, 0.5, octaves)[:, None].expand(-1, 3)
    if TEX_MARBLE in types:
        # textures/marble.h: a spline over sin + turbulence
        mscale = torch.where(f2 > 0, f2, 1.0)
        marb = torch.sin(p_world[:, 1] * mscale * 4.0
                         + 10.0 * turbulence(p_world * mscale[:, None],
                                             0.5, 6))
        marb01 = 0.5 + 0.5 * marb
        vals[TEX_MARBLE] = torch.stack(
            [0.58 + 0.38 * marb01, 0.58 + 0.30 * marb01,
             0.6 + 0.25 * marb01], -1)
    if TEX_IMAGEMAP in types:
        has_img = tx["tex_img_w"][tex_id] > 0
        img = _imagemap(tx, tex_id, uv, us, u, v, width, aniso)
        vals[TEX_IMAGEMAP] = torch.where(has_img[:, None], img, v1)
    if TEX_PTEX in types and face is not None:
        vals[TEX_PTEX] = _ptex(tx, tex_id, uv, face)

    out = v1  # constant
    for ttype, val in vals.items():
        out = torch.where((t == ttype)[:, None], val, out)
    return out
