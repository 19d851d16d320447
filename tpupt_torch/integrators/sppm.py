"""Stochastic progressive photon mapping (counterpart of
integrators/sppm.cpp; the JAX package's integrators/sppm.py).

The reference alternates camera passes that deposit per-pixel visible
points into a hash grid (sppm.cpp:111-208) with photon passes that walk
the grid's linked lists and accumulate Phi atomically (sppm.cpp:210-290),
then shrinks each pixel's radius with alpha = 2/3 (sppm.cpp:292-315).

Here the visible points are one SoA (one per pixel), the hash grid is a
SORTED voxel-key array, and the photon pass is a wavefront in chunks of
the renderer's batch. Its deposit builds the (photon, visible point)
candidates of all 27 neighbour voxels at once (one `searchsorted` over
the stacked keys, the first VOXEL_CAP points of each voxel by offset, the
distance test), compacts the near pairs, evaluates the visible points'
BSDFs once over those pairs and adds Phi and M with `index_add`. The
candidates and the overflow count (points beyond the cap, counted on every
photon lane of a bounce >= 1) are the JAX package's; the sums differ from
its only in their order. Every traversal goes through the renderer's
wrapper (K1, K2 or K3 on the card)."""

from __future__ import annotations

import math
import warnings

import torch

from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.core import rng
from tpupt_torch.core.vecmath import dot, offset_ray_origin
from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators.bdpt import sample_le
from tpupt_torch.integrators.path import detached_traversal, shading_point
from tpupt_torch.lights.lights import emitted_radiance, sample_li
from tpupt_torch.materials import bsdf as bx

GAMMA = 2.0 / 3.0  # radius-shrink alpha (sppm.cpp:295)
VOXEL_CAP = 8      # visible points visited per neighbour voxel
GRID_RES = 1024    # virtual grid resolution per axis of the voxel key
# the 27 neighbour offsets, x outermost (the JAX package's loop order)
_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


class SPPMRenderer:
    """SPPMIntegrator::Render counterpart over a `Renderer` (its tables,
    device, pixel batches and traversal wrapper, read at every call)."""

    def __init__(self, renderer, initial_radius=None, photons_per_iter=None):
        self.r = renderer
        sc = renderer.scene
        self.xres, self.yres = sc.film.xres, sc.film.yres
        self.npix = self.xres * self.yres
        ds = renderer.ds
        diag = float(torch.linalg.norm(ds.world_hi - ds.world_lo))
        self.r0 = initial_radius or max(diag, 1e-3) * 0.01
        self.n_photons = photons_per_iter or max(self.npix, 4096)
        self.max_depth = sc.integrator.max_depth
        self.npix_pad = renderer._px_b.numel()
        self.film = None
        self.overflow = 0

    def _intersect(self):
        r = self.r
        return detached_traversal(r._isect, r.ds, r.st, r.collect_stats)

    def _mat(self, mat, uv, p, face=None):
        st = self.r.st
        return bx.gather_mat_params(self.r.ds, mat, uv=uv, p=p, face=face,
                                    has_textures=st.has_textures,
                                    tex_types=st.tex_types,
                                    has_mix="mix" in st.mat_features)

    # ---------------- camera pass: find visible points ----------------

    @torch.no_grad()
    def camera_pass(self, it):
        """One camera path per pixel -> visible point + direct light Ld
        (sppm.cpp:145-208: NEE at each vertex, the walk through specular
        surfaces), batch by batch. Returns a dict of (npix_pad, ...)
        tensors: p, ns, wo, beta, mat, uv, have, Ld."""
        r = self.r
        parts = [self._camera_batch(it, b) for b in range(r.n_batches)]
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

    def _camera_batch(self, it, b):
        r = self.r
        ds, st = r.ds, r.st
        sc = r.scene
        feats = st.mat_features
        intersect = self._intersect()
        px, py = r._px_b[b], r._py_b[b]
        n = px.shape[0]
        key = rng.hash_combine(it * 2 + 1, rng.as_u32(px) * 31337
                               + rng.as_u32(py))
        jx = rng.uniform_float(key, 0)
        jy = rng.uniform_float(key, 1)
        pr = torch.stack([px.to(torch.float32) + jx,
                          py.to(torch.float32) + jy], -1)
        o, d = generate_rays(sc.camera.type, ds.raster_to_camera,
                             ds.cam_to_world, pr,
                             torch.stack([rng.uniform_float(key, 2),
                                          rng.uniform_float(key, 3)], -1),
                             sc.camera.lens_radius, sc.camera.focal_distance,
                             self.xres, self.yres)
        beta = o.new_ones((n, 3))
        alive = r._valid_b[b]
        Ld = o.new_zeros((n, 3))
        vp = dict(p=o.new_zeros((n, 3)), ns=o.new_zeros((n, 3)),
                  wo=o.new_zeros((n, 3)), beta=o.new_zeros((n, 3)),
                  mat=torch.zeros(n, dtype=torch.int32, device=o.device),
                  uv=o.new_zeros((n, 2)),
                  have=torch.zeros(n, dtype=torch.bool, device=o.device))
        light_cdf = torch.cumsum(ds.light_pdf, 0)

        for depth in range(self.max_depth):
            hit, _ = intersect(o, d, torch.where(alive, math.inf, 0.0))
            sp = shading_point(ds, st, hit, o, d, r._shade_tables)
            ok = alive & hit.valid
            wo = -d
            le = emitted_radiance(ds, st, hit.prim, sp.light, wo, sp.ns)
            Ld = Ld + torch.where(ok[..., None], beta * le, 0.0)

            mp = self._mat(sp.mat, sp.uv, sp.p, sp.face)
            t_f, b_f, n_f = bx.make_frame(sp.ns)
            wo_l = bx.to_local(t_f, b_f, n_f, wo)

            # NEE at the vertex (sppm.cpp:180 UniformSampleOneLight)
            if st.n_lights > 0:
                u0 = rng.uniform_float(key, 10 + depth * 8)
                lid = torch.searchsorted(light_cdf, u0, right=True).clamp(
                    0, st.n_lights - 1).to(torch.int32)
                ls = sample_li(ds, st, lid, sp.p,
                               rng.uniform_float(key, 11 + depth * 8),
                               rng.uniform_float(key, 12 + depth * 8))
                wi_l = bx.to_local(t_f, b_f, n_f, ls.wi)
                f_l, _ = bx.eval_pdf(mp, wo_l, wi_l, feats, st.mix_features)
                f_l = f_l * torch.abs(dot(ls.wi, sp.ns))[..., None]
                can = ok & (ls.pdf > 0.0) & (torch.amax(f_l, -1) > 0.0)
                o_sh = offset_ray_origin(sp.p, sp.ng, ls.wi)
                occ = intersect(o_sh, ls.wi,
                                torch.where(can, ls.dist * 0.997, 0.0),
                                any_hit=True)[0].valid
                pmf = ds.light_pdf[lid.long()]
                contrib = beta * f_l * ls.li / (
                    ls.pdf * pmf).clamp_min(1e-12)[..., None]
                Ld = Ld + torch.where((can & ~occ)[..., None], contrib, 0.0)

            # sample the continuation; STOP at the first non-specular vertex
            bs = bx.sample(mp, wo_l,
                           rng.uniform_float(key, 13 + depth * 8),
                           rng.uniform_float(key, 14 + depth * 8),
                           rng.uniform_float(key, 15 + depth * 8), feats,
                           st.mix_features)
            store = ok & ~bs.specular & ~vp["have"]
            for k, v in (("p", sp.p), ("ns", sp.ns), ("wo", wo),
                         ("beta", beta), ("uv", sp.uv)):
                vp[k] = torch.where(store[..., None], v, vp[k])
            vp["mat"] = torch.where(store, sp.mat, vp["mat"])
            vp["have"] = vp["have"] | store

            wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
            thru = bs.f * (torch.abs(dot(wi_w, sp.ns))
                           / bs.pdf.clamp_min(1e-9))[..., None]
            cont = ok & bs.specular & (bs.pdf > 1e-9)
            beta = torch.where(cont[..., None], beta * thru, beta)
            o = torch.where(cont[..., None],
                            offset_ray_origin(sp.p, sp.ng, wi_w), o)
            d = torch.where(cont[..., None], wi_w, d)
            alive = cont
        vp["Ld"] = Ld
        return vp

    # ---------------- photon pass ----------------

    @torch.no_grad()
    def photon_pass(self, it, vp, radius, grid_lo, cell):
        """Trace `n_photons` photons in chunks of the renderer's batch and
        deposit Phi into the visible points through the sorted voxel grid
        (sppm.cpp:210-290). Returns (Phi (npix_pad,3), M (npix_pad,),
        overflow: int)."""
        g = GRID_RES
        dev = radius.device
        # the voxel of a visible point is clipped to the grid, as a
        # photon's neighbour voxels are
        vox = ((vp["p"] - grid_lo) / cell).to(torch.int32).clamp(0, g - 1)
        vkey = (vox[:, 0] * g + vox[:, 1]) * g + vox[:, 2]
        vkey = torch.where(vp["have"], vkey, g ** 3)
        skey, order = torch.sort(vkey, stable=True)
        grid = (skey.contiguous(), order)
        phi = torch.zeros((self.npix_pad, 3), device=dev)
        m_cnt = torch.zeros(self.npix_pad, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        chunk = self.r.batch
        for c0 in range(0, self.n_photons, chunk):
            lanes = torch.arange(c0, min(c0 + chunk, self.n_photons),
                                 dtype=torch.int64, device=dev)
            phi, m_cnt, overflow = self._photon_chunk(
                it, lanes, vp, radius, grid_lo, cell, grid, phi, m_cnt,
                overflow)
        return phi, m_cnt, int(overflow)

    def _photon_chunk(self, it, lanes, vp, radius, grid_lo, cell, grid, phi,
                      m_cnt, overflow):
        r = self.r
        ds, st = r.ds, r.st
        feats = st.mat_features
        intersect = self._intersect()
        key = rng.hash_combine(it * 2 + 2, lanes)
        light_cdf = torch.cumsum(ds.light_pdf, 0)
        u0 = rng.uniform_float(key, 0)
        lid = torch.searchsorted(light_cdf, u0, right=True).clamp(
            0, max(st.n_lights - 1, 0)).to(torch.int32)
        pmf = ds.light_pdf[lid.long()]
        p_l, n_l, d_l, le, pdf_pos, pdf_dir, _, _ = sample_le(
            ds, st, lid, rng.uniform_float(key, 1), rng.uniform_float(key, 2),
            rng.uniform_float(key, 3), rng.uniform_float(key, 4))
        beta = le * (torch.abs(dot(n_l, d_l))
                     / (pmf * pdf_pos * pdf_dir).clamp_min(1e-12))[..., None]
        alive = (torch.amax(le, -1) > 0.0) & (pdf_dir > 0.0)
        o = offset_ray_origin(p_l, torch.where(
            (torch.abs(n_l).sum(-1) > 1e-6)[..., None], n_l, d_l), d_l)
        d = d_l

        for depth in range(self.max_depth):
            hit, _ = intersect(o, d, torch.where(alive, math.inf, 0.0))
            sp = shading_point(ds, st, hit, o, d, r._shade_tables)
            ok = alive & hit.valid
            if depth > 0:
                # photons deposit from their second vertex on: the first
                # bounce's light is the camera pass's NEE (sppm.cpp:250)
                phi, m_cnt, overflow = self._deposit(
                    ok, sp.p, beta, d, vp, radius, grid_lo, cell, grid, phi,
                    m_cnt, overflow)

            # photon continuation (BSDF sample + RR, sppm.cpp:270-288)
            mp = self._mat(sp.mat, sp.uv, sp.p, sp.face)
            t_f, b_f, n_f = bx.make_frame(sp.ns)
            wo_l = bx.to_local(t_f, b_f, n_f, -d)
            bs = bx.sample(mp, wo_l,
                           rng.uniform_float(key, 20 + depth * 8),
                           rng.uniform_float(key, 21 + depth * 8),
                           rng.uniform_float(key, 22 + depth * 8), feats,
                           st.mix_features)
            wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
            thru = bs.f * (torch.abs(dot(wi_w, sp.ns))
                           / bs.pdf.clamp_min(1e-9))[..., None]
            beta_new = beta * thru
            # russian roulette on the throughput ratio (sppm.cpp:283)
            q = (1.0 - torch.amax(beta_new, -1)
                 / torch.amax(beta, -1).clamp_min(1e-12)).clamp(0.0, 0.95)
            survive = rng.uniform_float(key, 23 + depth * 8) >= q
            beta = beta_new / (1.0 - q).clamp_min(1e-6)[..., None]
            alive = (ok & (bs.pdf > 1e-9) & survive
                     & (torch.amax(beta, -1) > 0.0))
            o = offset_ray_origin(sp.p, sp.ng, wi_w)
            d = wi_w
        return phi, m_cnt, overflow

    def _deposit(self, dep, p, beta, d, vp, radius, grid_lo, cell, grid,
                 phi, m_cnt, overflow):
        """Phi += beta * f(wo_vp, -d) and M += 1 at every visible point
        within its radius of a depositing photon, over the first VOXEL_CAP
        points of each of the photon's 27 neighbour voxels (clipped to the
        grid). The overflow counts the points past the cap over every lane
        of the chunk, as the JAX package counts them."""
        g = GRID_RES
        skey, order = grid
        st = self.r.st
        n = p.shape[0]
        offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=p.device)
        pvox = ((p - grid_lo) / cell).to(torch.int32)
        nb = (pvox[:, None, :] + offs[None]).clamp(0, g - 1)
        nkey = ((nb[..., 0] * g + nb[..., 1]) * g + nb[..., 2]).reshape(-1)
        lo = torch.searchsorted(skey, nkey)
        cnt = torch.searchsorted(skey, nkey, right=True) - lo
        overflow = overflow + (cnt - VOXEL_CAP).clamp_min(0).sum()
        # the candidates: the first VOXEL_CAP points of each voxel of a
        # depositing lane
        lo, cnt = lo.view(n, 27), cnt.view(n, 27)
        lane = torch.nonzero(dep).squeeze(1)
        ks = torch.arange(VOXEL_CAP, device=p.device)
        cand = ks < cnt[lane][..., None]                   # (q, 27, cap)
        qi, oi, ki = torch.nonzero(cand, as_tuple=True)
        lane = lane[qi]
        vid = order[lo[lane, oi] + ki]
        dv = vp["p"][vid] - p[lane]
        dist2 = dv[:, 0] ** 2 + dv[:, 1] ** 2 + dv[:, 2] ** 2
        near = vp["have"][vid] & (dist2 <= radius[vid] ** 2)
        keep = torch.nonzero(near).squeeze(1)
        lane, vid = lane[keep], vid[keep]
        # the FULL BSDF of the visible point toward the photon
        # (sppm.cpp:262 bsdf->f(wo, wi)): glossy visible points gather
        # photons through their microfacet lobes
        mp_v = self._mat(vp["mat"][vid], vp["uv"][vid], vp["p"][vid])
        tv, bv, nv = bx.make_frame(vp["ns"][vid])
        f_v, _ = bx.eval_pdf(mp_v, bx.to_local(tv, bv, nv, vp["wo"][vid]),
                             bx.to_local(tv, bv, nv, -d[lane]),
                             st.mat_features, st.mix_features)
        phi = phi.index_add(0, vid, beta[lane] * f_v)
        m_cnt = m_cnt.index_add(0, vid, torch.ones_like(vid,
                                                        dtype=m_cnt.dtype))
        return phi, m_cnt, overflow

    # ---------------- driver ----------------

    def render(self, n_iterations=16, verbose=False):
        """`n_iterations` camera + photon passes with the radius and flux
        update after each (sppm.cpp:292-315). Returns the image (H, W, 3)
        as numpy; `self.film` holds it with unit weights, `self.overflow`
        the voxel-cap overflows of all passes."""
        r = self.r
        dev = r.device
        n = self.npix_pad
        radius = torch.full((n,), self.r0, device=dev)
        N = torch.zeros(n, device=dev)
        tau = torch.zeros((n, 3), device=dev)
        Ld_acc = torch.zeros((n, 3), device=dev)
        self.overflow = 0
        for it in range(n_iterations):
            vp = self.camera_pass(it)
            Ld_acc = Ld_acc + vp["Ld"]
            cell = torch.amax(radius) * 1.0001
            grid_lo = r.ds.world_lo - 2 * cell
            phi, m_cnt, ovf = self.photon_pass(it, vp, radius, grid_lo, cell)
            self.overflow += ovf
            has = m_cnt > 0
            n_new = N + GAMMA * m_cnt
            r_new = torch.where(
                has, radius * torch.sqrt(n_new / (N + m_cnt).clamp_min(1e-9)),
                radius)
            tau = torch.where(has[..., None],
                              (tau + vp["beta"] * phi)
                              * ((r_new / radius) ** 2)[..., None], tau)
            N, radius = n_new, r_new
            if verbose:
                print(f"  sppm pass {it + 1}/{n_iterations} "
                      f"(max r {float(radius.max()):.4f})", flush=True)
        if self.overflow:
            warnings.warn(f"sppm: {self.overflow} voxel-cap overflows "
                          f"(VOXEL_CAP={VOXEL_CAP}); increase photon grid "
                          "resolution for this scene")
        n_total = n_iterations * self.n_photons
        L = (Ld_acc / n_iterations
             + tau / (n_total * math.pi
                      * radius.clamp_min(1e-9)[..., None] ** 2))
        valid = r._valid_b.reshape(-1)
        pid = (r._py_b.reshape(-1) * self.xres + r._px_b.reshape(-1)).long()
        img = torch.zeros((self.npix, 3), device=dev).index_add(
            0, pid[valid], L[valid])
        w = torch.zeros(self.npix, device=dev).index_add(
            0, pid[valid], torch.ones_like(pid[valid], dtype=torch.float32))
        # the per-pixel estimate enters film.rgb with unit weight: SPPM's
        # estimator is normalised per pixel already (sppm.cpp:307 writes
        # pixels directly), so a box reconstruction of weight 1 is exact
        self.film = filmmod.new_film(self.xres, self.yres, dev)._replace(
            rgb=img * w[:, None] / w[:, None].clamp_min(1.0), weight=w)
        return img.reshape(self.yres, self.xres, 3).cpu().numpy()
