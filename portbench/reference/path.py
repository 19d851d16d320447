"""Plain PyTorch path tracer: the reference the benchmark holds the
program's films, losses and gradients against.

It follows pbrt-v3's PathIntegrator::Li (path.cpp) for what the museum
scenes hold: triangles with interpolated normals, matte (Lambertian) and
plastic (Lambertian plus Trowbridge-Reitz microfacet reflection, dielectric
Fresnel with eta 1.5) materials, triangle area lights and a distant light,
depth 5 with next-event estimation, power-heuristic MIS, Russian roulette
after three bounces, a box filter of radius 0.5. Where the port defines
its own behaviour, the reference follows the port's documentation:
- the Halton sampler scrambles digits with an affine permutation
  (a * digit + c) mod base drawn from numpy's Generator of the sampler
  seed, and takes dimensions 0-1 through pbrt's pixel indexer; each vertex
  takes seven dimensions from 5 + 7 * bounce;
- the light is chosen from a 16^3 grid of per-voxel cdfs;
- the sampled direction and its density are constants of differentiation
  (the detached-sampling estimator), as are the ray queries;
- a spawned ray starts 1e-3 * max(|p|_inf, 1) off the surface, along the
  geometric normal turned toward the new direction.

`dtype` is the precision of everything after the ray queries (the
shading chain, the light sample, the throughput and the radiance): float32
is the reference, bfloat16 the control that has to come out as not
correct. The ray queries stay float32."""

from __future__ import annotations

import math

import torch

from reference import bvh
from reference.scene import (DISTANT, GRID_RES, PLASTIC, PRIMES,
                             SHADOW_EPS, RefScene)

M32 = 0xFFFFFFFF
K_MAX_RES = 128
ONE_MINUS_EPS = 1.0 - 1e-7
INV_PI = 1.0 / math.pi
RR_START = 3
Y_WEIGHT = (0.212671, 0.715160, 0.072169)


# ------------------------------ Halton -------------------------------------

def _digits(base):
    n, k = 1, 0
    while n < 2 ** 32:
        n *= base
        k += 1
    return k


def _reverse(base, index, a=1, c=0):
    inv_base = 1.0 / base
    rev = torch.zeros_like(index)
    inv_n = torch.ones(index.shape, dtype=torch.float32, device=index.device)
    for _ in range(_digits(base)):
        live = index > 0
        nxt = index // base
        digit = ((index - nxt * base) * a + c) % base
        rev = torch.where(live, (rev * base + digit) & M32, rev)
        inv_n = torch.where(live, inv_n * inv_base, inv_n)
        index = nxt
    return rev, inv_n


def _bitrev32(x):
    x = ((x << 16) | (x >> 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def _radical_inverse(base, index):
    if base == 2:
        return _bitrev32(index).to(torch.float32) * 2.3283064365386963e-10
    rev, inv_n = _reverse(base, index)
    return (rev.to(torch.float32) * inv_n).clamp_max(ONE_MINUS_EPS)


def _inv_mod(a, n):
    t, nt, r, nr = 0, 1, n, a % n
    while nr:
        q = r // nr
        t, nt, r, nr = nt, t - q * nt, nr, r - q * nr
    return t % n


class Halton:
    """Sample dimensions of pixel (px, py), sample s: pbrt's pixel
    indexer (halton.cpp) and affine-scrambled radical inverses."""

    def __init__(self, scene: RefScene):
        j, sx = 0, 1
        while sx < min(scene.xres, K_MAX_RES):
            sx *= 2
            j += 1
        k, sy = 0, 1
        while sy < min(scene.yres, K_MAX_RES):
            sy *= 3
            k += 1
        self.j, self.k, self.sx, self.sy = j, k, sx, sy
        self.stride = sx * sy
        self.m0 = ((self.stride // sx) * (_inv_mod(sy, sx) if sx > 1 else 0)
                   % self.stride)
        self.m1 = ((self.stride // sy) * (_inv_mod(sx, sy) if sy > 1 else 0)
                   % self.stride)
        self.a, self.c = scene.perm_a, scene.perm_c

    def index(self, px, py, s):
        if self.stride == 1:
            off = torch.zeros_like(px)
        else:
            d0 = torch.zeros_like(px)
            x = px % K_MAX_RES
            for _ in range(self.j):
                d0 = (d0 * 2 + x % 2) & M32
                x = x // 2
            d1 = torch.zeros_like(py)
            y = py % K_MAX_RES
            for _ in range(self.k):
                d1 = (d1 * 3 + y % 3) & M32
                y = y // 3
            off = (((d0 * self.m0) & M32) + ((d1 * self.m1) & M32)) & M32
            off = off % self.stride
        s = s & M32 if torch.is_tensor(s) else int(s) & M32
        return (off + s * self.stride) & M32

    def jitter(self, idx):
        x = _radical_inverse(2, idx >> self.j) * self.sx
        y = _radical_inverse(3, idx // self.sy) * self.sy
        return x - torch.floor(x), y - torch.floor(y)

    def dim(self, idx, d):
        d = min(d, len(PRIMES) - 1)
        if d < 2:
            return self.jitter(idx)[d]
        base = PRIMES[d]
        a = self.a[d] % base or 1
        c = self.c[d] % base
        rev, inv_n = _reverse(base, idx, a, c)
        tail = inv_n * float(c) / (base - 1.0)
        return (rev.to(torch.float32) * inv_n + tail).clamp_max(ONE_MINUS_EPS)


# ------------------------------ vectors ------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v * torch.rsqrt(dot(v, v).clamp_min(1e-30))[..., None]


def safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def frame(n):
    """Orthonormal basis around unit n (Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], -1)
    s = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, s, n


def to_local(fr, v):
    return torch.stack([dot(v, fr[0]), dot(v, fr[1]), dot(v, fr[2])], -1)


def to_world(fr, v):
    return v[..., 0:1] * fr[0] + v[..., 1:2] * fr[1] + v[..., 2:3] * fr[2]


def offset_origin(p, n, d):
    scale = p.abs().amax(-1).clamp_min(1.0)
    n = torch.where(dot(n, d)[..., None] < 0.0, -n, n)
    return p + (SHADOW_EPS * scale)[..., None] * n


def power_heuristic(f, g):
    den = f * f + g * g
    ok = den > 0.0
    return torch.where(ok, f * f / torch.where(ok, den, 1.0), 0.0)


# ------------------------------ BSDFs --------------------------------------

def roughness_to_alpha(r):
    x = torch.log(r.clamp_min(1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def fresnel_dielectric(cos_i, eta):
    cos_i = cos_i.clamp(-1.0, 1.0)
    eta = torch.where(cos_i > 0.0, eta, 1.0 / eta.clamp_min(1e-6))
    ci = cos_i.abs()
    sin2_t = (1.0 - ci * ci).clamp_min(0.0) / (eta * eta)
    ct = safe_sqrt(1.0 - sin2_t)
    r_par = (eta * ci - ct) / (eta * ci + ct).clamp_min(1e-12)
    r_perp = (ci - eta * ct) / (ci + eta * ct).clamp_min(1e-12)
    return torch.where(sin2_t >= 1.0, 1.0,
                       0.5 * (r_par * r_par + r_perp * r_perp))


def ggx_d(wh, a):
    c2 = wh[..., 2] * wh[..., 2]
    e = wh[..., 0] ** 2 / (a * a) + wh[..., 1] ** 2 / (a * a) + c2
    den = math.pi * a * a * e * e
    ok = den > 1e-20
    return (torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)
            * torch.where(c2 > 0, 1.0, 0.0))


def ggx_lambda(w, a):
    c = w[..., 2].abs()
    s2 = (1.0 - c * c).clamp_min(0.0)
    s = safe_sqrt(s2)
    cos_phi = torch.where(s > 1e-8, w[..., 0] / s.clamp_min(1e-8), 1.0)
    sin_phi = torch.where(s > 1e-8, w[..., 1] / s.clamp_min(1e-8), 0.0)
    alpha2 = cos_phi ** 2 * a * a + sin_phi ** 2 * a * a
    tan2 = s2 / (c * c).clamp_min(1e-12)
    return 0.5 * (-1.0 + torch.sqrt((1.0 + alpha2 * tan2).clamp_min(0.0)))


def _half(wo, wi):
    wh = wi + wo
    ln = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    return wh / ln[..., None], ln


def ggx_pdf(wo, wi, a):
    """Density of a visible-normal sample reflected to wi."""
    wh, ln = _half(wo, wi)
    g1 = 1.0 / (1.0 + ggx_lambda(wo, a))
    p_wh = (ggx_d(wh, a) * g1 * dot(wo, wh).abs()
            / wo[..., 2].abs().clamp_min(1e-8))
    p = p_wh / (4.0 * dot(wo, wh).abs()).clamp_min(1e-8)
    same = wo[..., 2] * wi[..., 2] > 0.0
    return torch.where(same & (ln > 1e-8), p, 0.0)


def ggx_sample(wo, u1, u2, a):
    """Visible-normal sample (Heitz 2018) of the half vector."""
    flip = wo[..., 2] < 0.0
    w = torch.where(flip[..., None], -wo, wo)
    vh = normalize(torch.stack([a * w[..., 0], a * w[..., 1], w[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(lensq.clamp_min(1e-20))
    t1 = torch.where((lensq > 1e-18)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape))
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    q1 = r * torch.cos(phi)
    q2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    q2 = (1.0 - s) * safe_sqrt(1.0 - q1 * q1) + s * q2
    qz = safe_sqrt(1.0 - q1 * q1 - q2 * q2)
    nh = q1[..., None] * t1 + q2[..., None] * t2 + qz[..., None] * vh
    wh = normalize(torch.stack([a * nh[..., 0], a * nh[..., 1],
                                nh[..., 2].clamp_min(1e-6)], -1))
    return torch.where(flip[..., None], -wh, wh)


def cosine_sample(u1, u2):
    ox, oy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    th = torch.where(
        use_x, (math.pi / 4) * (oy / torch.where(ox == 0, 1.0, ox)),
        math.pi / 2 - (math.pi / 4) * (ox / torch.where(oy == 0, 1.0, oy)))
    x = torch.where(zero, 0.0, r * torch.cos(th))
    y = torch.where(zero, 0.0, r * torch.sin(th))
    return torch.stack([x, y, torch.sqrt((1.0 - x * x - y * y)
                                         .clamp_min(0.0))], -1)


def bsdf_eval(m, wo, wi):
    """(f, pdf) of matte or plastic at local wo, wi."""
    same = wo[..., 2] * wi[..., 2] > 0.0
    diff_pdf = torch.where(same, wi[..., 2].abs() * INV_PI, 0.0)
    lam = m["kd"] * INV_PI
    wh, ln = _half(wo, wi)
    ci, co = wi[..., 2].abs(), wo[..., 2].abs()
    a = m["alpha"]
    fr = fresnel_dielectric(dot(wo, wh), m["eta"])
    g = 1.0 / (1.0 + ggx_lambda(wo, a) + ggx_lambda(wi, a))
    ok = (ci > 1e-6) & (co > 1e-6) & (ln > 1e-8) & same
    spec = m["ks"] * fr[..., None] * (
        ggx_d(wh, a) * g / (4.0 * ci * co).clamp_min(1e-8))[..., None]
    spec = torch.where(ok[..., None], spec, 0.0)
    plastic = m["type"] == PLASTIC
    f = torch.where(same[..., None],
                    torch.where(plastic[..., None], lam + spec, lam), 0.0)
    pdf = torch.where(plastic, 0.5 * (diff_pdf + ggx_pdf(wo, wi, a)),
                      diff_pdf)
    return f, pdf


# ------------------------------ lights -------------------------------------

def _tri_light(sc: RefScene, prim, dt):
    a, b, c = (x[prim].to(dt) for x in (sc.p0, sc.p1, sc.p2))
    nn = torch.linalg.cross(b - a, c - a, dim=-1)
    a2 = torch.sqrt(dot(nn, nn))
    return a, b, c, nn / a2.clamp_min(1e-20)[..., None], 0.5 * a2


def sample_light(sc: RefScene, L_tab, lid, p, u1, u2, dt):
    """(wi, Li, pdf, dist, is_delta) toward light lid from p."""
    kind = sc.light_type[lid]
    Ll = L_tab[lid].to(dt)
    a, b, c, n, area = _tri_light(sc, sc.light_prim[lid], dt)
    su = torch.sqrt(u1)
    b0, b1 = 1.0 - su, u2 * su
    pl = a * b0[..., None] + b * b1[..., None] + c * (1.0 - b0 - b1)[..., None]
    to = pl - p
    d2 = dot(to, to).clamp_min(1e-12)
    dist = torch.sqrt(d2)
    wi = to / dist[..., None]
    cos_l = dot(n, -wi)
    pdf = d2 / (cos_l.abs() * area).clamp_min(1e-12)
    li = torch.where((cos_l > 1e-7)[..., None], Ll, 0.0)
    distant = (kind == DISTANT)
    wr = 0.5 * torch.sqrt(dot(sc.world_hi - sc.world_lo,
                              sc.world_hi - sc.world_lo)) + 1e-3
    wi = torch.where(distant[..., None], sc.light_dir[lid].to(dt), wi)
    li = torch.where(distant[..., None], Ll, li)
    pdf = torch.where(distant, 1.0, pdf)
    dist = torch.where(distant, (2.0 * wr).to(dt), dist)
    return wi, li, pdf, dist, distant


def grid_row(sc: RefScene, p):
    g = GRID_RES
    ext = (sc.world_hi - sc.world_lo).clamp_min(1e-6)
    v = ((p.float() - sc.world_lo) / ext * g).to(torch.int64).clamp(0, g - 1)
    return sc.grid_cdf[(v[..., 0] * g + v[..., 1]) * g + v[..., 2]]


def row_pmf(row, lid):
    hi = row.gather(-1, lid[..., None])[..., 0]
    lo = torch.where(lid > 0, row.gather(-1, (lid - 1).clamp_min(0)[..., None])
                     [..., 0], 0.0)
    return (hi - lo).clamp_min(1e-12)


# ------------------------------ the path -----------------------------------

def camera_rays(sc: RefScene, hal: Halton, px, py, s):
    idx = hal.index(px, py, s)
    jx, jy = hal.jitter(idx)
    pr = torch.stack([px.float() + jx, py.float() + jy,
                      torch.zeros_like(jx)], -1)
    m = sc.raster_to_camera
    pc = (pr @ m[:3, :3].T + m[:3, 3]) / (pr @ m[3, :3] + m[3, 3])[..., None]
    dc = normalize(pc)
    c2w = sc.cam_to_world
    o = c2w[:3, 3].expand(len(px), 3)
    return pr[:, :2], o, normalize(dc @ c2w[:3, :3].T), idx


def film_pixel(sc: RefScene, hal: Halton, px, py, s):
    """(pixel index, in film) the box filter of radius 0.5 adds the camera
    sample of lane (px, py) at sample index s (an int or one a lane) to:
    the pixel whose centre is within 0.5 of the sample, the lower one on a
    boundary, as the port's one-tap film takes it."""
    p, _, _, _ = camera_rays(sc, hal, px, py, s)
    ix = torch.ceil((p[:, 0] - 0.5) - 0.5).long()
    iy = torch.ceil((p[:, 1] - 0.5) - 0.5).long()
    ok = (ix >= 0) & (ix < sc.xres) & (iy >= 0) & (iy < sc.yres)
    return iy.clamp(0, sc.yres - 1) * sc.xres + ix.clamp(0, sc.xres - 1), ok


def radiance(sc: RefScene, params: dict, hal: Halton, px, py, s, query,
             dt=torch.float32):
    """Radiance (N,3) of one camera sample per lane (px, py) at sample
    index s (an int or one a lane). `params` holds kd, ks, rough, light_L
    (leaves or tables); `query(o, d, tmax, any_hit)` -> (valid, t, prim,
    b1, b2), float32."""
    _, o, d, idx = camera_rays(sc, hal, px, py, s)
    n = len(px)
    o, d = o.to(dt), d.to(dt)
    kd, ks = params["kd"].to(dt), params["ks"].to(dt)
    rough, L_tab = params["rough"], params["light_L"]
    alpha_tab = torch.where(sc.mat_remap, roughness_to_alpha(rough),
                            rough.clamp_min(1e-3)).to(dt)
    n_lights = L_tab.shape[0]
    L = torch.zeros((n, 3), dtype=dt, device=o.device)
    beta = torch.ones((n, 3), dtype=dt, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    prev_spec = torch.ones_like(alive)
    prev_pdf = torch.ones(n, dtype=dt, device=o.device)
    prev_p = o
    for bounce in range(sc.max_depth + 1):
        last = bounce >= sc.max_depth
        valid, t, prim, b1, b2 = query(
            o.float(), d.float(),
            torch.where(alive, torch.inf, 0.0).float(), False)
        tid = prim.clamp_min(0)
        t = t.to(dt)
        b1, b2 = b1.to(dt), b2.to(dt)
        p = o + torch.where(valid, t, 1.0)[..., None] * d
        v0, v1, v2 = (x[tid].to(dt) for x in (sc.p0, sc.p1, sc.p2))
        ns = normalize((1.0 - b1 - b2)[..., None] * sc.n0[tid].to(dt)
                       + b1[..., None] * sc.n1[tid].to(dt)
                       + b2[..., None] * sc.n2[tid].to(dt))
        ng = normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
        ng = torch.where(dot(ng, ns)[..., None] < 0.0, -ng, ng)
        mat, light = sc.mat[tid], sc.light[tid]
        wo = -d

        # emission at the hit, MIS against light sampling
        lid0 = light.clamp(0, n_lights - 1)
        emit = (light >= 0) & (dot(ns, wo) > 0.0) & alive & valid
        le = torch.where(emit[..., None], L_tab[lid0].to(dt), 0.0)
        _, _, _, tn, area = _tri_light(sc, tid, dt)
        t_safe = torch.where(valid, t, 1.0)
        lp = t_safe * t_safe / (dot(tn, -d).abs() * area).clamp_min(1e-12)
        lp = torch.where(valid, lp, 0.0)
        pmf0 = row_pmf(grid_row(sc, prev_p), lid0).to(dt)
        w = torch.where(prev_spec, 1.0, power_heuristic(prev_pdf, lp * pmf0))
        L = L + beta * le * w[..., None]

        alive = alive & valid & (not last)
        base = 5 + min(bounce, sc.max_depth - 1) * 7
        u = [hal.dim(idx, base + k) for k in range(7)]
        ud = [x.to(dt) for x in u]
        m = dict(type=sc.mat_type[mat], kd=kd[mat], ks=ks[mat],
                 alpha=alpha_tab[mat], eta=sc.mat_eta[mat].to(dt))
        fr = frame(ns)
        wo_l = to_local(fr, wo)

        # next-event estimation
        row = grid_row(sc, p)
        lid = (u[0][..., None] > row).sum(-1).clamp(0, n_lights - 1)
        pmf = row_pmf(row, lid).to(dt)
        wi, li, lpdf, dist, delta = sample_light(sc, L_tab, lid, p, ud[1],
                                                 ud[2], dt)
        f, pdf_b = bsdf_eval(m, wo_l, to_local(fr, wi))
        f = f * dot(wi, ns).abs()[..., None]
        can = alive & (lpdf > 0.0) & (f.amax(-1) > 0.0)
        occ = query(offset_origin(p, ng, wi).float(), wi.float(),
                    torch.where(can, dist * 0.999, 0.0).float(), True)[0]
        w_l = torch.where(delta, 1.0, power_heuristic(lpdf * pmf, pdf_b))
        contrib = beta * f * li * (
            w_l / (lpdf * pmf).clamp_min(1e-12))[..., None]
        L = L + torch.where((can & ~occ)[..., None], contrib, 0.0)

        # BSDF sample (direction and density detached)
        sign_o = torch.where(wo_l[..., 2] >= 0.0, 1.0, -1.0).to(dt)
        wi_d = cosine_sample(ud[4], ud[5]) * torch.stack(
            [torch.ones_like(sign_o), torch.ones_like(sign_o), sign_o], -1)
        wh = ggx_sample(wo_l, ud[4], ud[5], m["alpha"])
        wi_m = -wo_l + 2.0 * dot(wo_l, wh)[..., None] * wh
        glossy = (m["type"] == PLASTIC) & ~(ud[3] < 0.5)
        wi_s = normalize(torch.where(glossy[..., None], wi_m, wi_d)).detach()
        f_s, pdf_s = bsdf_eval(m, wo_l, wi_s)
        pdf_s = pdf_s.detach()
        wi_w = to_world(fr, wi_s)
        ok = pdf_s > 1e-9
        thru = f_s * (dot(wi_w, ns).abs() / pdf_s.clamp_min(1e-9))[..., None]
        beta = beta * torch.where((ok & alive)[..., None], thru,
                                  torch.where(alive[..., None], 0.0, 1.0))
        alive = alive & ok & (beta.amax(-1) > 0.0)
        prev_spec = torch.where(alive, False, prev_spec)
        prev_pdf = torch.where(alive, pdf_s.clamp_min(1e-12), prev_pdf)
        prev_p = torch.where(alive[..., None], p, prev_p)
        o = torch.where(alive[..., None], offset_origin(p, ng, wi_w), o)
        d = torch.where(alive[..., None], wi_w, d)

        # Russian roulette
        rr = beta.amax(-1)
        q = (1.0 - rr).clamp_min(0.05)
        do_rr = (rr < sc.rr_threshold) & alive & (bounce >= RR_START)
        die = do_rr & (ud[6] < q)
        alive = alive & ~die
        den = torch.where(do_rr & ~die, (1.0 - q).clamp_min(1e-6), 1.0)
        beta = torch.where(die[..., None], 0.0, beta / den[..., None])
    L = L.float()
    y = (L * L.new_tensor(Y_WEIGHT)).sum(-1)
    bad = ~torch.isfinite(L).all(-1) | (y < -1e-5)
    return torch.where(bad[..., None], 0.0, L)


def tree_query(tree):
    def query(o, d, tmax, any_hit):
        return bvh.intersect(tree, o, d, tmax, any_hit)
    return query


class Recorder:
    """Ray queries of a first pass kept in call order, so that a second
    pass over a slice of the lanes replays them."""

    def __init__(self, tree):
        self.tree = tree
        self.calls = []

    def record(self, o, d, tmax, any_hit):
        out = bvh.intersect(self.tree, o, d, tmax, any_hit)
        self.calls.append(out)
        return out

    def replay(self, lanes: slice):
        it = iter(self.calls)

        def query(o, d, tmax, any_hit):
            return tuple(x[lanes] for x in next(it))
        return query
