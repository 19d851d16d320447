// Device code shared by the wide-BVH traversal kernels (traverse_wide.cu,
// traverse_treelets.cu, traverse_requeue.cu): the ray set-up, one
// interior-node step (8 slab tests, sort, push) and one leaf step
// (watertight triangle / unified quadric tests over packed prim rows). Each function repeats, operation for
// operation, its counterpart in tpupt_torch/accel/traverse.py
// (`_interior_step`, `_leaf_step`) and tpupt_torch/shapes/; built with
// -fmad=false the kernels equal the plain walkers bit for bit. Keep them in
// step.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WIDE_STACK 48
#define META_EMPTY ((int)0x80000000)
#define BIG_KEY 3.0e38f
#define TWO_PI_D 6.283185307179586
#define PI_D 3.141592653589793

namespace {

__device__ __forceinline__ float sel3(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

// torch.maximum / torch.minimum on finite values and infinities
__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}
__device__ __forceinline__ float min3(float a, float b, float c) {
  return fminf(fminf(a, b), c);
}

struct RayConst {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;        // guarded reciprocal direction (vecmath.ray_inv_d)
  int kx, ky, kz;          // watertight permutation
  float sx, sy, sz;        // shear
};

__device__ __forceinline__ float inv_guarded(float d) {
  if (fabsf(d) < 1e-30f) {
    float sgn = (d > 0.0f) ? 1.0f : ((d < 0.0f) ? -1.0f : 0.0f);
    return sgn * 1e30f + 1e30f;
  }
  return 1.0f / d;
}

// shapes/triangle.py intersect_triangle, one ray against one triangle
__device__ __forceinline__ bool tri_test(const RayConst& r, float4 q0,
                                         float4 q1, float4 q2, float tcur,
                                         float* tt, float* tb1, float* tb2) {
  // q0 = p0.xyz p1.x ; q1 = p1.yz p2.xy ; q2.x = p2.z
  float a0x_ = q0.x - r.ox, a0y_ = q0.y - r.oy, a0z_ = q0.z - r.oz;
  float a1x_ = q0.w - r.ox, a1y_ = q1.x - r.oy, a1z_ = q1.y - r.oz;
  float a2x_ = q1.z - r.ox, a2y_ = q1.w - r.oy, a2z_ = q2.x - r.oz;
  float a0x = sel3(a0x_, a0y_, a0z_, r.kx), a0y = sel3(a0x_, a0y_, a0z_, r.ky),
        a0z = sel3(a0x_, a0y_, a0z_, r.kz);
  float a1x = sel3(a1x_, a1y_, a1z_, r.kx), a1y = sel3(a1x_, a1y_, a1z_, r.ky),
        a1z = sel3(a1x_, a1y_, a1z_, r.kz);
  float a2x = sel3(a2x_, a2y_, a2z_, r.kx), a2y = sel3(a2x_, a2y_, a2z_, r.ky),
        a2z = sel3(a2x_, a2y_, a2z_, r.kz);

  float x0 = a0x - r.sx * a0z, y0 = a0y - r.sy * a0z;
  float x1 = a1x - r.sx * a1z, y1 = a1y - r.sy * a1z;
  float x2 = a2x - r.sx * a2z, y2 = a2y - r.sy * a2z;

  float e0 = x1 * y2 - y1 * x2;
  float e1 = x2 * y0 - y2 * x0;
  float e2 = x0 * y1 - y0 * x1;
  // No double-precision recompute on a zero edge function: the JAX package's
  // float64 cast is a no-op (64-bit mode is never enabled there), and this
  // port matches it.
  bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                   (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  float det = e0 + e1 + e2;
  float z0 = r.sz * a0z, z1 = r.sz * a1z, z2 = r.sz * a2z;
  float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
  float lim = tcur * det;
  bool t_ok = (det > 0.0f) ? (t_scaled > 0.0f && t_scaled < lim)
                           : (t_scaled < 0.0f && t_scaled > lim);
  bool hit = same_sign && (det != 0.0f) && t_ok;
  float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  *tt = t_scaled * inv_det;
  *tb1 = e1 * inv_det;
  *tb2 = e2 * inv_det;
  return hit;
}

struct Quadric {
  float kind, r, zmin, zmax, phimax, q1, q2, sin_pm, cos_pm;
  float ox, oy, oz, dx, dy, dz;  // ray in object space
};

__device__ __forceinline__ bool quadric_clipped(const Quadric& s, float t,
                                                float tcur, bool is_disk) {
  bool finite = isfinite(t);
  float ts = finite ? t : 0.0f;
  float px = s.ox + ts * s.dx;
  float py = s.oy + ts * s.dy;
  float pz = s.oz + ts * s.dz;
  bool ok = finite && (t > 1e-4f) && (t < tcur);
  ok = ok && (is_disk || (pz >= s.zmin && pz <= s.zmax));
  float d2 = px * px + py * py;
  ok = ok && (!is_disk || (d2 <= s.r * s.r && d2 >= s.q1 * s.q1));
  bool partial = s.phimax < (float)(TWO_PI_D - 1e-6);
  bool ccw = (px * s.sin_pm - py * s.cos_pm) >= 0.0f;
  bool upper = py >= 0.0f;
  bool le_pi = s.phimax <= (float)PI_D;
  bool in_wedge = (le_pi && upper && ccw) || (!le_pi && (upper || ccw));
  return ok && (!partial || in_wedge);
}

// shapes/quadric.py quadric_test_parts: (hit, t) of the closest valid root
__device__ __forceinline__ bool quadric_test(const Quadric& s, float tcur,
                                             float* t_out) {
  const float inf = INFINITY;
  float dxy2 = s.dx * s.dx + s.dy * s.dy;
  float oxy_dxy = s.ox * s.dx + s.oy * s.dy;
  float oxy2 = s.ox * s.ox + s.oy * s.oy;
  bool is_s = s.kind == 0.0f, is_cy = s.kind == 1.0f, is_disk = s.kind == 2.0f,
       is_co = s.kind == 3.0f, is_pa = s.kind == 4.0f, is_hy = s.kind == 5.0f;
  float h = s.zmax;
  float rk = s.r / (h != 0.0f ? h : 1.0f);
  float kc = rk * rk;
  float zh = s.oz - h;
  float a, b, c;
  if (is_s) {
    a = dxy2 + s.dz * s.dz;
    b = 2.0f * (oxy_dxy + s.oz * s.dz);
    c = oxy2 + s.oz * s.oz - s.r * s.r;
  } else if (is_cy) {
    a = dxy2;
    b = 2.0f * oxy_dxy;
    c = oxy2 - s.r * s.r;
  } else if (is_co) {
    a = dxy2 - kc * s.dz * s.dz;
    b = 2.0f * (oxy_dxy - kc * s.dz * zh);
    c = oxy2 - kc * zh * zh;
  } else if (is_pa) {
    a = s.q1 * dxy2;
    b = 2.0f * s.q1 * oxy_dxy - s.dz;
    c = s.q1 * oxy2 - s.oz;
  } else if (is_hy) {
    a = s.q1 * dxy2 - s.q2 * s.dz * s.dz;
    b = 2.0f * (s.q1 * oxy_dxy - s.q2 * s.oz * s.dz);
    c = s.q1 * oxy2 - s.q2 * s.oz * s.oz - 1.0f;
  } else {
    a = 1.0f;
    b = 0.0f;
    c = 0.0f;
  }
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float qq = -0.5f * (b + (b < 0.0f ? -sq : sq));
  bool a_ok = fabsf(a) > 1e-12f;
  bool q_ok = fabsf(qq) > 1e-30f;
  float ra = qq / (a_ok ? a : 1.0f);
  float rc = c / (q_ok ? qq : 1.0f);
  ra = a_ok ? ra : inf;
  rc = q_ok ? rc : inf;
  float t0 = fminf(ra, rc);
  float t1 = fmaxf(ra, rc);
  bool b_ok = fabsf(b) > 1e-20f;
  float tl = -c / (b_ok ? b : 1.0f);
  bool lin = !a_ok && b_ok;
  t0 = lin ? tl : t0;
  t1 = lin ? inf : t1;
  bool quad_valid = (disc >= 0.0f) && (a_ok || b_ok) && !is_disk;

  bool dz_ok = fabsf(s.dz) > 1e-12f;
  float td = (s.zmin - s.oz) / (dz_ok ? s.dz : 1.0f);
  t0 = is_disk ? (dz_ok ? td : inf) : t0;
  t1 = is_disk ? inf : t1;
  bool valid = quad_valid || (is_disk && dz_ok);

  bool ok0 = valid && quadric_clipped(s, t0, tcur, is_disk);
  bool ok1 = valid && !ok0 && quadric_clipped(s, t1, tcur, is_disk);
  *t_out = ok0 ? t0 : t1;
  return ok0 || ok1;
}

// vecmath.ray_inv_d and shapes/triangle.py ray_permutation of ray i
__device__ __forceinline__ void ray_setup(const float* __restrict__ o,
                                          const float* __restrict__ d, int i,
                                          RayConst& r) {
  r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = inv_guarded(r.dx); r.iy = inv_guarded(r.dy); r.iz = inv_guarded(r.dz);
  float ax = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
  // first maximum, as ray_permutation spells it out
  r.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  int kx = (r.kz + 1) % 3;
  int ky = (kx + 1) % 3;
  float dzp = sel3(r.dx, r.dy, r.dz, r.kz);
  bool swap = dzp < 0.0f;
  r.kx = swap ? ky : kx;
  r.ky = swap ? kx : ky;
  r.sx = sel3(r.dx, r.dy, r.dz, r.kx) / dzp;
  r.sy = sel3(r.dx, r.dy, r.dz, r.ky) / dzp;
  r.sz = 1.0f / dzp;
}

// One interior node: its 256-byte row (14 of its 16 float4 are read), 8 slab
// tests, children ordered near-first and pushed far-to-near. A push past
// WIDE_STACK is not written; `sp_max` records the deepest request.
__device__ __forceinline__ void node_step(const float4* __restrict__ row,
                                          const RayConst& r, float tcur,
                                          int* stack, int& sp, int& sp_max) {
  float bounds[48];
#pragma unroll
  for (int q = 0; q < 12; q++) {
    float4 v = __ldg(row + q);
    bounds[4 * q + 0] = v.x; bounds[4 * q + 1] = v.y;
    bounds[4 * q + 2] = v.z; bounds[4 * q + 3] = v.w;
  }
  float4 m0 = __ldg(row + 12), m1 = __ldg(row + 13);
  int metas[8] = {__float_as_int(m0.x), __float_as_int(m0.y),
                  __float_as_int(m0.z), __float_as_int(m0.w),
                  __float_as_int(m1.x), __float_as_int(m1.y),
                  __float_as_int(m1.z), __float_as_int(m1.w)};
  float keys[8];
#pragma unroll
  for (int c = 0; c < 8; c++) {
    float tlx = (bounds[6 * c + 0] - r.ox) * r.ix;
    float tly = (bounds[6 * c + 1] - r.oy) * r.iy;
    float tlz = (bounds[6 * c + 2] - r.oz) * r.iz;
    float thx = (bounds[6 * c + 3] - r.ox) * r.ix;
    float thy = (bounds[6 * c + 4] - r.oy) * r.iy;
    float thz = (bounds[6 * c + 5] - r.oz) * r.iz;
    float t_near = max3(fminf(tlx, thx), fminf(tly, thy), fminf(tlz, thz));
    float t_far = min3(fmaxf(tlx, thx), fmaxf(tly, thy), fmaxf(tlz, thz))
                  * 1.0000004f;
    bool ok = (t_near <= t_far) && (t_far > 0.0f) && (t_near < tcur) &&
              (metas[c] != META_EMPTY);
    keys[c] = ok ? fmaxf(t_near, 0.0f) : BIG_KEY;
  }
  // sort descending by key (farthest first): the nearest is pushed last and
  // popped first. Same 19-comparator network as _SORT8.
#define CSWAP(A, B)                                       \
  {                                                       \
    bool sw = keys[A] < keys[B];                          \
    float ka = sw ? keys[B] : keys[A];                    \
    float kb = sw ? keys[A] : keys[B];                    \
    int ma = sw ? metas[B] : metas[A];                    \
    int mb = sw ? metas[A] : metas[B];                    \
    keys[A] = ka; keys[B] = kb; metas[A] = ma; metas[B] = mb; \
  }
  CSWAP(0, 1) CSWAP(2, 3) CSWAP(4, 5) CSWAP(6, 7) CSWAP(0, 2) CSWAP(1, 3)
  CSWAP(4, 6) CSWAP(5, 7) CSWAP(1, 2) CSWAP(5, 6) CSWAP(0, 4) CSWAP(3, 7)
  CSWAP(1, 5) CSWAP(2, 6) CSWAP(1, 4) CSWAP(3, 6) CSWAP(2, 4) CSWAP(3, 5)
  CSWAP(3, 4)
#undef CSWAP
#pragma unroll
  for (int c = 0; c < 8; c++) {
    if (keys[c] < BIG_KEY) {
      if (sp < WIDE_STACK) stack[sp] = metas[c];
      sp++;
    }
  }
  sp_max = max(sp_max, sp);
  // an overflow is reported by the caller through `sp_max`; entries past the
  // end were not written, and the walk goes on without them
  if (sp > WIDE_STACK) sp = WIDE_STACK;
}

struct HitRec {
  float t;
  int gid, ridx;
  float b1, b2;
  int n_nodes, n_leaves, n_tests;
};

// One leaf: `count` packed 128-byte prim rows from row `first` of
// `prim_rows` (4 float4 of a triangle row are read, 7 of a quadric row).
// With HAS_MOTION a triangle row's 48-byte delta row of `prim_dt` (three
// float4 in the layout of the row's first three: dp0.xyz dp1.x | dp1.yz
// dp2.xy | dp2.z, pad) is read too and its vertices are lerped to v + tm * dv
// at the ray's shutter time `tm` before the test.
template <bool HAS_SPHERES, bool WITH_STATS, bool HAS_MOTION = false>
__device__ __forceinline__ void leaf_step(const float4* __restrict__ prim_rows,
                                          int n_rows, int first, int count,
                                          const RayConst& r, HitRec& h,
                                          const float4* __restrict__ prim_dt =
                                              nullptr,
                                          float tm = 0.0f) {
  for (int k = 0; k < count; k++) {
    int idx = min(first + k, n_rows - 1);
    const float4* prow = prim_rows + (size_t)idx * 8;
    if (WITH_STATS) h.n_tests++;
    float4 p4 = __ldg(prow + 4);  // cols 16-19: gid, is_tri, (float copies)
    int p_gid = __float_as_int(p4.x);
    bool p_is_tri = __float_as_int(p4.y) == 1;
    float4 q0 = __ldg(prow + 0), q1 = __ldg(prow + 1), q2 = __ldg(prow + 2);
    if (p_is_tri) {
      if (HAS_MOTION) {
        const float4* drow = prim_dt + (size_t)idx * 3;
        float4 d0 = __ldg(drow + 0), d1 = __ldg(drow + 1), d2 = __ldg(drow + 2);
        q0.x = q0.x + tm * d0.x; q0.y = q0.y + tm * d0.y;
        q0.z = q0.z + tm * d0.z; q0.w = q0.w + tm * d0.w;
        q1.x = q1.x + tm * d1.x; q1.y = q1.y + tm * d1.y;
        q1.z = q1.z + tm * d1.z; q1.w = q1.w + tm * d1.w;
        q2.x = q2.x + tm * d2.x;
      }
      float tt, tb1, tb2;
      bool hit = tri_test(r, q0, q1, q2, h.t, &tt, &tb1, &tb2);
      if (hit && tt > 1e-6f && tt < h.t) {
        h.t = tt; h.gid = p_gid; h.ridx = idx; h.b1 = tb1; h.b2 = tb2;
      }
    } else if (HAS_SPHERES) {
      float4 q3 = __ldg(prow + 3), q5 = __ldg(prow + 5), q6 = __ldg(prow + 6);
      Quadric s;
      // w2o 3x4 row-major in cols 0-11
      s.ox = q0.x * r.ox + q0.y * r.oy + q0.z * r.oz + q0.w;
      s.oy = q1.x * r.ox + q1.y * r.oy + q1.z * r.oz + q1.w;
      s.oz = q2.x * r.ox + q2.y * r.oy + q2.z * r.oz + q2.w;
      s.dx = q0.x * r.dx + q0.y * r.dy + q0.z * r.dz;
      s.dy = q1.x * r.dx + q1.y * r.dy + q1.z * r.dz;
      s.dz = q2.x * r.dx + q2.y * r.dy + q2.z * r.dz;
      s.r = q3.x; s.zmin = q3.y; s.zmax = q3.z; s.phimax = q3.w;
      s.kind = q5.x; s.q1 = q5.y; s.q2 = q5.z; s.sin_pm = q5.w;
      s.cos_pm = q6.x;
      float ts;
      bool hit = quadric_test(s, h.t, &ts);
      if (hit && ts < h.t) {
        h.t = ts; h.gid = p_gid; h.ridx = idx;
      }
    }
  }
}

// Writes a ray's record; the counters only with WITH_STATS.
template <bool WITH_STATS>
__device__ __forceinline__ void store_hit(
    int i, const HitRec& h, float* __restrict__ t_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out,
    int* __restrict__ gid_out, int* __restrict__ ridx_out,
    int* __restrict__ nodes_out, int* __restrict__ leaves_out,
    int* __restrict__ tests_out) {
  t_out[i] = h.t;
  b1_out[i] = h.b1;
  b2_out[i] = h.b2;
  gid_out[i] = h.gid;
  ridx_out[i] = h.ridx;
  if (WITH_STATS) {
    nodes_out[i] = h.n_nodes;
    leaves_out[i] = h.n_leaves;
    tests_out[i] = h.n_tests;
  }
}

}  // namespace
