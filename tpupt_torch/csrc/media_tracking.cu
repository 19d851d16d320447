// K6: grid-medium tracking, one thread per ray lane.
//
// Replaces no Pallas kernel. The JAX package runs these loops as XLA code
// (tpupt/media/media.py: tr_lane's ratio tracking at :330, the delta
// tracking of sample_distance_lane at :379): 32 and 64 unrolled steps, each
// two hashes, a log and a trilinear lookup of eight texels, which XLA fuses
// on the TPU. Eagerly in PyTorch they are some 400 operations a step, about
// 77,000 launches a volpath iteration of a batch of the fog museum
// (tools/opcount.py); here a launch runs every lane's whole loop.
//
// Three entry points:
//   tr_grid_kernel: the grid transmittance of each lane over [0, t_c]
//     (grid.cpp:62 ratio tracking);
//   sample_distance_grid_kernel: (interacted, t) of each lane's delta
//     tracking before t_c (grid.cpp:90);
//   tr_grid_backward_kernel: the adjoint of ratio tracking for a cotangent
//     of each lane's transmittance (what jax.grad of the JAX package's loop
//     computes): per lane the gradients with respect to o, d, the lane's
//     1 / majorant and mean extinction and its world-to-medium rows, and
//     the density atlas's gradient by atomicAdd into the eight texels of
//     each step.
// The plain versions are media/media.py tr_grid_plain,
// sample_distance_grid_plain and tr_grid_backward_plain. The arithmetic
// repeats theirs operation for operation
// (built with -fmad=false: no a*b+c is contracted), with the same PCG hash
// words (7919, 104729, 1299709) and the per-medium constants 1 / majorant
// and the mean extinction computed by the wrapper on the table, so the
// results are equal to the plain versions' bit for bit on the card
// (chip_smoke.py holds them so; a -fmad=true build is not).
//
// Dead work is skipped: a lane whose `live` byte is 0 (vacuum, or a
// homogeneous medium: the integrator's wheres discard its result) leaves at
// once; a ratio-tracking lane leaves once t has passed t_c (t only grows,
// so every later step multiplies by exactly 1); a delta-tracking lane
// leaves once it interacted or passed t_c (the plain loop freezes it), and
// a step past t_c reads no texel.
//
// What bounds it: the texel gathers (eight dependent loads a step, scattered
// over the density atlas) and the latency of each step's chain; a lane's
// loop cannot be parallelised, so the card is kept busy by lanes alone.
//
// The backward re-walks the forward's steps with the same hash words, so
// its sample points are the forward's to the bit, keeping each step's t,
// sum of draws and the transmittance before it (96 floats of local memory a
// thread), then walks back: a step's factor's cotangent is the
// transmittance before it times the product of the factors after it
// (carried in the cotangent), never trg / f_k, as a factor is exactly 0
// where dens * sig_mean / majorant >= 1. max(x, 0) takes derivative 1/2 at
// x == 0 (an empty texel), as jnp.maximum does. Its atlas gradient is summed
// by atomics in no fixed order (the per-lane outputs are bit-equal to the
// plain version's, the atlas within rounding of the order); it is bound by
// the same gathers plus eight atomics a step, and is a simple first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR_STEPS = 32;
constexpr int DISTANCE_STEPS = 64;
constexpr uint32_t TR_WORD = 7919u;
constexpr uint32_t DISTANCE_WORD = 104729u;
constexpr uint32_t REAL_WORD = 1299709u;
constexpr int BLOCK = 128;
// columns of the backward's per-lane output (media.py TR_BWD_*): g_o (3),
// g_d (3), g_inv_max, g_sig_mean, g_w2m (the first three rows, 12)
constexpr int BWD_COLS = 20;
// float32(1 - 1e-7): the largest uniform float (rng.h OneMinusEpsilon)
constexpr float ONE_MINUS_EPS = 0.99999988079071044921875f;

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return pcg_hash(a ^ (b + 0x9E3779B9u + (a << 6u) + (a >> 2u)));
}

// core/rng.py uniform_float(key, k, word)
__device__ __forceinline__ float uniform3(uint32_t key, uint32_t k,
                                          uint32_t word) {
  uint32_t h = hash_combine(hash_combine(pcg_hash(key), k), word);
  return fminf((float)h * 2.3283064365386963e-10f, ONE_MINUS_EPS);
}

struct Medium {
  const float* w;   // 12 floats: the first three rows of world -> medium
  int nx, ny, nz, off;
};

__device__ __forceinline__ float texel(const float* __restrict__ density,
                                       const Medium& m, int ix, int iy,
                                       int iz) {
  bool inside = ix >= 0 && ix < m.nx && iy >= 0 && iy < m.ny && iz >= 0 &&
                iz < m.nz;
  ix = min(max(ix, 0), m.nx - 1);
  iy = min(max(iy, 0), m.ny - 1);
  iz = min(max(iz, 0), m.nz - 1);
  int idx = m.off + (iz * m.ny + iy) * m.nx + ix;
  return inside ? __ldg(density + idx) : 0.0f;
}

// media.py grid_density_lane at p = o + t * d
__device__ float density_at(const float* __restrict__ density,
                            const Medium& m, float p0, float p1, float p2) {
  const float* w = m.w;
  float ph0 = w[0] * p0 + w[1] * p1 + w[2] * p2 + w[3];
  float ph1 = w[4] * p0 + w[5] * p1 + w[6] * p2 + w[7];
  float ph2 = w[8] * p0 + w[9] * p1 + w[10] * p2 + w[11];
  float g0 = ph0 * (float)m.nx - 0.5f;
  float g1 = ph1 * (float)m.ny - 0.5f;
  float g2 = ph2 * (float)m.nz - 0.5f;
  float gi0 = floorf(g0), gi1 = floorf(g1), gi2 = floorf(g2);
  float fx = g0 - gi0, fy = g1 - gi1, fz = g2 - gi2;
  int ix = (int)gi0, iy = (int)gi1, iz = (int)gi2;
  float d00 = texel(density, m, ix, iy, iz) * (1.0f - fx) +
              texel(density, m, ix + 1, iy, iz) * fx;
  float d10 = texel(density, m, ix, iy + 1, iz) * (1.0f - fx) +
              texel(density, m, ix + 1, iy + 1, iz) * fx;
  float d01 = texel(density, m, ix, iy, iz + 1) * (1.0f - fx) +
              texel(density, m, ix + 1, iy, iz + 1) * fx;
  float d11 = texel(density, m, ix, iy + 1, iz + 1) * (1.0f - fx) +
              texel(density, m, ix + 1, iy + 1, iz + 1) * fx;
  return (d00 * (1.0f - fy) + d10 * fy) * (1.0f - fz) +
         (d01 * (1.0f - fy) + d11 * fy) * fz;
}

// the eight texels of density_at's lookup, x fastest then y, z: values (0
// outside the grid), flat indices and inside flags, and the fractions
struct Corners {
  float v[8];
  int idx[8];
  bool in[8];
  float fx, fy, fz;
};

__device__ void corners_at(const float* __restrict__ density,
                           const Medium& m, float p0, float p1, float p2,
                           Corners& c) {
  const float* w = m.w;
  float ph0 = w[0] * p0 + w[1] * p1 + w[2] * p2 + w[3];
  float ph1 = w[4] * p0 + w[5] * p1 + w[6] * p2 + w[7];
  float ph2 = w[8] * p0 + w[9] * p1 + w[10] * p2 + w[11];
  float g0 = ph0 * (float)m.nx - 0.5f;
  float g1 = ph1 * (float)m.ny - 0.5f;
  float g2 = ph2 * (float)m.nz - 0.5f;
  float gi0 = floorf(g0), gi1 = floorf(g1), gi2 = floorf(g2);
  c.fx = g0 - gi0;
  c.fy = g1 - gi1;
  c.fz = g2 - gi2;
  int ix = (int)gi0, iy = (int)gi1, iz = (int)gi2;
  for (int j = 0; j < 8; ++j) {
    int jx = ix + (j & 1), jy = iy + ((j >> 1) & 1), jz = iz + (j >> 2);
    bool inside = jx >= 0 && jx < m.nx && jy >= 0 && jy < m.ny && jz >= 0 &&
                  jz < m.nz;
    jx = min(max(jx, 0), m.nx - 1);
    jy = min(max(jy, 0), m.ny - 1);
    jz = min(max(jz, 0), m.nz - 1);
    c.idx[j] = m.off + (jz * m.ny + jy) * m.nx + jx;
    c.in[j] = inside;
    c.v[j] = inside ? __ldg(density + c.idx[j]) : 0.0f;
  }
}

struct Tables {
  const float* density;   // flat texel atlas
  const int* dens_off;    // (M,)
  const int* dens_dims;   // (M, 3) nx ny nz
  const float* w2m;       // (M, 16) row-major 4x4
  const float* inv_max;   // (M,) 1 / max(majorant, 1e-9)
  const float* sig_mean;  // (M,) mean of sigma_a + sigma_s over channels
};

struct Lanes {
  const int* mi;          // (N,) medium id, clamped at 0
  const uint8_t* live;    // (N,) lanes whose result is used
  const float* o;         // (N, 3)
  const float* d;         // (N, 3)
  const float* t_c;       // (N,) end of the segment, clamped at 1e7
  const uint32_t* keys;   // (N,) hash keys
  int n;
};

__device__ __forceinline__ Medium medium_of(const Tables& tb, int mi) {
  Medium m;
  m.w = tb.w2m + 16 * mi;
  m.nx = tb.dens_dims[3 * mi];
  m.ny = tb.dens_dims[3 * mi + 1];
  m.nz = tb.dens_dims[3 * mi + 2];
  m.off = tb.dens_off[mi];
  return m;
}

__global__ void __launch_bounds__(BLOCK)
tr_grid_kernel(Tables tb, Lanes ln, float* __restrict__ trg_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= ln.n) return;
  float trg = 1.0f;
  if (ln.live[i]) {
    int mi = ln.mi[i];
    Medium m = medium_of(tb, mi);
    float inv_max = tb.inv_max[mi], sig_mean = tb.sig_mean[mi];
    float o0 = ln.o[3 * i], o1 = ln.o[3 * i + 1], o2 = ln.o[3 * i + 2];
    float d0 = ln.d[3 * i], d1 = ln.d[3 * i + 1], d2 = ln.d[3 * i + 2];
    float t_c = ln.t_c[i];
    uint32_t key = ln.keys[i];
    float t = 0.0f;
    for (int k = 0; k < TR_STEPS; ++k) {
      float u = uniform3(key, (uint32_t)k, TR_WORD);
      t = t - logf(1.0f - u) * inv_max;
      if (!(t < t_c)) break;
      float dens = density_at(tb.density, m, o0 + t * d0, o1 + t * d1,
                              o2 + t * d2);
      trg = trg * (1.0f - fmaxf(dens * sig_mean * inv_max, 0.0f));
    }
  }
  trg_out[i] = trg;
}

__global__ void __launch_bounds__(BLOCK)
sample_distance_grid_kernel(Tables tb, Lanes ln,
                            uint8_t* __restrict__ inter_out,
                            float* __restrict__ t_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= ln.n) return;
  bool interacted = false;
  float t = 0.0f;
  if (ln.live[i]) {
    int mi = ln.mi[i];
    Medium m = medium_of(tb, mi);
    float inv_max = tb.inv_max[mi], sig_mean = tb.sig_mean[mi];
    float o0 = ln.o[3 * i], o1 = ln.o[3 * i + 1], o2 = ln.o[3 * i + 2];
    float d0 = ln.d[3 * i], d1 = ln.d[3 * i + 1], d2 = ln.d[3 * i + 2];
    float t_c = ln.t_c[i];
    uint32_t key = ln.keys[i];
    for (int k = 0; k < DISTANCE_STEPS; ++k) {
      float u = uniform3(key, (uint32_t)k, DISTANCE_WORD);
      t = t - logf(1.0f - u) * inv_max;
      if (t >= t_c) break;
      float dens = density_at(tb.density, m, o0 + t * d0, o1 + t * d1,
                              o2 + t * d2);
      float u2 = uniform3(key, (uint32_t)k, REAL_WORD);
      if (u2 < dens * sig_mean * inv_max) {
        interacted = true;
        break;
      }
    }
  }
  inter_out[i] = interacted ? 1 : 0;
  t_out[i] = t;
}

__global__ void __launch_bounds__(BLOCK)
tr_grid_backward_kernel(Tables tb, Lanes ln, const float* __restrict__ g_trg,
                        float* __restrict__ g_lane,
                        float* __restrict__ g_density) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= ln.n) return;
  float acc[BWD_COLS];
  for (int j = 0; j < BWD_COLS; ++j) acc[j] = 0.0f;
  if (ln.live[i]) {
    int mi = ln.mi[i];
    Medium m = medium_of(tb, mi);
    float inv_max = tb.inv_max[mi], sig_mean = tb.sig_mean[mi];
    float o[3] = {ln.o[3 * i], ln.o[3 * i + 1], ln.o[3 * i + 2]};
    float d[3] = {ln.d[3 * i], ln.d[3 * i + 1], ln.d[3 * i + 2]};
    float t_c = ln.t_c[i];
    uint32_t key = ln.keys[i];
    // the forward walk: each step's t, sum of draws and the transmittance
    // before it, up to the step that passes t_c
    float ts[TR_STEPS], ss[TR_STEPS], ps[TR_STEPS];
    float trg = 1.0f, t = 0.0f, s = 0.0f;
    int steps = 0;
    for (int k = 0; k < TR_STEPS; ++k) {
      float u = uniform3(key, (uint32_t)k, TR_WORD);
      float lg = logf(1.0f - u);
      t = t - lg * inv_max;
      s = s - lg;
      if (!(t < t_c)) break;
      float dens = density_at(tb.density, m, o[0] + t * d[0],
                              o[1] + t * d[1], o[2] + t * d[2]);
      ts[k] = t;
      ss[k] = s;
      ps[k] = trg;
      trg = trg * (1.0f - fmaxf(dens * sig_mean * inv_max, 0.0f));
      steps = k + 1;
    }
    // the walk back; c is the cotangent times the factors after step k
    float c = g_trg[i];
    const float* w = m.w;
    for (int k = steps - 1; k >= 0; --k) {
      float tk = ts[k];
      float p[3] = {o[0] + tk * d[0], o[1] + tk * d[1], o[2] + tk * d[2]};
      Corners cn;
      corners_at(tb.density, m, p[0], p[1], p[2], cn);
      const float* tv = cn.v;
      float fx = cn.fx, fy = cn.fy, fz = cn.fz;
      float ex = 1.0f - fx, ey = 1.0f - fy, ez = 1.0f - fz;
      float d00 = tv[0] * ex + tv[1] * fx;
      float d10 = tv[2] * ex + tv[3] * fx;
      float d01 = tv[4] * ex + tv[5] * fx;
      float d11 = tv[6] * ex + tv[7] * fx;
      float lo = d00 * ey + d10 * fy;
      float hi = d01 * ey + d11 * fy;
      float dens = lo * ez + hi * fz;
      float a = dens * sig_mean;
      float x = a * inv_max;
      float f = 1.0f - fmaxf(x, 0.0f);
      float gf = c * ps[k];
      c = c * f;
      float msk = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
      float gx = -(gf * msk);
      acc[6] = acc[6] + gx * a;
      float ga = gx * inv_max;
      acc[7] = acc[7] + ga * dens;
      float gdn = ga * sig_mean;
      float glo = gdn * ez;
      float ghi = gdn * fz;
      float gfz = gdn * (hi - lo);
      float gd[4] = {glo * ey, glo * fy, ghi * ey, ghi * fy};
      float gfy = glo * (d10 - d00) + ghi * (d11 - d01);
      float gfx = gd[0] * (tv[1] - tv[0]) + gd[1] * (tv[3] - tv[2]) +
                  gd[2] * (tv[5] - tv[4]) + gd[3] * (tv[7] - tv[6]);
      for (int j = 0; j < 8; ++j) {
        if (cn.in[j]) {
          atomicAdd(g_density + cn.idx[j], gd[j >> 1] * ((j & 1) ? fx : ex));
        }
      }
      float gph[3] = {gfx * (float)m.nx, gfy * (float)m.ny,
                      gfz * (float)m.nz};
      for (int r = 0; r < 3; ++r) {
        for (int col = 0; col < 3; ++col) {
          acc[8 + 4 * r + col] = acc[8 + 4 * r + col] + gph[r] * p[col];
        }
        acc[8 + 4 * r + 3] = acc[8 + 4 * r + 3] + gph[r];
      }
      float gp[3];
      for (int col = 0; col < 3; ++col) {
        gp[col] = gph[0] * w[col] + gph[1] * w[4 + col] + gph[2] * w[8 + col];
      }
      for (int col = 0; col < 3; ++col) {
        acc[col] = acc[col] + gp[col];
        acc[3 + col] = acc[3 + col] + gp[col] * tk;
      }
      float gt = gp[0] * d[0] + gp[1] * d[1] + gp[2] * d[2];
      acc[6] = acc[6] + gt * ss[k];
    }
  }
  for (int j = 0; j < BWD_COLS; ++j) g_lane[BWD_COLS * i + j] = acc[j];
}

Tables tables(const float* density, const int* dens_off, const int* dens_dims,
              const float* w2m, const float* inv_max, const float* sig_mean) {
  return Tables{density, dens_off, dens_dims, w2m, inv_max, sig_mean};
}

Lanes lanes(const int* mi, const uint8_t* live, const float* o,
            const float* d, const float* t_c, const uint32_t* keys, int n) {
  return Lanes{mi, live, o, d, t_c, keys, n};
}

}  // namespace

extern "C" {

// Each returns the CUDA error of the launch (0 on success); n > 0.
int tpupt_tr_grid(const float* density, const int* dens_off,
                      const int* dens_dims, const float* w2m,
                      const float* inv_max, const float* sig_mean,
                      const int* mi, const uint8_t* live, const float* o,
                      const float* d, const float* t_c, const uint32_t* keys,
                      int n, float* trg, void* stream) {
  tr_grid_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      tables(density, dens_off, dens_dims, w2m, inv_max, sig_mean),
      lanes(mi, live, o, d, t_c, keys, n), trg);
  return (int)cudaGetLastError();
}

int tpupt_sample_distance_grid(const float* density, const int* dens_off,
                      const int* dens_dims, const float* w2m,
                      const float* inv_max, const float* sig_mean,
                      const int* mi, const uint8_t* live, const float* o,
                      const float* d, const float* t_c, const uint32_t* keys,
                      int n, uint8_t* interacted, float* t, void* stream) {
  sample_distance_grid_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      tables(density, dens_off, dens_dims, w2m, inv_max, sig_mean),
      lanes(mi, live, o, d, t_c, keys, n), interacted, t);
  return (int)cudaGetLastError();
}

// g_density holds zeros (or a sum to add to) on entry
int tpupt_tr_grid_backward(const float* density, const int* dens_off,
                      const int* dens_dims, const float* w2m,
                      const float* inv_max, const float* sig_mean,
                      const int* mi, const uint8_t* live, const float* o,
                      const float* d, const float* t_c, const uint32_t* keys,
                      int n, const float* g_trg, float* g_lane,
                      float* g_density, void* stream) {
  tr_grid_backward_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      tables(density, dens_off, dens_dims, w2m, inv_max, sig_mean),
      lanes(mi, live, o, d, t_c, keys, n), g_trg, g_lane, g_density);
  return (int)cudaGetLastError();
}

}  // extern "C"
