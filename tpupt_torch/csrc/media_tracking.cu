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
// Two entry points:
//   tr_grid_kernel: the grid transmittance of each lane over [0, t_c]
//     (grid.cpp:62 ratio tracking);
//   sample_distance_grid_kernel: (interacted, t) of each lane's delta
//     tracking before t_c (grid.cpp:90).
// The plain versions are media/media.py tr_grid_plain and
// sample_distance_grid_plain. The arithmetic repeats theirs operation for
// operation
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR_STEPS = 32;
constexpr int DISTANCE_STEPS = 64;
constexpr uint32_t TR_WORD = 7919u;
constexpr uint32_t DISTANCE_WORD = 104729u;
constexpr uint32_t REAL_WORD = 1299709u;
constexpr int BLOCK = 128;
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

}  // extern "C"
