// The two kernels of the re-queue traversal for Hopper: the two-level
// traversal regrouped by treelet, for incoherent bounce rays over scenes
// with two-level tables (tpupt_torch/accel/treelets.py). The driver that
// sorts and combines between them is tpupt_torch/ops/traverse_requeue.py.
//
// bin_rays replaces the TPU kernel tpupt/ops/traverse_requeue.py
// `_kernel_top_perlane` (entry `_bin_rays`). That kernel walks the top tree
// once per 1024-ray packet on a scalar stack and records, lane by lane,
// every treelet whose box the lane's ray enters. Here ONE THREAD WALKS ONE
// RAY through the top tree on its own stack of WIDE_STACK ints. It pops the
// node pushed last, takes the node's 8 slots in slot order and pushes only
// the children its ray hits, also in slot order, with no near-first sort: a
// child box a ray hits lies inside a parent box it hits (the slab bounds and
// their rounding are monotone), so this visits the ray's treelets in exactly
// the order of the TPU lane, and a list that overflows keeps the same
// records. Up to `r_list` (treelet id, max(t_near, 0)) records are written;
// the rest are only counted. A dead ray (tmax 0) leaves at once with an
// empty list.
//
// walk_pairs replaces the TPU kernel tpupt/ops/traverse_requeue.py
// `_kernel_chunk` (entry `_walk_chunks`). That kernel takes 1024-lane chunks
// of (ray, treelet) pairs sorted by (treelet, direction octant), at most 16
// treelets a chunk, copies each treelet's padded node and prim blocks into
// on-chip memory and walks the block for the whole chunk with any-lane
// voting, parking the lanes of other treelets. Here ONE THREAD WALKS ONE
// PAIR: it reads its ray by ray id (no gathered copies of the ray fields),
// reads the treelet's first node row and prim row (one int2 of
// `tl_offsets`) and walks the treelet from its local root, starting from the
// pass's best t of its ray, with the node step and leaf step of
// traverse_treelets.cu. The pairs are sorted by treelet, so the threads of a
// warp walk the same treelet: that is the Hopper form of the TPU's
// same-treelet chunk, the treelet's rows are read by a warp together and
// stay in L1/L2. One thread a pair defers nothing, so the TPU's third pass
// (for pairs a chunk could not take) has no counterpart. Threads whose pair
// has no work (sentinel key) write the pair's empty record and leave.
//
// What bounds them: bin_rays reads a few hundred top rows that every ray
// shares (they stay in L1/L2) and writes 8 bytes a record, uncoalesced (one
// row of `r_list` records a thread); walk_pairs is bound like
// traverse_treelets.cu by dependent, random 256-byte node-row and 128-byte
// prim-row gathers, latency and divergence, with the byte and operation
// bounds far below the measured time. Staging a treelet in shared memory for
// the warps that walk it is left for later work: a treelet is up to 512 x
// 256 B of nodes plus 4096 x 128 B of prims, larger than a block's 227 KB.
//
// Semantics are those of the plain PyTorch versions
// tpupt_torch/accel/traverse.py `bin_rays` and `walk_pairs`, operation for
// operation: built with -fmad=false the kernels equal them bit for bit,
// counters included. Keep them in step.

#include "traverse_common.cuh"

namespace {

__global__ void __launch_bounds__(128)
bin_rays_kernel(const float4* __restrict__ top_nodes,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax, int n, int r_list,
                int* __restrict__ tid_out, float* __restrict__ tn_out,
                int* __restrict__ ovf_out, int* __restrict__ deepest) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int* tid_row = tid_out + (size_t)i * r_list;
  float* tn_row = tn_out + (size_t)i * r_list;
  float tm = tmax[i];
  int cnt = 0;

  // dead lanes (tmax == 0) leave with an empty list
  if (tm > 0.0f) {
    RayConst r;
    ray_setup(o, d, i, r);
    int stack[WIDE_STACK];
    int sp = 1;
    int sp_max = 1;
    stack[0] = 0;  // top node id 0
    while (sp > 0) {
      const float4* row = top_nodes + (size_t)stack[--sp] * 16;
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
      // slot order: records and pushes follow the TPU lane's order
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
        int m = metas[c];
        bool hit = (t_near <= t_far) && (t_far > 0.0f) && (t_near < tm) &&
                   (m != META_EMPTY);
        if (!hit) continue;
        if (m < 0) {  // treelet reference -(tid) - 1
          if (cnt < r_list) {
            tid_row[cnt] = -m - 1;
            tn_row[cnt] = t_near > 0.0f ? t_near : 0.0f;
          }
          cnt++;
        } else {
          if (sp < WIDE_STACK) stack[sp] = m;
          sp++;
          sp_max = max(sp_max, sp);
          // a push past the end is dropped and reported through `deepest`
          if (sp > WIDE_STACK) sp = WIDE_STACK;
        }
      }
    }
    if (sp_max > WIDE_STACK) atomicMax(deepest, sp_max);
  }
  for (int k = cnt; k < r_list; k++) {
    tid_row[k] = -1;
    tn_row[k] = BIG_KEY;
  }
  ovf_out[i] = max(cnt - r_list, 0);
}

template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS>
__global__ void __launch_bounds__(128)
walk_pairs_kernel(const float4* __restrict__ tl_nodes,
                  const float4* __restrict__ tl_prims, int n_rows,
                  const int2* __restrict__ tl_offsets,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ key, const int* __restrict__ ray,
                  const float* __restrict__ t_in, int p, int sentinel,
                  float* __restrict__ t_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ gid_out,
                  int* __restrict__ ridx_out, int* __restrict__ nodes_out,
                  int* __restrict__ leaves_out, int* __restrict__ tests_out,
                  int* __restrict__ deepest) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int k = key[i];
  int ri = ray[i];
  HitRec h = {t_in[ri], -1, 0, 0.0f, 0.0f, 0, 0, 0};

  if (k < sentinel) {
    RayConst r;
    ray_setup(o, d, ri, r);
    int2 off = __ldg(tl_offsets + (k >> 3));
    const float4* nodes = tl_nodes + (size_t)off.x * 16;
    int stack[WIDE_STACK];
    int sp = 1;
    int sp_max = 1;
    stack[0] = 0;  // the treelet's local root
    while (sp > 0) {
      int raw = stack[--sp];
      if (raw >= 0) {
        if (WITH_STATS) h.n_nodes++;
        node_step(nodes + (size_t)raw * 16, r, h.t, stack, sp, sp_max);
      } else {
        if (WITH_STATS) h.n_leaves++;
        int v = -raw - 1;
        leaf_step<HAS_SPHERES, WITH_STATS>(tl_prims, n_rows,
                                           off.y + (v >> 6), v & 63, r, h);
      }
      if (ANY_HIT && h.gid >= 0) break;
    }
    if (sp_max > WIDE_STACK) atomicMax(deepest, sp_max);
  }
  store_hit<WITH_STATS>(i, h, t_out, b1_out, b2_out, gid_out, ridx_out,
                        nodes_out, leaves_out, tests_out);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing. All arrays
// are contiguous device memory: top_nodes (Ntop,64) f32, o/d (N,3) f32, tmax
// (N,) f32; outputs tid (N,r_list) i32, tnear (N,r_list) f32, ovf (N,) i32.
// `deepest` is one int that receives the deepest stack any ray asked for
// when that exceeds WIDE_STACK. Returns cudaGetLastError().
extern "C" int tpupt_bin_rays(const void* top_nodes, const void* o,
                              const void* d, const void* tmax, int n,
                              int r_list, void* tid_out, void* tn_out,
                              void* ovf_out, void* deepest, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bin_rays_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)top_nodes, (const float*)o, (const float*)d,
      (const float*)tmax, n, r_list, (int*)tid_out, (float*)tn_out,
      (int*)ovf_out, (int*)deepest);
  return (int)cudaGetLastError();
}

// Launches on `stream`, does not synchronise, allocates nothing. tl_nodes
// (Nt,64) f32, tl_prims (P,32) f32, tl_offsets (NT,2) i32, o/d (N,3) f32,
// key/ray (Np,) i32, t_in (N,) f32; outputs (Np,). A pair whose key is not
// below `sentinel` has no work. nodes/leaves/tests are written only with
// with_stats. `ridx` is the winning row of tl_prims. Returns
// cudaGetLastError().
extern "C" int tpupt_walk_pairs(
    const void* tl_nodes, const void* tl_prims, int n_rows,
    const void* tl_offsets, const void* o, const void* d, const void* key,
    const void* ray, const void* t_in, int p, int sentinel, void* t_out,
    void* b1_out, void* b2_out, void* gid_out, void* ridx_out,
    void* nodes_out, void* leaves_out, void* tests_out, void* deepest,
    int any_hit, int has_spheres, int with_stats, void* stream) {
  if (p <= 0) return 0;
  const int threads = 128;
  const int blocks = (p + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(A, H, W)                                                       \
  walk_pairs_kernel<A, H, W><<<blocks, threads, 0, s>>>(                      \
      (const float4*)tl_nodes, (const float4*)tl_prims, n_rows,               \
      (const int2*)tl_offsets, (const float*)o, (const float*)d,              \
      (const int*)key, (const int*)ray, (const float*)t_in, p, sentinel,      \
      (float*)t_out, (float*)b1_out, (float*)b2_out, (int*)gid_out,           \
      (int*)ridx_out, (int*)nodes_out, (int*)leaves_out, (int*)tests_out,     \
      (int*)deepest)
  int k = (any_hit ? 4 : 0) | (has_spheres ? 2 : 0) | (with_stats ? 1 : 0);
  switch (k) {
    case 0: LAUNCH(false, false, false); break;
    case 1: LAUNCH(false, false, true); break;
    case 2: LAUNCH(false, true, false); break;
    case 3: LAUNCH(false, true, true); break;
    case 4: LAUNCH(true, false, false); break;
    case 5: LAUNCH(true, false, true); break;
    case 6: LAUNCH(true, true, false); break;
    default: LAUNCH(true, true, true); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
