// Wide-BVH traversal for Hopper: closest hit, or first occluder found, of
// every ray of a wavefront batch in the 8-wide BVH.
//
// Replaces the TPU kernel tpupt/ops/traverse_pallas.py `_kernel` (around
// `traverse_loop`, entry `intersect_packets`). That kernel walks 1024-ray
// packets with one scalar stack per packet, any-lane voting and float-coded
// node tiles, because the TPU cannot gather per lane. None of that is carried
// over: here ONE THREAD WALKS ONE RAY with its own stack of WIDE_STACK ints
// in local memory, reads the (Nw,64) float rows of `wide_nodes` (bounds in
// cols 0-47, int32 meta bit-cast in cols 48-55) and the (P,32) float rows of
// `prim_rows` (int32 gid / is-triangle in cols 16/17) straight from device
// memory, and takes any number of rays.
//
// What bounds it: every step of every ray gathers one random 256-byte node
// row or 128-byte prim rows, each load depending on the one before, and
// neighbouring threads soon sit in unrelated nodes. On paper the least time
// is small either way: the distinct rows a batch reads over the memory rate
// and the batch's float32 operations (8 slab tests, a 19-comparator sort, one
// watertight triangle test per prim) over the float32 rate lie within 1.4x
// of each other (operations the larger) and about 25x under the measured
// time, and flushing the L2 before a launch costs 0-18 %: the kernel waits
// mostly on the latency of dependent gathers and on divergence inside a warp.
// What the design does about it: whole rows are fetched as 16-byte __ldg
// loads through the read-only path (14 for a node, 4 for a triangle, 7 for a
// quadric), rays whose tmax is 0 (dead lanes of the wavefront) leave before
// touching any table, shadow rays leave at the first hit, and children are
// visited near-first so that `t` shrinks early and culls the far ones.
// Shared-memory treelets, persistent threads and warp voting are left for
// later work.
//
// Motion blur: the JAX package sends motion scenes to its XLA walker, which
// lerps each triangle to the ray's shutter time; here the same kernel has a
// motion instance (HAS_MOTION) for them. Its leaf step also reads the prim's
// 48-byte delta row (three aligned float4 loads) and the ray's time, and
// lerps the three vertices before the watertight test; the nodes bound the
// shutter's union, so the walk is unchanged. Static scenes launch the
// instances without it, which read no delta row and no time.
//
// Semantics are those of the plain PyTorch walker
// tpupt_torch/accel/traverse.py `intersect_wide`, operation for operation:
// built with -fmad=false (no contraction of a*b+c) the kernel equals it bit
// for bit, counters included. Keep the two in step. The node and leaf steps
// live in traverse_common.cuh, shared with the two-level kernel.

#include "traverse_common.cuh"

namespace {

template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS, bool HAS_MOTION>
__global__ void __launch_bounds__(128)
traverse_wide_kernel(const float4* __restrict__ wide_nodes,
                     const float4* __restrict__ prim_rows, int n_rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax, int n,
                     float* __restrict__ t_out, float* __restrict__ b1_out,
                     float* __restrict__ b2_out, int* __restrict__ gid_out,
                     int* __restrict__ ridx_out, int* __restrict__ nodes_out,
                     int* __restrict__ leaves_out, int* __restrict__ tests_out,
                     int* __restrict__ deepest,
                     const float4* __restrict__ prim_dt,
                     const float* __restrict__ time) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  HitRec h = {tmax[i], -1, 0, 0.0f, 0.0f, 0, 0, 0};

  // dead lanes (tmax == 0) leave without touching a ray or a table
  if (h.t > 0.0f) {
    RayConst r;
    ray_setup(o, d, i, r);
    float tm = HAS_MOTION ? time[i] : 0.0f;

    int stack[WIDE_STACK];
    int sp = 1;
    int sp_max = 1;
    stack[0] = 0;  // root node id 0

    while (sp > 0) {
      int raw = stack[--sp];
      if (raw >= 0) {
        if (WITH_STATS) h.n_nodes++;
        node_step(wide_nodes + (size_t)raw * 16, r, h.t, stack, sp, sp_max);
      } else {
        if (WITH_STATS) h.n_leaves++;
        int v = -raw - 1;
        leaf_step<HAS_SPHERES, WITH_STATS, HAS_MOTION>(
            prim_rows, n_rows, v >> 6, v & 63, r, h, prim_dt, tm);
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
// are contiguous device memory: wide_nodes (Nw,64) f32, prim_rows (P,32) f32,
// o/d (N,3) f32, tmax (N,) f32; outputs (N,). nodes/leaves/tests are written
// only with with_stats. `deepest` is one int that receives the deepest stack
// any ray asked for when that exceeds WIDE_STACK. With a non-null `time`
// (N,) f32 the motion instance runs and reads prim_rows_dt (P,12) f32, the
// rows' vertex deltas; both are null for a static scene. Returns
// cudaGetLastError().
extern "C" int tpupt_traverse_wide(
    const void* wide_nodes, const void* prim_rows, int n_rows, const void* o,
    const void* d, const void* tmax, int n, void* t_out, void* b1_out,
    void* b2_out, void* gid_out, void* ridx_out, void* nodes_out,
    void* leaves_out, void* tests_out, void* deepest, int any_hit,
    int has_spheres, int with_stats, const void* prim_rows_dt,
    const void* time, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(A, H, W, M)                                                    \
  traverse_wide_kernel<A, H, W, M><<<blocks, threads, 0, s>>>(                \
      (const float4*)wide_nodes, (const float4*)prim_rows, n_rows,            \
      (const float*)o, (const float*)d, (const float*)tmax, n, (float*)t_out, \
      (float*)b1_out, (float*)b2_out, (int*)gid_out, (int*)ridx_out,          \
      (int*)nodes_out, (int*)leaves_out, (int*)tests_out, (int*)deepest,      \
      (const float4*)prim_rows_dt, (const float*)time)
  int key = (time ? 8 : 0) | (any_hit ? 4 : 0) | (has_spheres ? 2 : 0) |
            (with_stats ? 1 : 0);
  switch (key) {
    case 0: LAUNCH(false, false, false, false); break;
    case 1: LAUNCH(false, false, true, false); break;
    case 2: LAUNCH(false, true, false, false); break;
    case 3: LAUNCH(false, true, true, false); break;
    case 4: LAUNCH(true, false, false, false); break;
    case 5: LAUNCH(true, false, true, false); break;
    case 6: LAUNCH(true, true, false, false); break;
    case 7: LAUNCH(true, true, true, false); break;
    case 8: LAUNCH(false, false, false, true); break;
    case 9: LAUNCH(false, false, true, true); break;
    case 10: LAUNCH(false, true, false, true); break;
    case 11: LAUNCH(false, true, true, true); break;
    case 12: LAUNCH(true, false, false, true); break;
    case 13: LAUNCH(true, false, true, true); break;
    case 14: LAUNCH(true, true, false, true); break;
    default: LAUNCH(true, true, true, true); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
