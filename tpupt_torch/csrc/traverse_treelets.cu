// Two-level wide-BVH traversal for Hopper: closest hit, or first occluder
// found, of every ray of a wavefront batch over a top tree whose leaves are
// treelets (tpupt_torch/accel/treelets.py).
//
// Replaces the TPU kernel tpupt/ops/traverse_stream.py `_kernel_unified`
// (entry `intersect_packets_streamed`). That kernel exists because a large
// scene's tables do not fit the TPU's on-chip memory: per 1024-ray packet it
// walks the top tree on a scalar stack, collects up to 16 treelet references,
// copies each treelet's padded node and prim block into a double buffer with
// explicit asynchronous copies, and walks the block for the whole packet with
// any-lane voting. None of that is carried over. Here the tables stay in
// device memory and ONE THREAD WALKS ONE RAY through both levels on one stack
// of WIDE_STACK ints, in one loop: a popped top node is an interior step; a
// popped treelet reference makes the thread note where that treelet's node
// rows and prim rows start (one 8-byte read of `tl_offsets`), push the
// treelet's root and walk it with treelet-local ids until the stack is back
// where it was. The blocks are packed end to end at their true sizes (no
// padding, no float-coded metadata), so the two-level tables are as large as
// the single-level ones.
//
// What bounds it: the same dependent, random 256-byte node-row and 128-byte
// prim-row gathers as the single-level kernel (traverse_wide.cu, which has
// the figures): latency and divergence, with the byte and operation bounds
// both far below the measured time. What the two levels do about it on this
// card: a treelet's rows lie together, so the rays that enter it read one
// contiguous stretch of at most `tn` x 256 + `tp` x 128 bytes, and the top
// tree, which every ray walks, is a few hundred rows that stay in L1/L2. Both
// levels run in ONE loop: with a treelet loop nested inside the top loop the
// lanes of a warp that were in the top tree and those inside treelets could
// not share a node step, and the kernel took 1.6x as long. Staging a treelet
// in shared memory for a block of rays sorted by treelet is left for later
// work; this layout is what it needs.
//
// Semantics are those of the plain PyTorch walker
// tpupt_torch/accel/traverse.py `intersect_two_level`, operation for
// operation: built with -fmad=false the kernel equals it bit for bit,
// counters included. Keep the two in step.

#include "traverse_common.cuh"

namespace {

template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS>
__global__ void __launch_bounds__(128)
traverse_treelets_kernel(const float4* __restrict__ top_nodes,
                         const float4* __restrict__ tl_nodes,
                         const float4* __restrict__ tl_prims, int n_rows,
                         const int2* __restrict__ tl_offsets,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tmax, int n,
                         float* __restrict__ t_out, float* __restrict__ b1_out,
                         float* __restrict__ b2_out, int* __restrict__ gid_out,
                         int* __restrict__ ridx_out,
                         int* __restrict__ nodes_out,
                         int* __restrict__ leaves_out,
                         int* __restrict__ tests_out,
                         int* __restrict__ deepest) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  HitRec h = {tmax[i], -1, 0, 0.0f, 0.0f, 0, 0, 0};

  // dead lanes (tmax == 0) leave without touching a ray or a table
  if (h.t > 0.0f) {
    RayConst r;
    ray_setup(o, d, i, r);

    int stack[WIDE_STACK];
    int sp = 1;
    int sp_max = 1;
    stack[0] = 0;  // top node id 0

    // One loop for both levels, so that the threads of a warp that are in
    // the top tree and those inside treelets run the same node step
    // together. `base` is the stack height at which the current treelet was
    // entered, or -1 while the ray is in the top tree.
    const float4* nodes = top_nodes;
    int prim_off = 0;
    int base = -1;
    while (sp > 0) {
      if (sp == base) {  // the treelet is walked: back to the top tree
        nodes = top_nodes;
        base = -1;
      }
      int raw = stack[--sp];
      if (raw >= 0) {
        // ---------- node of either level ----------
        if (WITH_STATS) h.n_nodes++;
        node_step(nodes + (size_t)raw * 16, r, h.t, stack, sp, sp_max);
      } else if (base < 0) {
        // ---------- treelet reference: enter, push the local root ---------
        int2 off = __ldg(tl_offsets + (-raw - 1));
        nodes = tl_nodes + (size_t)off.x * 16;
        prim_off = off.y;
        base = sp;
        // the slot just popped is free, so this push cannot overflow
        stack[sp++] = 0;
      } else {
        // ---------- leaf of the current treelet ----------
        if (WITH_STATS) h.n_leaves++;
        int v = -raw - 1;
        leaf_step<HAS_SPHERES, WITH_STATS>(tl_prims, n_rows,
                                           prim_off + (v >> 6), v & 63, r, h);
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
// are contiguous device memory: top_nodes (Ntop,64) f32, tl_nodes (Nt,64)
// f32, tl_prims (P,32) f32, tl_offsets (NT,2) i32, o/d (N,3) f32, tmax (N,)
// f32; outputs (N,). nodes/leaves/tests are written only with with_stats.
// `ridx` is the winning row of tl_prims. `deepest` is one int that receives
// the deepest stack any ray asked for when that exceeds WIDE_STACK. Returns
// cudaGetLastError().
extern "C" int tpupt_traverse_treelets(
    const void* top_nodes, const void* tl_nodes, const void* tl_prims,
    int n_rows, const void* tl_offsets, const void* o, const void* d,
    const void* tmax, int n, void* t_out, void* b1_out, void* b2_out,
    void* gid_out, void* ridx_out, void* nodes_out, void* leaves_out,
    void* tests_out, void* deepest, int any_hit, int has_spheres,
    int with_stats, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(A, H, W)                                                       \
  traverse_treelets_kernel<A, H, W><<<blocks, threads, 0, s>>>(               \
      (const float4*)top_nodes, (const float4*)tl_nodes,                      \
      (const float4*)tl_prims, n_rows, (const int2*)tl_offsets,               \
      (const float*)o, (const float*)d, (const float*)tmax, n, (float*)t_out, \
      (float*)b1_out, (float*)b2_out, (int*)gid_out, (int*)ridx_out,          \
      (int*)nodes_out, (int*)leaves_out, (int*)tests_out, (int*)deepest)
  int key = (any_hit ? 4 : 0) | (has_spheres ? 2 : 0) | (with_stats ? 1 : 0);
  switch (key) {
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
