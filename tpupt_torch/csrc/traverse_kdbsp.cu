// kd-tree / RBSP / BSP traversal for Hopper: closest hit, or first occluder
// found, of every ray of a wavefront batch through one of the thesis trees
// (kd-tree, restricted BSP with 3-13 shared directions, unrestricted BSP
// with a direction per node).
//
// Replaces the TPU kernel tpupt/ops/traverse_kdbsp.py `_kernel_kdbsp` (with
// `_test_prim_row`, entry `intersect_kdbsp_packets`). That kernel walks
// 1024-ray packets with one scalar node stack per packet and two stacks of
// interval tiles, visits children in the packet's majority order, pushes
// both children whenever any lane wants both, extracts a node's fields from
// a dense float-coded tile with a lane-mask reduction and streams fat leaves
// in 16-prim chunks through double-buffered copies, because the TPU cannot
// gather per lane and a packet would stall on a 347-prim leaf. None of that
// is carried over: here ONE THREAD WALKS ONE RAY, pbrt's own recursion
// unrolled (kdtreeaccel.cpp:410-532), with its own stack of KD_STACK
// (node, tmin, tmax) entries. A node is one 32-byte row of `nodes` (K,8):
// direction xyz and split offset as float32, then leaf flag, above child (or
// a leaf's first prim row) and prim count as int32 bit patterns. A leaf's
// `nprims` prim rows are read straight from `prim_rows` (P,32), as the
// wide-BVH kernel reads them; the rows that pad a leaf run to a multiple of 4
// are never read. Any number of rays, any table size.
//
// What bounds it: every step of every ray is one dependent 32-byte gather
// and a handful of float operations (two 3-term projections, a division, six
// compares), and a ray takes several times the steps it takes in the 8-wide
// BVH, so the walk waits on the latency of dependent loads, and on the
// slowest lane of each warp where one thread loops over a fat leaf. On paper
// the least time (distinct rows read over the memory rate, or the float32
// operations over the float32 rate) is tens of times smaller. What the
// design does about it:
// - one round trip a step: both 16-byte halves of a row are loaded together
//   (the leaf flag no longer decides whether the plane half is fetched), and
//   the next node's row is requested as soon as the child is chosen, ahead
//   of the push and of the loop's branch;
// - the newest KD_SHORT stack entries sit in shared memory (12 KB a block),
//   so pushes and pops do not compete with the node rows for L1; the older
//   entries of a deep walk go to local memory;
// - the near child is taken without touching the stack, the far one is
//   pushed only when the plane lies inside the cell, a popped cell behind a
//   hit already found is dropped, a hit inside the leaf's cell ends the
//   walk, shadow rays leave at the first hit, and dead lanes (tmax 0) and
//   rays that miss the world bounds leave before touching a table.
// On the H100 (PERF.md) either mechanism takes 1-5 % off a kernel
// that has the other, and the two take 2-7 % off the kernel before them
// timed alone in the same run; a stack wholly in shared memory (46 KB a
// block at 30 levels) made it 21-41 % slower instead: fewer blocks fit an
// SM. Sorting rays for
// coherence and splitting fat leaves across the warp are left for later
// work.
//
// Semantics are those of the plain PyTorch walker
// tpupt_torch/accel/kdbsp.py `intersect_kdbsp`, operation for operation:
// built with -fmad=false (no contraction of a*b+c) the kernel equals it bit
// for bit, counters included. Keep the two in step. The leaf step and the ray
// set-up live in traverse_common.cuh, shared with the BVH kernels.

#include "traverse_common.cuh"

#define KD_STACK 64
#define KD_THREADS 128
// entries of a thread's stack kept in shared memory
#define KD_SHORT 8

namespace {

// A thread's (node, tmin, tmax) stack of KD_STACK entries. The newest
// KD_SHORT entries live in shared memory, slot k % KD_SHORT of the thread's
// column ([slot][thread], so a warp's pushes fall in 32 banks); a push onto
// a full window first moves the window's oldest entry to local memory, and
// a pop below the window reads it back from there. Most pops find their
// entry in shared memory, and local memory is touched only by rays whose
// stack runs deeper than KD_SHORT.
struct KdStack {
  int* s_node;
  float *s_tmin, *s_tmax;
  int l_node[KD_STACK];
  float l_tmin[KD_STACK], l_tmax[KD_STACK];
  int lo = 0;  // entries lo..sp-1 are in shared memory

  __device__ explicit KdStack(unsigned char* smem) {
    s_node = (int*)smem + threadIdx.x;
    s_tmin = (float*)smem + KD_SHORT * KD_THREADS + threadIdx.x;
    s_tmax = (float*)smem + 2 * KD_SHORT * KD_THREADS + threadIdx.x;
  }
  __device__ void put(int k, int nd, float a, float b) {
    if (k - lo == KD_SHORT) {
      int q = (lo % KD_SHORT) * KD_THREADS;
      l_node[lo] = s_node[q]; l_tmin[lo] = s_tmin[q]; l_tmax[lo] = s_tmax[q];
      lo++;
    }
    int q = (k % KD_SHORT) * KD_THREADS;
    s_node[q] = nd; s_tmin[q] = a; s_tmax[q] = b;
  }
  __device__ void get(int k, int& nd, float& a, float& b) {
    if (k >= lo) {
      int q = (k % KD_SHORT) * KD_THREADS;
      nd = s_node[q]; a = s_tmin[q]; b = s_tmax[q];
    } else {
      nd = l_node[k]; a = l_tmin[k]; b = l_tmax[k];
      lo = k;
    }
  }
};

template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS>
__global__ void __launch_bounds__(KD_THREADS)
traverse_kdbsp_kernel(const float4* __restrict__ nodes,
                      const float4* __restrict__ prim_rows, int n_rows,
                      const float* __restrict__ world_lo,
                      const float* __restrict__ world_hi,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax, int n,
                      float* __restrict__ t_out, float* __restrict__ b1_out,
                      float* __restrict__ b2_out, int* __restrict__ gid_out,
                      int* __restrict__ ridx_out, int* __restrict__ nodes_out,
                      int* __restrict__ leaves_out, int* __restrict__ tests_out,
                      int* __restrict__ deepest) {
  __shared__ __align__(16) unsigned char kd_smem[KD_SHORT * KD_THREADS * 12];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  HitRec h = {tmax[i], -1, 0, 0.0f, 0.0f, 0, 0, 0};

  // dead lanes (tmax == 0) leave without touching a ray or a table
  if (h.t > 0.0f) {
    RayConst r;
    ray_setup(o, d, i, r);

    // the root's interval: the ray clipped to the world bounds
    float tlx = (__ldg(world_lo + 0) - r.ox) * r.ix;
    float tly = (__ldg(world_lo + 1) - r.oy) * r.iy;
    float tlz = (__ldg(world_lo + 2) - r.oz) * r.iz;
    float thx = (__ldg(world_hi + 0) - r.ox) * r.ix;
    float thy = (__ldg(world_hi + 1) - r.oy) * r.iy;
    float thz = (__ldg(world_hi + 2) - r.oz) * r.iz;
    float tmin = fmaxf(
        max3(fminf(tlx, thx), fminf(tly, thy), fminf(tlz, thz)), 0.0f);
    float tmaxn = fminf(
        min3(fmaxf(tlx, thx), fmaxf(tly, thy), fmaxf(tlz, thz)), h.t);

    if (!(tmin > tmaxn)) {
      KdStack stack(kd_smem);
      int sp = 0;
      bool overflow = false;
      int node = 0;
      // the row of `node`: both halves issued together, and the next row
      // issued as soon as the next node is known, ahead of the push
      float4 na = __ldg(nodes), nb = __ldg(nodes + 1);
      while (true) {
        int abv = __float_as_int(nb.y);
        if (__float_as_int(nb.x) != 0) {
          if (WITH_STATS) h.n_leaves++;
          leaf_step<HAS_SPHERES, WITH_STATS>(prim_rows, n_rows, abv,
                                             __float_as_int(nb.z), r, h);
          // a hit inside the leaf's cell ends the walk
          if (h.t <= tmaxn) break;
          if (ANY_HIT && h.gid >= 0) break;
          // pop, dropping cells that begin behind a hit already found (a
          // cell reached by descending never does: neither its entry nor
          // the hit changed since its parent passed this test)
          bool got = false;
          while (sp > 0) {
            --sp;
            stack.get(sp, node, tmin, tmaxn);
            if (!(h.t < tmin)) {
              got = true;
              break;
            }
          }
          if (!got) break;
          na = __ldg(nodes + 2 * (size_t)node);
          nb = __ldg(nodes + 2 * (size_t)node + 1);
        } else {
          if (WITH_STATS) h.n_nodes++;
          // projected plane distance (rbsp.cpp:68-80), term by term
          float op = r.ox * na.x + r.oy * na.y + r.oz * na.z;
          float dp = r.dx * na.x + r.dy * na.y + r.dz * na.z;
          float t_plane = (na.w - op) / (fabsf(dp) < 1e-12f ? 1e-12f : dp);
          bool below_first = (op < na.w) || (op == na.w && dp <= 0.0f);
          int first_child = below_first ? node + 1 : abv;
          int second_child = below_first ? abv : node + 1;
          // pbrt's if / elif (kdtreeaccel.cpp:430-450)
          bool only_first = (t_plane > tmaxn) || (t_plane <= 0.0f);
          bool only_second = (t_plane < tmin) && !only_first;
          node = only_second ? second_child : first_child;
          na = __ldg(nodes + 2 * (size_t)node);
          nb = __ldg(nodes + 2 * (size_t)node + 1);
          if (!only_first && !only_second) {
            // a push past KD_STACK is not written, and is reported
            if (sp < KD_STACK) {
              stack.put(sp, second_child, t_plane, tmaxn);
              sp++;
            } else {
              overflow = true;
            }
            tmaxn = t_plane;
          }
        }
      }
      if (overflow) atomicMax(deepest, KD_STACK + 1);
    }
  }
  store_hit<WITH_STATS>(i, h, t_out, b1_out, b2_out, gid_out, ridx_out,
                        nodes_out, leaves_out, tests_out);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing. All arrays
// are contiguous device memory: nodes (K,8) f32, prim_rows (P,32) f32,
// world_lo/world_hi (3,) f32, o/d (N,3) f32, tmax (N,) f32; outputs (N,).
// nodes/leaves/tests are written only with with_stats. `deepest` is one int
// that receives KD_STACK + 1 when some ray needed a deeper stack than
// KD_STACK. Returns cudaGetLastError().
extern "C" int tpupt_traverse_kdbsp(
    const void* nodes, const void* prim_rows, int n_rows, const void* world_lo,
    const void* world_hi, const void* o, const void* d, const void* tmax,
    int n, void* t_out, void* b1_out, void* b2_out, void* gid_out,
    void* ridx_out, void* nodes_out, void* leaves_out, void* tests_out,
    void* deepest, int any_hit, int has_spheres, int with_stats,
    void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + KD_THREADS - 1) / KD_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(A, H, W)                                                       \
  traverse_kdbsp_kernel<A, H, W><<<blocks, KD_THREADS, 0, s>>>(               \
      (const float4*)nodes, (const float4*)prim_rows, n_rows,                 \
      (const float*)world_lo, (const float*)world_hi, (const float*)o,        \
      (const float*)d, (const float*)tmax, n, (float*)t_out, (float*)b1_out,  \
      (float*)b2_out, (int*)gid_out, (int*)ridx_out, (int*)nodes_out,         \
      (int*)leaves_out, (int*)tests_out, (int*)deepest)
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
