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
// records: the first `r_list` (treelet id, max(t_near, 0)) of the walk; the
// rest are only counted. The kept records are written ordered by (entry t,
// walk order), so that the driver takes each ray's nearest treelets as the
// first columns of its list and sorts only the keys of a pass's columns. A
// dead ray (tmax 0) leaves at once with an empty list.
//
// walk_pairs replaces the TPU kernel tpupt/ops/traverse_requeue.py
// `_kernel_chunk` (entry `_walk_chunks`). That kernel takes 1024-lane chunks
// of (ray, treelet) pairs sorted by (treelet, direction octant), at most 16
// treelets a chunk, copies each treelet's padded node and prim blocks into
// on-chip memory and walks the block for the whole chunk with any-lane
// voting, parking the lanes of other treelets. Here ONE LANE WALKS ONE
// PAIR AT A TIME: it reads its ray by ray id (no gathered copies of the ray
// fields), reads the treelet's first node row and prim row (one int2 of
// `tl_offsets`) and walks the treelet from its local root, starting from the
// ray's best t when the pass began (`t_in`), with the node step and leaf
// step of traverse_common.cuh. The pairs are sorted by treelet, so the lanes
// of a warp walk the same treelet: that is the Hopper form of the TPU's
// same-treelet chunk, the treelet's rows are read by a warp together and
// stay in L1/L2. A lane a pair defers nothing, so the TPU's third pass (for
// pairs a chunk could not take) has no counterpart.
//
// Only live pairs are walked: the driver's pair sort puts them first and
// counts them on the card (`work`, two ints: the live count, which the
// kernel caps at the number of pairs, and a zero it counts the pairs it
// hands out in); a dead slot costs nothing. The winner is chosen here, not by the driver: each ray
// keeps one 64-bit word, (bits of t) << 32 | payload slot, which orders like
// (t, slot) because a hit's t and tmax are positive; a pair that hits does
// one 64-bit atomicMin on its ray's word and writes its (gid, row, b1, b2)
// at its slot, pass * P + its sorted index. So a ray takes the smallest t,
// among equal t the first pair in sorted order, and a later pass (larger
// slots) replaces a hit only with a smaller t. t is never read back from the
// word during a pass: every pair starts from `t_in`, so the culling and the
// counters do not depend on the order in which the pairs run. The node, leaf
// and prim-test counts of each pair are added into its ray's counters with
// atomicAdd (integer sums: any order gives the same bits).
//
// The grid, no larger than the card holds at once, is persistent warps
// that take pairs from the work counter in sorted order, a lane a pair, as
// their lanes finish (Aila and Laine's dynamic fetch): on an H100 5-7 %
// faster than a fixed stride over the pairs. Copying the first node rows of
// a block's treelet into shared memory was 6-22 % slower and is not kept: a
// whole treelet (up to 512 x 256 B of nodes plus 4096 x 128 B of prims)
// does not fit a block's 227 KB, and few blocks of 128 sorted pairs share
// one treelet (PERF.md).
//
// What bounds them: bin_rays reads a few hundred top rows that every ray
// shares and writes 8 bytes a record; it waits on the walks of its rays'
// divergent warps, on their row and stack reads from L1 and on its stores,
// not on bytes or operations. Its design, timed against the kernel it
// replaced and other builds on an H100 (PERF.md):
// - each thread appends its kept records to its own list in shared memory
//   (r_list tid and r_list entry-t words, rows of r_list | 1 ints, so that
//   a warp's threads touch 32 banks) and sorts the list by insertion once
//   its walk is done: 13 % faster than inserting each record at its place
//   as it is found, which stalls a whole warp on one lane's shifts;
// - a warp then writes its 32 rows, which lie side by side in the
//   (N, r_list) outputs, word by word with neighbouring lanes on
//   neighbouring words, where a store of one slot of 32 rows wrote 32
//   scattered words;
// - the launch carves out of each SM's L1 only the shared memory that one
//   wave's blocks take, leaving the rest for the top rows and the stacks
//   (set_bin_rays_carveout): 8-10 % faster than the kernel it replaced,
//   where the runtime's own carve-out left the same kernel 0-2.5 % slower;
// - the walk holds one child's six bounds and meta at a time (three 8-byte
//   loads and one int a slab test), 36 registers in place of 72. That alone
//   gained nothing over that kernel, and these were slower than it: a warp
//   walking the union of its rays' walks (one row read a step for all
//   lanes; the union is large) by 30-43 %, a sort network in registers by
//   20-25 %, the top tree staged in shared memory by 30 %.
// walk_pairs is bound like traverse_treelets.cu by dependent, random
// 256-byte node-row and 128-byte prim-row gathers, latency and divergence,
// with the byte and operation bounds far below the measured time.
//
// Semantics are those of the plain PyTorch versions
// tpupt_torch/accel/traverse.py `bin_rays` and `walk_pairs`, operation for
// operation: built with -fmad=false the kernels equal them bit for bit,
// counters included. Keep them in step.

#include "traverse_common.cuh"

namespace {

#define BIN_THREADS 128

__global__ void __launch_bounds__(BIN_THREADS, 8)
bin_rays_kernel(const float* __restrict__ top_nodes,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax, int n, int r_list,
                int* __restrict__ tid_out, float* __restrict__ tn_out,
                int* __restrict__ ovf_out, int* __restrict__ deepest) {
  // this thread's kept records: tid words, then entry-t words
  extern __shared__ int lists[];
  const int stride = r_list | 1;
  int* my_tid = lists + threadIdx.x * stride;
  float* my_tn = reinterpret_cast<float*>(lists + (BIN_THREADS + threadIdx.x)
                                          * stride);
  for (int k = 0; k < r_list; k++) {
    my_tid[k] = -1;
    my_tn[k] = BIG_KEY;
  }
  int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  int cnt = 0;

  // dead lanes (tmax == 0) and lanes past the end keep an empty list
  float tm = i < n ? tmax[i] : 0.0f;
  if (tm > 0.0f) {
    float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    float ix = inv_guarded(d[3 * i + 0]), iy = inv_guarded(d[3 * i + 1]),
          iz = inv_guarded(d[3 * i + 2]);
    int stack[WIDE_STACK];
    int sp = 1;
    int sp_max = 1;
    stack[0] = 0;  // top node id 0
    while (sp > 0) {
      const float* row = top_nodes + (size_t)stack[--sp] * 64;
      // slot order: records and pushes follow the TPU lane's order
      for (int c = 0; c < 8; c++) {
        const float2* b = reinterpret_cast<const float2*>(row + 6 * c);
        float2 b0 = __ldg(b), b1 = __ldg(b + 1), b2 = __ldg(b + 2);
        int m = __ldg(reinterpret_cast<const int*>(row) + 48 + c);
        float tlx = (b0.x - ox) * ix;
        float tly = (b0.y - oy) * iy;
        float tlz = (b1.x - oz) * iz;
        float thx = (b1.y - ox) * ix;
        float thy = (b2.x - oy) * iy;
        float thz = (b2.y - oz) * iz;
        float t_near = max3(fminf(tlx, thx), fminf(tly, thy), fminf(tlz, thz));
        float t_far = min3(fmaxf(tlx, thx), fmaxf(tly, thy), fmaxf(tlz, thz))
                      * 1.0000004f;
        bool hit = (t_near <= t_far) && (t_far > 0.0f) && (t_near < tm) &&
                   (m != META_EMPTY);
        if (!hit) continue;
        if (m < 0) {  // treelet reference -(tid) - 1
          if (cnt < r_list) {
            my_tn[cnt] = t_near > 0.0f ? t_near : 0.0f;
            my_tid[cnt] = -m - 1;
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
  if (i < n) ovf_out[i] = max(cnt - r_list, 0);
  for (int a = 1, kept = min(cnt, r_list); a < kept; a++) {
    float t = my_tn[a];
    int v = my_tid[a];
    int j = a;
    for (; j > 0 && my_tn[j - 1] > t; j--) {
      my_tn[j] = my_tn[j - 1];
      my_tid[j] = my_tid[j - 1];
    }
    my_tn[j] = t;
    my_tid[j] = v;
  }

  // the warp's rows row0 .. row0 + 31 are words row0 * r_list on of both
  // outputs: lane l writes words l, l + 32, ... (word w: row w / r_list,
  // slot w % r_list, stepped without a division)
  __syncwarp();
  int lane = threadIdx.x & 31;
  int row0 = i - lane;
  int words = (min(n - row0, 32)) * r_list;
  const int* warp_tid = lists + (threadIdx.x - lane) * stride;
  const float* warp_tn = reinterpret_cast<const float*>(
      lists + (BIN_THREADS + threadIdx.x - lane) * stride);
  int* tid_rows = tid_out + (size_t)row0 * r_list;
  float* tn_rows = tn_out + (size_t)row0 * r_list;
  int step_r = 32 / r_list, step_k = 32 % r_list;
  int r = lane / r_list, k = lane % r_list;
  for (int w = lane; w < words; w += 32) {
    tid_rows[w] = warp_tid[r * stride + k];
    tn_rows[w] = warp_tn[r * stride + k];
    r += step_r;
    k += step_k;
    if (k >= r_list) {
      k -= r_list;
      r++;
    }
  }
}

struct PairArgs {
  const float4* __restrict__ tl_nodes;
  const float4* __restrict__ tl_prims;
  int n_rows;
  const int2* __restrict__ tl_offsets;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const int* __restrict__ key;
  const int* __restrict__ ray;
  int p;      // pairs in key / ray
  int* work;  // [live pairs, next pair to hand out]
  const float* __restrict__ t_in;
  unsigned slot_base;
  unsigned long long* __restrict__ word;
  int4* __restrict__ payload;
  int* __restrict__ nodes_acc;
  int* __restrict__ leaves_acc;
  int* __restrict__ tests_acc;
  int* __restrict__ deepest;
};

// One lane's current pair: its walk through its treelet, one step at a time
// in the order of traverse_treelets.cu's loop, on the caller's stack of
// WIDE_STACK ints (a struct that held the array would be kept in local
// memory whole, with the ray and the hit beside it), and its share of its
// ray's result.
template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS>
struct PairWalk {
  const PairArgs& a;
  int* stack;
  RayConst r;
  HitRec h;
  int i, ri, sp, sp_max, prim_base;
  const float4* nodes;

  __device__ PairWalk(const PairArgs& args, int* local)
      : a(args), stack(local) {}

  // pair i, from its ray's t when the pass began, at its treelet's root
  __device__ __forceinline__ void begin(int item) {
    i = item;
    int k = a.key[i];
    ri = a.ray[i];
    h = {a.t_in[ri], -1, 0, 0.0f, 0.0f, 0, 0, 0};
    ray_setup(a.o, a.d, ri, r);
    int2 off = __ldg(a.tl_offsets + (k >> 3));
    nodes = a.tl_nodes + (size_t)off.x * 16;
    prim_base = off.y;
    sp = 1;
    sp_max = 1;
    stack[0] = 0;  // the treelet's local root
  }
  __device__ __forceinline__ bool done() const {
    return sp == 0 || (ANY_HIT && h.gid >= 0);
  }
  __device__ __forceinline__ void step() {
    int raw = stack[--sp];
    if (raw >= 0) {
      if (WITH_STATS) h.n_nodes++;
      node_step(nodes + (size_t)raw * 16, r, h.t, stack, sp, sp_max);
    } else {
      if (WITH_STATS) h.n_leaves++;
      int v = -raw - 1;
      leaf_step<HAS_SPHERES, WITH_STATS>(a.tl_prims, a.n_rows,
                                         prim_base + (v >> 6), v & 63, r, h);
    }
  }
  __device__ __forceinline__ void finish() {
    if (sp_max > WIDE_STACK) atomicMax(a.deepest, sp_max);
    if (h.gid >= 0) {
      unsigned slot = a.slot_base + (unsigned)i;
      atomicMin(a.word + ri,
                ((unsigned long long)__float_as_uint(h.t) << 32) | slot);
      a.payload[slot] = make_int4(h.gid, h.ridx, __float_as_int(h.b1),
                                  __float_as_int(h.b2));
    }
    if (WITH_STATS) {
      atomicAdd(a.nodes_acc + ri, h.n_nodes);
      atomicAdd(a.leaves_acc + ri, h.n_leaves);
      atomicAdd(a.tests_acc + ri, h.n_tests);
    }
  }
};

#define FULL_WARP 0xffffffffu
#define MIN_ASK 8  // free lanes a warp waits for before it takes more pairs

// The work counter of a warp's lanes (Aila and Laine, "Understanding the
// efficiency of ray traversal on GPUs", HPG 2009): the lanes that want an
// item are counted with one vote, and when there are at least MIN_ASK of
// them one lane takes that many indices with a single atomicAdd and hands
// them out by shuffle. `drained`, the same in every lane, is set once the
// counter has passed `count`.
struct WarpQueue {
  int* counter;
  int count;
  bool drained;

  // the lane's new item, or -1; every lane of the warp calls it
  __device__ __forceinline__ int take(bool want) {
    unsigned ask = __ballot_sync(FULL_WARP, want);
    int n_ask = __popc(ask);
    if (drained || n_ask < MIN_ASK) return -1;
    int lane = threadIdx.x & 31;
    int leader = __ffs(ask) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counter, n_ask);
    base = __shfl_sync(FULL_WARP, base, leader);
    if (base + n_ask >= count) drained = true;
    if (!want) return -1;
    int item = base + __popc(ask & ((1u << lane) - 1u));
    return item < count ? item : -1;
  }
};

// Persistent warps: each lane walks one pair at a time and takes the next
// from the work counter, in sorted order, when enough lanes of its warp are
// free. A warp leaves when, right after a take, none of its lanes has a
// pair: every lane then asked, so the counter has passed the live count
// (never more than the pairs there are). Each turn before that steps at
// least one walk, so the loop ends.
template <bool ANY_HIT, bool HAS_SPHERES, bool WITH_STATS>
__global__ void __launch_bounds__(128)
walk_pairs_kernel(const __grid_constant__ PairArgs a) {
  int local[WIDE_STACK];
  PairWalk<ANY_HIT, HAS_SPHERES, WITH_STATS> w(a, local);
  WarpQueue q = {a.work + 1, min(a.work[0], a.p), false};
  bool busy = false;
  for (;;) {
    int item = q.take(!busy);
    if (item >= 0) {
      w.begin(item);
      busy = true;
    }
    if (!__any_sync(FULL_WARP, busy)) break;
    if (busy) {
      w.step();
      if (w.done()) {
        w.finish();
        busy = false;
      }
    }
  }
}

// Blocks of `threads` threads of walk_pairs_kernel<A, H, W> that the
// current card holds at once: the grid of a persistent launch, asked of the
// runtime once per instance and card.
template <bool A, bool H, bool W>
int resident_blocks(int threads) {
  constexpr int kMaxDevices = 64;
  static int blocks[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && blocks[dev] > 0) return blocks[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, walk_pairs_kernel<A, H, W>, threads, 0);
  int n = (per_sm > 1 ? per_sm : 1) * (sms > 1 ? sms : 1);
  if (dev < kMaxDevices) blocks[dev] = n;
  return n;
}

// Carves out of each SM's L1 / shared memory for bin_rays_kernel the shared
// memory that the blocks of one wave of `blocks` blocks of `shared` bytes
// take there, and no more, so that the rest stays L1, where the top rows
// and the walks' stacks live: with the runtime's own choice, which favours
// the most blocks an SM could hold, the kernel was 9-14 % slower (PERF.md).
// Set once per card and carve-out. Returns the CUDA error.
int set_bin_rays_carveout(int blocks, size_t shared) {
  constexpr int kMaxDevices = 64;
  static int last[kMaxDevices];  // percent set + 1; 0: not set yet
  int dev = 0, sms = 1, per_sm = 1, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  size_t wave = (size_t)((blocks + sms - 1) / sms) * (shared + reserved);
  size_t want = (wave * 100 + per_sm - 1) / per_sm;
  int percent = want < 100 ? (int)want : 100;
  if (dev < kMaxDevices && last[dev] == percent + 1) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      bin_rays_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      percent);
  if (err == cudaSuccess && dev < kMaxDevices) last[dev] = percent + 1;
  return (int)err;
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing. All arrays
// are contiguous device memory: top_nodes (Ntop,64) f32, o/d (N,3) f32, tmax
// (N,) f32; outputs tid (N,r_list) i32, tnear (N,r_list) f32 (each row's kept
// records in (entry t, walk order), then empty ones: -1, 3e38), ovf (N,) i32.
// `deepest` is one int that receives the deepest stack any ray asked for
// when that exceeds WIDE_STACK. Returns cudaGetLastError().
extern "C" int tpupt_bin_rays(const void* top_nodes, const void* o,
                              const void* d, const void* tmax, int n,
                              int r_list, void* tid_out, void* tn_out,
                              void* ovf_out, void* deepest, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BIN_THREADS - 1) / BIN_THREADS;
  const size_t shared = sizeof(int) * 2 * BIN_THREADS * (r_list | 1);
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bin_rays_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  int err = set_bin_rays_carveout(blocks, shared);
  if (err != 0) return err;
  bin_rays_kernel<<<blocks, BIN_THREADS, shared, (cudaStream_t)stream>>>(
      (const float*)top_nodes, (const float*)o, (const float*)d,
      (const float*)tmax, n, r_list, (int*)tid_out, (float*)tn_out,
      (int*)ovf_out, (int*)deepest);
  return (int)cudaGetLastError();
}

// Launches on `stream`, does not synchronise, allocates nothing. tl_nodes
// (Nt,64) f32, tl_prims (P,32) f32, tl_offsets (NT,2) i32, o/d (N,3) f32,
// key/ray (p,) i32 sorted with the live pairs first, work two i32 on the
// card: the number of live pairs (pairs past p are not walked) and the
// first pair to walk, 0, which the launch counts up as it hands pairs out
// and leaves at or past the end, so a `work` serves one launch; t_in (N,)
// f32; word (N,) u64, payload (S,4) i32 with S >= slot_base + p, and the
// counters nodes/leaves/tests (N,) i32, which are added to only with
// with_stats. `deepest` is as in tpupt_bin_rays. Returns the first CUDA
// error.
extern "C" int tpupt_walk_pairs(
    const void* tl_nodes, const void* tl_prims, int n_rows,
    const void* tl_offsets, const void* o, const void* d, const void* key,
    const void* ray, void* work, const void* t_in, int p,
    int slot_base, void* word, void* payload, void* nodes_acc,
    void* leaves_acc, void* tests_acc, void* deepest, int any_hit,
    int has_spheres, int with_stats, void* stream) {
  if (p <= 0) return 0;
  const PairArgs a = {
      (const float4*)tl_nodes, (const float4*)tl_prims, n_rows,
      (const int2*)tl_offsets, (const float*)o, (const float*)d,
      (const int*)key, (const int*)ray, p, (int*)work, (const float*)t_in,
      (unsigned)slot_base, (unsigned long long*)word, (int4*)payload,
      (int*)nodes_acc, (int*)leaves_acc, (int*)tests_acc, (int*)deepest};
  const int threads = 128;
  const int blocks = (p + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(A, H, W)                                                       \
  {                                                                           \
    int cap = resident_blocks<A, H, W>(threads);                              \
    walk_pairs_kernel<A, H, W>                                                \
        <<<blocks < cap ? blocks : cap, threads, 0, s>>>(a);                  \
  }
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
