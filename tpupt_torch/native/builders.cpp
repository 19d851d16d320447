// Native host-side BVH construction: exact sweep-SAH
// (reference: src/accelerators/bvh.cpp:242-321).
//
// C ABI for ctypes; outputs are malloc'd flat arrays the caller frees with
// tpb_free. The device consumes these as flat tensors.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void tpb_free(void* p) { free(p); }
}

namespace {

// ---------------------------------------------------------------------------
// exact sweep-SAH BVH (bvh.cpp:242-321 semantics: per node, sort centroids
// along every axis and scan every split position with prefix/suffix bounds)
// ---------------------------------------------------------------------------

struct Box {
  double lo[3], hi[3];
  void reset() {
    for (int a = 0; a < 3; a++) { lo[a] = 1e300; hi[a] = -1e300; }
  }
  void add(const Box& b) {
    for (int a = 0; a < 3; a++) {
      lo[a] = std::min(lo[a], b.lo[a]);
      hi[a] = std::max(hi[a], b.hi[a]);
    }
  }
  double area() const {
    double d0 = std::max(0.0, hi[0] - lo[0]);
    double d1 = std::max(0.0, hi[1] - lo[1]);
    double d2 = std::max(0.0, hi[2] - lo[2]);
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
  }
};

struct BVHOut {
  std::vector<float> lo, hi;
  std::vector<int32_t> right, first, count, axis;
};

struct BVHBuilder {
  const Box* boxes;
  float icost, tcost;
  int max_prims;
  std::vector<int> prim_ids;
  std::vector<Box> suffix;  // scratch
  BVHOut out;

  int emit(const Box& b, int cnt, int frst, int ax) {
    int id = (int)out.count.size();
    for (int a = 0; a < 3; a++) {
      out.lo.push_back((float)b.lo[a]);
      out.hi.push_back((float)b.hi[a]);
    }
    out.right.push_back(0);
    out.first.push_back(frst);
    out.count.push_back(cnt);
    out.axis.push_back(ax);
    return id;
  }

  // returns node id; prims in prim_ids[lo, hi)
  int build(int plo, int phi) {
    Box bounds; bounds.reset();
    for (int i = plo; i < phi; i++) bounds.add(boxes[prim_ids[i]]);
    int n = phi - plo;
    if (n == 1) return emit(bounds, n, plo, 0);

    double best_cost = 1e300;
    int best_axis = -1, best_split = -1;
    double leaf_cost = icost * n;
    double inv_area = 1.0 / std::max(bounds.area(), 1e-300);

    std::vector<int> order(prim_ids.begin() + plo, prim_ids.begin() + phi);
    std::vector<int> best_order;
    suffix.resize(n);
    for (int ax = 0; ax < 3; ax++) {
      std::sort(order.begin(), order.end(), [&](int a, int b) {
        double ca = boxes[a].lo[ax] + boxes[a].hi[ax];
        double cb = boxes[b].lo[ax] + boxes[b].hi[ax];
        return ca < cb;
      });
      Box acc; acc.reset();
      for (int i = n - 1; i >= 0; i--) {  // suffix bounds
        acc.add(boxes[order[i]]);
        suffix[i] = acc;
      }
      Box pre; pre.reset();
      for (int i = 1; i < n; i++) {  // split after i-1
        pre.add(boxes[order[i - 1]]);
        double c = tcost + icost * inv_area *
                   (pre.area() * i + suffix[i].area() * (n - i));
        if (c < best_cost) {
          best_cost = c;
          best_axis = ax;
          best_split = i;
          best_order = order;
        }
      }
    }
    if (best_axis < 0 || (best_cost >= leaf_cost && n <= max_prims))
      return emit(bounds, n, plo, 0);

    std::copy(best_order.begin(), best_order.end(), prim_ids.begin() + plo);
    int id = emit(bounds, 0, 0, best_axis);
    build(plo, plo + best_split);
    int r = build(plo + best_split, phi);
    out.right[id] = r;
    return id;
  }
};

template <typename T>
T* copy_out(const std::vector<T>& v) {
  T* p = (T*)malloc(sizeof(T) * std::max<size_t>(v.size(), 1));
  memcpy(p, v.data(), sizeof(T) * v.size());
  return p;
}

}  // namespace

extern "C" {

int tpb_build_bvh(int n, const float* prim_lo, const float* prim_hi,
                  float icost, float tcost, int max_prims,
                  float** out_lo, float** out_hi, int32_t** out_right,
                  int32_t** out_first, int32_t** out_count, int32_t** out_axis,
                  int32_t** out_prim_ids, int32_t* out_n_nodes,
                  double* out_build_s) {
  auto t0 = std::chrono::steady_clock::now();
  std::vector<Box> boxes(n);
  for (int i = 0; i < n; i++)
    for (int a = 0; a < 3; a++) {
      boxes[i].lo[a] = prim_lo[i * 3 + a];
      boxes[i].hi[a] = prim_hi[i * 3 + a];
    }
  BVHBuilder b;
  b.boxes = boxes.data();
  b.icost = icost; b.tcost = tcost; b.max_prims = max_prims;
  b.prim_ids.resize(n);
  for (int i = 0; i < n; i++) b.prim_ids[i] = i;
  if (n > 0) b.build(0, n);
  else b.emit(Box{{0,0,0},{0,0,0}}, 0, 0, 0);
  *out_lo = copy_out(b.out.lo);
  *out_hi = copy_out(b.out.hi);
  *out_right = copy_out(b.out.right);
  *out_first = copy_out(b.out.first);
  *out_count = copy_out(b.out.count);
  *out_axis = copy_out(b.out.axis);
  std::vector<int32_t> pid32(b.prim_ids.begin(), b.prim_ids.end());
  *out_prim_ids = copy_out(pid32);
  *out_n_nodes = (int32_t)b.out.count.size();
  *out_build_s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  return 0;
}

}  // extern "C"
