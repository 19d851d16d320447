// Native host-side acceleration-structure builders.
//
// Counterparts of the reference renderer's C++ builders:
//   * exact sweep-SAH BVH        (reference: src/accelerators/bvh.cpp:242-321)
//   * SAH kd-tree                (reference: src/accelerators/kdtreeaccel.cpp)
//   * restricted BSP (RBSP) with exact convex-polytope (k-DOP) surface-area
//     SAH over arbitrary direction sets
//                                (reference: src/accelerators/rbsp.cpp +
//                                 kDOPMesh.{h,cpp} — reimplemented here as
//                                 face-polygon clipping rather than edge soup)
//
// All functions use a C ABI for ctypes; outputs are malloc'd flat arrays the
// caller frees with tpb_free. The device consumes these as flat tensors.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void tpb_free(void* p) { free(p); }
}

namespace {

struct V3 {
  double x, y, z;
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

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

// ---------------------------------------------------------------------------
// SAH kd-tree (kdtreeaccel.cpp semantics: edge-sort sweep, empty bonus,
// bad-refine bailouts)
// ---------------------------------------------------------------------------

struct KdOut {
  std::vector<int32_t> flags;   // 0..2 split axis, 3 leaf
  std::vector<float> split;
  std::vector<int32_t> above;   // above-child id (interior) / prim offset (leaf)
  std::vector<int32_t> nprims;  // leaf prim count
  std::vector<int32_t> prim_ids;
};

struct KdBuilder {
  const Box* boxes;
  float icost, tcost, empty_bonus;
  int max_prims, max_depth;
  KdOut out;

  int emit_leaf(const std::vector<int>& prims) {
    int id = (int)out.flags.size();
    out.flags.push_back(3);
    out.split.push_back(0.f);
    out.above.push_back((int)out.prim_ids.size());
    out.nprims.push_back((int)prims.size());
    for (int p : prims) out.prim_ids.push_back(p);
    return id;
  }

  int build(std::vector<int>& prims, Box node_bounds, int depth,
            int bad_refines) {
    int n = (int)prims.size();
    if (n <= max_prims || depth == 0) return emit_leaf(prims);

    // choose split: sweep bound edges on each axis
    double best_cost = 1e300;
    int best_axis = -1;
    double best_pos = 0;
    double old_cost = icost * n;
    double total_sa = node_bounds.area();
    double inv_sa = 1.0 / std::max(total_sa, 1e-300);
    V3 d = {node_bounds.hi[0] - node_bounds.lo[0],
            node_bounds.hi[1] - node_bounds.lo[1],
            node_bounds.hi[2] - node_bounds.lo[2]};

    struct Edge { double t; int prim; bool start; };
    std::vector<Edge> edges(2 * n);
    for (int axis0 = 0; axis0 < 3; axis0++) {
      // the reference tries axes in largest-extent order with retry; we
      // simply evaluate all three and take the best
      int ax = axis0;
      for (int i = 0; i < n; i++) {
        edges[2 * i] = {boxes[prims[i]].lo[ax], prims[i], true};
        edges[2 * i + 1] = {boxes[prims[i]].hi[ax], prims[i], false};
      }
      std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        return a.t < b.t || (a.t == b.t && a.start > b.start);
      });
      int below = 0, above = n;
      for (int i = 0; i < 2 * n; i++) {
        if (!edges[i].start) above--;
        double t = edges[i].t;
        if (t > node_bounds.lo[ax] && t < node_bounds.hi[ax]) {
          int o0 = (ax + 1) % 3, o1 = (ax + 2) % 3;
          double d0 = d.x, d1 = d.y;  // placeholder
          double dd[3] = {d.x, d.y, d.z};
          double below_sa = 2 * (dd[o0] * dd[o1] +
                                 (t - node_bounds.lo[ax]) * (dd[o0] + dd[o1]));
          double above_sa = 2 * (dd[o0] * dd[o1] +
                                 (node_bounds.hi[ax] - t) * (dd[o0] + dd[o1]));
          double pb = below_sa * inv_sa, pa = above_sa * inv_sa;
          double eb = (above == 0 || below == 0) ? empty_bonus : 0;
          double cost = tcost + icost * (1 - eb) * (pb * below + pa * above);
          (void)d0; (void)d1;
          if (cost < best_cost) { best_cost = cost; best_axis = ax; best_pos = t; }
        }
        if (edges[i].start) below++;
      }
    }

    if (best_cost > old_cost) bad_refines++;
    if ((best_cost > 4 * old_cost && n < 16) || best_axis == -1 ||
        bad_refines == 3)
      return emit_leaf(prims);

    std::vector<int> below_p, above_p;
    for (int p : prims) {
      if (boxes[p].lo[best_axis] < best_pos) below_p.push_back(p);
      if (boxes[p].hi[best_axis] > best_pos) above_p.push_back(p);
      if (boxes[p].lo[best_axis] == best_pos &&
          boxes[p].hi[best_axis] == best_pos)
        below_p.push_back(p);  // degenerate: put flat prims below
    }

    int id = (int)out.flags.size();
    out.flags.push_back(best_axis);
    out.split.push_back((float)best_pos);
    out.above.push_back(0);
    out.nprims.push_back(0);

    Box bb = node_bounds; bb.hi[best_axis] = best_pos;
    Box ab = node_bounds; ab.lo[best_axis] = best_pos;
    prims.clear(); prims.shrink_to_fit();
    build(below_p, bb, depth - 1, bad_refines);
    int r = build(above_p, ab, depth - 1, bad_refines);
    out.above[id] = r;
    return id;
  }
};

// ---------------------------------------------------------------------------
// convex polytope (k-DOP cell) as face polygons — cut + exact surface area
// (reference kDOPMesh.h:91-275 reimplemented with polygon clipping)
// ---------------------------------------------------------------------------

struct Polytope {
  // each face: list of vertices (convex polygon, consistent winding)
  std::vector<std::vector<V3>> faces;

  static Polytope box(const Box& b) {
    Polytope p;
    auto v = [&](int i, int j, int k) {
      return V3{i ? b.hi[0] : b.lo[0], j ? b.hi[1] : b.lo[1],
                k ? b.hi[2] : b.lo[2]};
    };
    p.faces = {
        {v(0,0,0), v(0,1,0), v(0,1,1), v(0,0,1)},  // -x
        {v(1,0,0), v(1,0,1), v(1,1,1), v(1,1,0)},  // +x
        {v(0,0,0), v(0,0,1), v(1,0,1), v(1,0,0)},  // -y
        {v(0,1,0), v(1,1,0), v(1,1,1), v(0,1,1)},  // +y
        {v(0,0,0), v(1,0,0), v(1,1,0), v(0,1,0)},  // -z
        {v(0,0,1), v(0,1,1), v(1,1,1), v(1,0,1)},  // +z
    };
    return p;
  }

  double area() const {
    double a = 0;
    for (const auto& f : faces) {
      if (f.size() < 3) continue;
      V3 s{0, 0, 0};
      for (size_t i = 1; i + 1 < f.size(); i++)
        s = s + (f[i] - f[0]).cross(f[i + 1] - f[0]);
      a += 0.5 * s.norm();
    }
    return a;
  }

  // clip by halfspace dot(p, dir) <= t (keep below side). Returns the
  // clipped polytope with the cap face reconstructed (kDOPMesh.h KDOPCut).
  Polytope clip(const V3& dir, double t) const {
    Polytope out;
    std::vector<V3> cap;
    bool have_coplanar_face = false;
    const double eps = 1e-9 * (1.0 + std::fabs(t));
    for (const auto& f : faces) {
      std::vector<V3> nf;
      size_t m = f.size();
      bool all_on = true;
      for (size_t i = 0; i < m; i++)
        all_on = all_on && std::fabs(f[i].dot(dir) - t) <= eps;
      if (all_on) {
        // face lies IN the cut plane: it already is the cap
        // (kdop.cpp's in-plane-cut regression case)
        have_coplanar_face = true;
        out.faces.push_back(f);
        continue;
      }
      for (size_t i = 0; i < m; i++) {
        const V3& a = f[i];
        const V3& b = f[(i + 1) % m];
        double da = a.dot(dir) - t;
        double db = b.dot(dir) - t;
        if (da <= eps) nf.push_back(a);
        if (std::fabs(da) <= eps) {
          cap.push_back(a);  // vertex ON the plane belongs to the cap rim
        } else if ((da < -eps && db > eps) || (da > eps && db < -eps)) {
          double s = da / (da - db);
          V3 x = a + (b - a) * s;
          nf.push_back(x);
          cap.push_back(x);
        }
      }
      if (nf.size() >= 3) out.faces.push_back(nf);
    }
    if (cap.size() >= 3 && !have_coplanar_face) {
      // order cap vertices around their centroid in the cap plane
      V3 c{0, 0, 0};
      for (const auto& p : cap) c = c + p;
      c = c * (1.0 / cap.size());
      V3 u = cap[0] - c;
      double un = u.norm();
      if (un > 1e-12) {
        u = u * (1.0 / un);
        V3 w = dir.cross(u);
        std::sort(cap.begin(), cap.end(), [&](const V3& a, const V3& b) {
          V3 pa = a - c, pb = b - c;
          return std::atan2(pa.dot(w), pa.dot(u)) <
                 std::atan2(pb.dot(w), pb.dot(u));
        });
        // dedupe near-identical vertices (incl. wraparound)
        std::vector<V3> capd;
        for (const auto& p : cap) {
          if (capd.empty() || (p - capd.back()).norm() > 1e-9)
            capd.push_back(p);
        }
        while (capd.size() >= 2 &&
               (capd.front() - capd.back()).norm() <= 1e-9)
          capd.pop_back();
        if (capd.size() >= 3) out.faces.push_back(capd);
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// RBSP builder (rbsp.cpp:181-404 semantics): global direction set; per node
// sweep ALL directions' projected-bound edges; candidate cost uses EXACT
// polytope surface areas from clipping the node cell
// ---------------------------------------------------------------------------

struct RBSPOut {
  std::vector<int32_t> flags;   // direction index, or n_dirs => leaf
  std::vector<float> split;     // plane offset t (plane: dot(p, dir) = t)
  std::vector<int32_t> above;
  std::vector<int32_t> nprims;
  std::vector<int32_t> prim_ids;
  int32_t max_depth_seen = 0;
};

struct RBSPBuilder {
  int n_dirs;
  const V3* dirs;
  const double* pmin;  // (n_prims, n_dirs) projected bounds
  const double* pmax;
  float icost, tcost, empty_bonus;
  int max_prims;
  RBSPOut out;

  int emit_leaf(const std::vector<int>& prims) {
    int id = (int)out.flags.size();
    out.flags.push_back(n_dirs);
    out.split.push_back(0.f);
    out.above.push_back((int)out.prim_ids.size());
    out.nprims.push_back((int)prims.size());
    for (int p : prims) out.prim_ids.push_back(p);
    return id;
  }

  int build(std::vector<int>& prims, const Polytope& cell, int depth,
            int bad_refines, int max_depth) {
    int n = (int)prims.size();
    out.max_depth_seen = std::max(out.max_depth_seen, depth);
    if (n <= max_prims || depth >= max_depth) return emit_leaf(prims);

    double total_sa = cell.area();
    double inv_sa = 1.0 / std::max(total_sa, 1e-300);
    double old_cost = icost * n;
    double best_cost = 1e300;
    int best_dir = -1;
    double best_t = 0;

    struct Edge { double t; int prim; bool start; };
    std::vector<Edge> edges(2 * n);
    for (int dd = 0; dd < n_dirs; dd++) {
      for (int i = 0; i < n; i++) {
        edges[2 * i] = {pmin[prims[i] * n_dirs + dd], prims[i], true};
        edges[2 * i + 1] = {pmax[prims[i] * n_dirs + dd], prims[i], false};
      }
      std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        return a.t < b.t || (a.t == b.t && a.start > b.start);
      });
      int below = 0, above = n;
      // node cell extent along dir (for candidate filtering)
      double cell_lo = 1e300, cell_hi = -1e300;
      for (const auto& f : cell.faces)
        for (const auto& v : f) {
          double p = v.dot(dirs[dd]);
          cell_lo = std::min(cell_lo, p);
          cell_hi = std::max(cell_hi, p);
        }
      for (int i = 0; i < 2 * n; i++) {
        if (!edges[i].start) above--;
        double t = edges[i].t;
        if (t > cell_lo + 1e-9 && t < cell_hi - 1e-9) {
          // EXACT polytope areas for this cut (kDOPMesh.h SurfaceArea)
          Polytope below_cell = cell.clip(dirs[dd], t);
          Polytope above_cell = cell.clip(dirs[dd] * -1.0, -t);
          double pb = below_cell.area() * inv_sa;
          double pa = above_cell.area() * inv_sa;
          double eb = (above == 0 || below == 0) ? empty_bonus : 0;
          double cost = tcost + icost * (1 - eb) * (pb * below + pa * above);
          if (cost < best_cost) { best_cost = cost; best_dir = dd; best_t = t; }
        }
        if (edges[i].start) below++;
      }
    }

    if (best_cost > old_cost) bad_refines++;
    if ((best_cost > 4 * old_cost && n < 16) || best_dir == -1 ||
        bad_refines == 3)
      return emit_leaf(prims);

    std::vector<int> below_p, above_p;
    for (int p : prims) {
      bool b = pmin[p * n_dirs + best_dir] < best_t;
      bool a = pmax[p * n_dirs + best_dir] > best_t;
      if (b) below_p.push_back(p);
      if (a) above_p.push_back(p);
      if (!b && !a) below_p.push_back(p);  // flat prim exactly on the plane
    }

    int id = (int)out.flags.size();
    out.flags.push_back(best_dir);
    out.split.push_back((float)best_t);
    out.above.push_back(0);
    out.nprims.push_back(0);

    Polytope bc = cell.clip(dirs[best_dir], best_t);
    Polytope ac = cell.clip(dirs[best_dir] * -1.0, -best_t);
    prims.clear(); prims.shrink_to_fit();
    build(below_p, bc, depth + 1, bad_refines, max_depth);
    int r = build(above_p, ac, depth + 1, bad_refines, max_depth);
    out.above[id] = r;
    return id;
  }
};

// ---------------------------------------------------------------------------
// Unrestricted-BSP family (reference: BSP.{h,cpp}, bspNodeBased.cpp,
// bspCluster/bspArbitrary/bspRandom[.WithKd/.FastKd].cpp, bspPaper[Kd].cpp,
// clustering.h, randomNormals.h). Per build node a direction CANDIDATE SET is
// chosen from the node's own primitives (k-means normal clusters / random
// primitive normals / uniform random directions / triangle-derived planes),
// then an edge-sort sweep with exact polytope surface areas picks the split.
// Interior nodes store a full split direction (BSP.h:11-60 treeInitInterior).
// ---------------------------------------------------------------------------

struct XorShift {  // deterministic small RNG (reference uses std::mt19937)
  uint64_t s;
  explicit XorShift(uint32_t seed) : s(seed * 2654435769u + 1) {}
  uint32_t next() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return (uint32_t)(s >> 32);
  }
  double uniform() { return next() * (1.0 / 4294967296.0); }
  int below(int n) { return (int)(uniform() * n) % std::max(n, 1); }
};

// PositiveX (geometry.h:1849): canonicalize a direction's sign
V3 positive_x(V3 v) {
  if (v.x < 0 || (v.x == 0 && v.y < 0) || (v.x == 0 && v.y == 0 && v.z < 0))
    return v * -1.0;
  return v;
}

struct BSPFamilyBuilder {
  int n_prims;
  const double* pts;       // (n, 8, 3) representative points
  const int32_t* npts;     // valid point count per prim
  const double* normals;   // (n, 3) unit normals
  int policy;              // 0 cluster, 1 arbitrary, 2 random, 3 paper
  int kd_mode;             // 0 none, 1 withkd, 2 fastkd
  int K;                   // candidate directions per node
  float icost, tcost, kd_tcost, empty_bonus;
  int max_prims;
  XorShift gen;
  static constexpr double BSP_ALPHA = 0.1;  // bspNodeBasedFastKd.cpp:29

  std::vector<int32_t> flags;  // 0 interior, 1 leaf
  std::vector<float> ndir;     // (n_nodes, 3) split direction
  std::vector<float> split;
  std::vector<int32_t> above, nprims, prim_ids;
  int32_t n_kd_nodes = 0, n_bsp_nodes = 0;

  BSPFamilyBuilder() : gen(1) {}

  void proj_bounds(int p, const V3& d, double& lo, double& hi) const {
    lo = 1e300; hi = -1e300;
    for (int k = 0; k < npts[p]; k++) {
      const double* q = pts + (p * 8 + k) * 3;
      double t = d.x * q[0] + d.y * q[1] + d.z * q[2];
      lo = std::min(lo, t);
      hi = std::max(hi, t);
    }
  }

  // clustering.h calculateClusterMeans: k-means on primitive normals with
  // angular distance; empty cluster -> reseed every mean
  std::vector<V3> cluster_means(const std::vector<int>& prims, int k) {
    int np = (int)prims.size();
    std::vector<V3> ns(np);
    for (int i = 0; i < np; i++)
      ns[i] = positive_x({normals[prims[i] * 3], normals[prims[i] * 3 + 1],
                          normals[prims[i] * 3 + 2]});
    if (np <= k) return ns;
    std::vector<V3> means(k);
    for (int i = 0; i < k; i++) means[i] = ns[gen.below(np)];
    for (int it = 0; it < 64; it++) {
      std::vector<V3> sums(k, {0, 0, 0});
      std::vector<int> cnt(k, 0);
      for (const auto& n : ns) {
        int best = 0;
        double bd = -2;
        for (int i = 0; i < k; i++) {
          double c = n.dot(means[i]);  // max cos == min angle
          if (c > bd) { bd = c; best = i; }
        }
        sums[best] = sums[best] + n;
        cnt[best]++;
      }
      bool empty = false;
      double max_diff = 0;
      for (int i = 0; i < k; i++) {
        if (!cnt[i]) { empty = true; break; }
        double nn = sums[i].norm();
        V3 m = nn > 1e-12 ? sums[i] * (1.0 / nn) : means[i];
        max_diff = std::max(max_diff, (m - means[i]).dot(m - means[i]));
        means[i] = m;
      }
      if (empty) {  // reseed all means (clustering.h empty-cluster path)
        for (int i = 0; i < k; i++) means[i] = ns[gen.below(np)];
        continue;
      }
      if (max_diff < 1e-6) break;
    }
    return means;
  }

  std::vector<V3> policy_dirs(const std::vector<int>& prims, int k) {
    std::vector<V3> out;
    if (k <= 0) return out;
    int np = (int)prims.size();
    if (policy == 0) return cluster_means(prims, k);
    if (policy == 1) {  // randomNormals.h chooseArbitraryNormals
      int want = std::min(np, k);
      for (int i = 0; i < want; i++) {
        int p = prims[gen.below(np)];
        out.push_back(positive_x(
            {normals[p * 3], normals[p * 3 + 1], normals[p * 3 + 2]}));
      }
    } else {  // randomNormals.h chooseRandomDirections
      for (int i = 0; i < k; i++) {
        double phi = 2 * 3.14159265358979323846 * gen.uniform();
        double ct = 2 * gen.uniform() - 1;
        double st = std::sqrt(std::max(0.0, 1 - ct * ct));
        out.push_back(positive_x({st * std::cos(phi), st * std::sin(phi), ct}));
      }
    }
    // drop degenerate (zero) normals
    std::vector<V3> ok;
    for (auto& d : out) if (d.norm() > 1e-9) ok.push_back(d);
    return ok;
  }

  int emit_leaf(const std::vector<int>& prims) {
    int id = (int)flags.size();
    flags.push_back(1);
    for (int a = 0; a < 3; a++) ndir.push_back(0.f);
    split.push_back(0.f);
    above.push_back((int)prim_ids.size());
    nprims.push_back((int)prims.size());
    for (int p : prims) prim_ids.push_back(p);
    return id;
  }

  // amount of node prims to the left/right of an arbitrary plane, via a
  // temporary BVH over the node's prims (bvh.cpp:439 getAmountToLeftAndRight
  // as used by bspPaper.cpp:214)
  struct NodeBVH {
    BVHBuilder b;
    std::vector<Box> boxes;
    void build(const BSPFamilyBuilder& fam, const std::vector<int>& prims) {
      boxes.resize(prims.size());
      for (size_t i = 0; i < prims.size(); i++) {
        boxes[i].reset();
        for (int k = 0; k < fam.npts[prims[i]]; k++) {
          const double* q = fam.pts + (prims[i] * 8 + k) * 3;
          Box pb;
          for (int a = 0; a < 3; a++) { pb.lo[a] = q[a]; pb.hi[a] = q[a]; }
          boxes[i].add(pb);
        }
      }
      b.boxes = boxes.data();
      b.icost = 8; b.tcost = 1; b.max_prims = 4;
      b.prim_ids.resize(prims.size());
      for (size_t i = 0; i < prims.size(); i++) b.prim_ids[i] = (int)i;
      if (!prims.empty()) b.build(0, (int)prims.size());
    }
    // returns (left, right) counts; prims straddling count on both sides
    std::pair<int, int> amount_left_right(
        const BSPFamilyBuilder& fam, const std::vector<int>& prims,
        const V3& dir, double t) const {
      int left = 0, right = 0;
      if (prims.empty()) return {0, 0};
      std::vector<int> stack = {0};
      while (!stack.empty()) {
        int ni = stack.back();
        stack.pop_back();
        const auto& o = b.out;
        V3 c{(o.lo[ni * 3] + o.hi[ni * 3]) * 0.5,
             (o.lo[ni * 3 + 1] + o.hi[ni * 3 + 1]) * 0.5,
             (o.lo[ni * 3 + 2] + o.hi[ni * 3 + 2]) * 0.5};
        V3 half{(o.hi[ni * 3] - o.lo[ni * 3]) * 0.5,
                (o.hi[ni * 3 + 1] - o.lo[ni * 3 + 1]) * 0.5,
                (o.hi[ni * 3 + 2] - o.lo[ni * 3 + 2]) * 0.5};
        double cp = c.dot(dir);
        double max_diff = half.norm();
        int cnt = o.count[ni];
        // subtree prim count: for interiors count the range it covers
        if (cp + max_diff < t || cp - max_diff > t) {
          int total = cnt;
          if (!cnt) {  // interior: count leaves below via explicit walk
            std::vector<int> st2 = {ni};
            total = 0;
            while (!st2.empty()) {
              int m = st2.back(); st2.pop_back();
              if (o.count[m]) total += o.count[m];
              else { st2.push_back(m + 1); st2.push_back(o.right[m]); }
            }
          }
          if (cp + max_diff < t) left += total; else right += total;
        } else if (cnt) {
          for (int i = 0; i < cnt; i++) {
            int p = prims[b.prim_ids[o.first[ni] + i]];
            double lo, hi;
            fam.proj_bounds(p, dir, lo, hi);
            if (lo <= t) left++;
            if (hi >= t) right++;
          }
        } else {
          stack.push_back(ni + 1);
          stack.push_back(o.right[ni]);
        }
      }
      return {left, right};
    }
  };

  int build(std::vector<int>& prims, const Polytope& cell, int depth,
            int bad_refines, int max_depth) {
    int n = (int)prims.size();
    if (n <= max_prims || depth >= max_depth) return emit_leaf(prims);

    double total_sa = cell.area();
    double inv_sa = 1.0 / std::max(total_sa, 1e-300);
    double old_cost = icost * n;
    double best_cost = 1e300;
    V3 best_dir{0, 0, 0};
    double best_t = 0;
    bool best_is_kd = false;

    // candidate direction set
    std::vector<V3> dirs;
    std::vector<bool> is_kd;
    int n_kd_dirs = 0;
    if (kd_mode > 0 || policy == 3) {
      dirs.push_back({1, 0, 0});
      dirs.push_back({0, 1, 0});
      dirs.push_back({0, 0, 1});
      is_kd = {true, true, true};
      n_kd_dirs = 3;
    }
    if (policy != 3) {
      int k_gen = kd_mode > 0 ? K - n_kd_dirs : K;  // Kmeans = K - 3
      for (auto& d : policy_dirs(prims, k_gen)) {
        dirs.push_back(d);
        is_kd.push_back(false);
      }
    }

    struct Edge { double t; int prim; bool start; };
    std::vector<Edge> edges(2 * n), best_edges;
    int best_offset = -1;
    for (size_t dd = 0; dd < dirs.size(); dd++) {
      const V3& d = dirs[dd];
      for (int i = 0; i < n; i++) {
        double lo, hi;
        proj_bounds(prims[i], d, lo, hi);
        edges[2 * i] = {lo, prims[i], true};
        edges[2 * i + 1] = {hi, prims[i], false};
      }
      std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        return a.t < b.t || (a.t == b.t && a.start > b.start);
      });
      double cell_lo = 1e300, cell_hi = -1e300;
      for (const auto& f : cell.faces)
        for (const auto& v : f) {
          double p = v.dot(d);
          cell_lo = std::min(cell_lo, p);
          cell_hi = std::max(cell_hi, p);
        }
      int below = 0, above_c = n;
      for (int i = 0; i < 2 * n; i++) {
        if (!edges[i].start) above_c--;
        double t = edges[i].t;
        if (t > cell_lo + 1e-9 && t < cell_hi - 1e-9) {
          Polytope bc = cell.clip(d, t);
          Polytope ac = cell.clip(d * -1.0, -t);
          double pb = bc.area() * inv_sa;
          double pa = ac.area() * inv_sa;
          double eb = (above_c == 0 || below == 0) ? empty_bonus : 0;
          double ci = icost * (1 - eb) * (pb * below + pa * above_c);
          double cost;
          if (kd_mode == 2)  // fastkd (bspNodeBasedFastKd.cpp:166,239)
            cost = is_kd[dd] ? kd_tcost + ci
                             : BSP_ALPHA * icost * (n - 1) + kd_tcost + ci;
          else
            cost = tcost + ci;
          if (cost < best_cost) {
            best_cost = cost;
            best_dir = d;
            best_t = t;
            best_is_kd = is_kd[dd];
            best_offset = i;
            best_edges = edges;
          }
        }
        if (edges[i].start) below++;
      }
    }

    // paper policy: triangle-derived candidate planes, counted via the
    // per-node BVH (bspPaper.cpp:186-231)
    NodeBVH nbvh;
    bool best_is_paper = false;
    if (policy == 3) {
      nbvh.build(*this, prims);
      double cell_lo, cell_hi;
      for (int pi = 0; pi < n; pi++) {
        int p = prims[pi];
        if (npts[p] < 3) continue;
        const double* q0 = pts + p * 8 * 3;
        V3 v0{q0[0], q0[1], q0[2]}, v1{q0[3], q0[4], q0[5]},
           v2{q0[6], q0[7], q0[8]};
        V3 nrm = (v1 - v0).cross(v2 - v0);
        double nl = nrm.norm();
        if (nl < 1e-12) continue;
        nrm = positive_x(nrm * (1.0 / nl));
        // supporting plane + 3 edge-orthogonal planes
        // (Triangle::getBSPPaperPlanes, triangle.cpp:678-740)
        V3 cands[4];
        double cand_t[4];
        int nc = 0;
        cands[nc] = nrm; cand_t[nc++] = nrm.dot(v0);
        V3 e01 = nrm.cross(v0 - v1), e02 = nrm.cross(v0 - v2),
           e12 = nrm.cross(v1 - v2);
        if (e01.norm() > 1e-12) {
          V3 a = positive_x(e01 * (1.0 / e01.norm()));
          cands[nc] = a; cand_t[nc++] = a.dot(v0);
        }
        if (e02.norm() > 1e-12) {
          V3 a = positive_x(e02 * (1.0 / e02.norm()));
          cands[nc] = a; cand_t[nc++] = a.dot(v0);
        }
        if (e12.norm() > 1e-12) {
          V3 a = positive_x(e12 * (1.0 / e12.norm()));
          cands[nc] = a; cand_t[nc++] = a.dot(v1);
        }
        for (int c = 0; c < nc; c++) {
          cell_lo = 1e300; cell_hi = -1e300;
          for (const auto& f : cell.faces)
            for (const auto& v : f) {
              double pr = v.dot(cands[c]);
              cell_lo = std::min(cell_lo, pr);
              cell_hi = std::max(cell_hi, pr);
            }
          double t = cand_t[c];
          if (!(t > cell_lo + 1e-9 && t < cell_hi - 1e-9)) continue;
          Polytope bc = cell.clip(cands[c], t);
          Polytope ac = cell.clip(cands[c] * -1.0, -t);
          double pb = bc.area() * inv_sa;
          double pa = ac.area() * inv_sa;
          auto lr = nbvh.amount_left_right(*this, prims, cands[c], t);
          double eb = (lr.second == 0 || lr.first == 0) ? empty_bonus : 0;
          double ci = icost * (1 - eb) * (pb * lr.first + pa * lr.second);
          double cost = kd_mode == 2
              ? BSP_ALPHA * icost * (n - 1) + kd_tcost + ci  // bspPaperKd.cpp:218
              : tcost + ci;
          if (cost < best_cost) {
            best_cost = cost;
            best_dir = cands[c];
            best_t = t;
            best_is_kd = false;
            best_is_paper = true;
          }
        }
      }
    }

    if (best_cost > old_cost) bad_refines++;
    if ((best_cost > 4 * old_cost && n < 16) || best_dir.norm() < 0.5 ||
        bad_refines == 3)
      return emit_leaf(prims);

    std::vector<int> below_p, above_p;
    if (best_is_paper || best_offset < 0) {
      for (int p : prims) {  // direct projected-bound classification
        double lo, hi;
        proj_bounds(p, best_dir, lo, hi);
        bool b = lo < best_t, a = hi > best_t;
        if (b) below_p.push_back(p);
        if (a) above_p.push_back(p);
        if (!b && !a) below_p.push_back(p);
      }
    } else {  // partition from the winning edge list (bspNodeBased.cpp:188)
      for (int i = 0; i < best_offset; i++)
        if (best_edges[i].start) below_p.push_back(best_edges[i].prim);
      for (int i = best_offset + 1; i < 2 * n; i++)
        if (!best_edges[i].start) above_p.push_back(best_edges[i].prim);
    }
    if (below_p.empty() && above_p.empty()) return emit_leaf(prims);

    if (best_is_kd) n_kd_nodes++; else n_bsp_nodes++;

    int id = (int)flags.size();
    flags.push_back(0);
    ndir.push_back((float)best_dir.x);
    ndir.push_back((float)best_dir.y);
    ndir.push_back((float)best_dir.z);
    split.push_back((float)best_t);
    above.push_back(0);
    nprims.push_back(0);

    Polytope bc = cell.clip(best_dir, best_t);
    Polytope ac = cell.clip(best_dir * -1.0, -best_t);
    prims.clear(); prims.shrink_to_fit();
    build(below_p, bc, depth + 1, bad_refines, max_depth);
    int r = build(above_p, ac, depth + 1, bad_refines, max_depth);
    above[id] = r;
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

int tpb_build_kdtree(int n, const float* prim_lo, const float* prim_hi,
                     float icost, float tcost, float empty_bonus,
                     int max_prims, int max_depth,
                     int32_t** out_flags, float** out_split,
                     int32_t** out_above, int32_t** out_nprims,
                     int32_t** out_prim_ids, int32_t* out_n_prim_ids,
                     int32_t* out_n_nodes, float* out_bounds_lo,
                     float* out_bounds_hi, double* out_build_s) {
  auto t0 = std::chrono::steady_clock::now();
  std::vector<Box> boxes(n);
  Box world; world.reset();
  for (int i = 0; i < n; i++) {
    for (int a = 0; a < 3; a++) {
      boxes[i].lo[a] = prim_lo[i * 3 + a];
      boxes[i].hi[a] = prim_hi[i * 3 + a];
    }
    world.add(boxes[i]);
  }
  if (max_depth <= 0)
    max_depth = (int)std::round(8 + 1.3 * std::log2(std::max(n, 1)));
  KdBuilder b;
  b.boxes = boxes.data();
  b.icost = icost; b.tcost = tcost; b.empty_bonus = empty_bonus;
  b.max_prims = max_prims; b.max_depth = max_depth;
  std::vector<int> prims(n);
  for (int i = 0; i < n; i++) prims[i] = i;
  b.build(prims, world, max_depth, 0);
  *out_flags = copy_out(b.out.flags);
  *out_split = copy_out(b.out.split);
  *out_above = copy_out(b.out.above);
  *out_nprims = copy_out(b.out.nprims);
  *out_prim_ids = copy_out(b.out.prim_ids);
  *out_n_prim_ids = (int32_t)b.out.prim_ids.size();
  *out_n_nodes = (int32_t)b.out.flags.size();
  for (int a = 0; a < 3; a++) {
    out_bounds_lo[a] = (float)world.lo[a];
    out_bounds_hi[a] = (float)world.hi[a];
  }
  *out_build_s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  return 0;
}

int tpb_build_rbsp(int n, int n_dirs, const double* dirs_xyz,
                   const double* pmin, const double* pmax,
                   const float* world_lo, const float* world_hi,
                   float icost, float tcost, float empty_bonus,
                   int max_prims, int max_depth,
                   int32_t** out_flags, float** out_split,
                   int32_t** out_above, int32_t** out_nprims,
                   int32_t** out_prim_ids, int32_t* out_n_prim_ids,
                   int32_t* out_n_nodes, double* out_build_s) {
  auto t0 = std::chrono::steady_clock::now();
  std::vector<V3> dirs(n_dirs);
  for (int i = 0; i < n_dirs; i++)
    dirs[i] = {dirs_xyz[3 * i], dirs_xyz[3 * i + 1], dirs_xyz[3 * i + 2]};
  Box world;
  for (int a = 0; a < 3; a++) {
    world.lo[a] = world_lo[a];
    world.hi[a] = world_hi[a];
  }
  if (max_depth <= 0)
    max_depth = (int)std::round(8 + 1.3 * std::log2(std::max(n, 1)));
  RBSPBuilder b;
  b.n_dirs = n_dirs;
  b.dirs = dirs.data();
  b.pmin = pmin; b.pmax = pmax;
  b.icost = icost; b.tcost = tcost; b.empty_bonus = empty_bonus;
  b.max_prims = max_prims;
  std::vector<int> prims(n);
  for (int i = 0; i < n; i++) prims[i] = i;
  b.build(prims, Polytope::box(world), 0, 0, max_depth);
  *out_flags = copy_out(b.out.flags);
  *out_split = copy_out(b.out.split);
  *out_above = copy_out(b.out.above);
  *out_nprims = copy_out(b.out.nprims);
  *out_prim_ids = copy_out(b.out.prim_ids);
  *out_n_prim_ids = (int32_t)b.out.prim_ids.size();
  *out_n_nodes = (int32_t)b.out.flags.size();
  *out_build_s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  return 0;
}

// Unrestricted-BSP family builder (bspCluster/bspArbitrary/bspRandom
// [+WithKd/FastKd], bspPaper[Kd] parity). pts: (n,8,3) representative points
// per prim (triangle vertices / AABB corners), npts: valid count; normals:
// (n,3). policy: 0 cluster, 1 arbitrary, 2 random, 3 paper. kd_mode: 0 none,
// 1 withkd, 2 fastkd. Outputs per-node split DIRECTION (out_dir) since
// unrestricted-BSP interiors carry a full Vector3f (BSP.h:11-60).
int tpb_build_bsp(int n, const double* pts, const int32_t* npts,
                  const double* normals, const float* world_lo,
                  const float* world_hi, int policy, int kd_mode, int k,
                  float icost, float tcost, float kd_tcost, float empty_bonus,
                  int max_prims, int max_depth, uint32_t seed,
                  int32_t** out_flags, float** out_dir, float** out_split,
                  int32_t** out_above, int32_t** out_nprims,
                  int32_t** out_prim_ids, int32_t* out_n_prim_ids,
                  int32_t* out_n_nodes, int32_t* out_n_kd_nodes,
                  int32_t* out_n_bsp_nodes, double* out_build_s) {
  auto t0 = std::chrono::steady_clock::now();
  Box world;
  for (int a = 0; a < 3; a++) {
    world.lo[a] = world_lo[a];
    world.hi[a] = world_hi[a];
  }
  if (max_depth <= 0)
    max_depth = (int)std::round(8 + 1.3 * std::log2(std::max(n, 1)));
  BSPFamilyBuilder b;
  b.n_prims = n;
  b.pts = pts; b.npts = npts; b.normals = normals;
  b.policy = policy; b.kd_mode = kd_mode; b.K = k;
  b.icost = icost; b.tcost = tcost; b.kd_tcost = kd_tcost;
  b.empty_bonus = empty_bonus;
  b.max_prims = max_prims;
  b.gen = XorShift(seed ? seed : 1);
  std::vector<int> prims(n);
  for (int i = 0; i < n; i++) prims[i] = i;
  b.build(prims, Polytope::box(world), 0, 0, max_depth);
  *out_flags = copy_out(b.flags);
  *out_dir = copy_out(b.ndir);
  *out_split = copy_out(b.split);
  *out_above = copy_out(b.above);
  *out_nprims = copy_out(b.nprims);
  *out_prim_ids = copy_out(b.prim_ids);
  *out_n_prim_ids = (int32_t)b.prim_ids.size();
  *out_n_nodes = (int32_t)b.flags.size();
  *out_n_kd_nodes = b.n_kd_nodes;
  *out_n_bsp_nodes = b.n_bsp_nodes;
  *out_build_s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  return 0;
}

// exact polytope surface area after a sequence of cuts — exposed for the
// kdop parity tests (reference src/tests/kdop.cpp)
double tpb_polytope_cut_area(const float* box_lo, const float* box_hi,
                             int n_cuts, const double* cut_dirs,
                             const double* cut_ts) {
  Box bx;
  for (int a = 0; a < 3; a++) { bx.lo[a] = box_lo[a]; bx.hi[a] = box_hi[a]; }
  Polytope p = Polytope::box(bx);
  for (int i = 0; i < n_cuts; i++) {
    V3 d{cut_dirs[3 * i], cut_dirs[3 * i + 1], cut_dirs[3 * i + 2]};
    p = p.clip(d, cut_ts[i]);
  }
  return p.area();
}

}  // extern "C"
