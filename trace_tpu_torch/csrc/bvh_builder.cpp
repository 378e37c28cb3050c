// Native SAH BVH builder (the port's own copy of trace_tpu/native/
// bvh_builder.cpp; only this header comment differs).
//
// C++ counterpart of trace_tpu/accel/bvh.py:build_bvh — same 12-bucket SAH
// recursion and flattened depth-first first-child-adjacent layout as the
// reference (src/accel/bvh.jl:87-206), built natively so
// million-triangle scenes (BASELINE.json config 4) build in milliseconds
// instead of Python-minutes. Exposed through ctypes (no pybind11 in this
// environment). The Python builder (accel/bvh.py, native=False) is the
// equality oracle in tests and runs only when asked for: a failed build
// of this file raises, it does not fall back.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libbvh.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBuckets = 12;

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double surface_area(const Vec3 &lo, const Vec3 &hi) {
  double dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0 * (dx * dy + dy * dz + dx * dz);
}

struct Range {
  int64_t start, end;
  int64_t parent;
  bool second;
};

}  // namespace

extern "C" int64_t bvh_build(const float *bounds, int64_t t_count,
                             int32_t max_prims_per_leaf, int64_t capacity,
                             float *node_lo, float *node_hi,
                             int32_t *right_child, int32_t *prim_start,
                             int32_t *n_prims, int32_t *axis_out,
                             int32_t *prim_order) {
  if (t_count <= 0) return 0;
  std::vector<Vec3> lo_all(t_count), hi_all(t_count), cent(t_count);
  for (int64_t i = 0; i < t_count; ++i) {
    lo_all[i] = {bounds[i * 6 + 0], bounds[i * 6 + 1], bounds[i * 6 + 2]};
    hi_all[i] = {bounds[i * 6 + 3], bounds[i * 6 + 4], bounds[i * 6 + 5]};
    cent[i] = {0.5f * (lo_all[i].x + hi_all[i].x),
               0.5f * (lo_all[i].y + hi_all[i].y),
               0.5f * (lo_all[i].z + hi_all[i].z)};
  }
  for (int64_t i = 0; i < t_count; ++i) prim_order[i] = (int32_t)i;

  int64_t n_nodes = 0;
  std::vector<Range> stack;
  stack.push_back({0, t_count, -1, false});

  std::vector<int32_t> tmp(t_count);

  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    if (n_nodes >= capacity) return -1;
    int64_t node = n_nodes++;
    if (r.parent >= 0 && r.second) right_child[r.parent] = (int32_t)node;

    Vec3 blo = {std::numeric_limits<float>::max(),
                std::numeric_limits<float>::max(),
                std::numeric_limits<float>::max()};
    Vec3 bhi = {-std::numeric_limits<float>::max(),
                -std::numeric_limits<float>::max(),
                -std::numeric_limits<float>::max()};
    Vec3 clo = blo, chi = bhi;
    for (int64_t k = r.start; k < r.end; ++k) {
      int32_t id = prim_order[k];
      blo = vmin(blo, lo_all[id]);
      bhi = vmax(bhi, hi_all[id]);
      clo = vmin(clo, cent[id]);
      chi = vmax(chi, cent[id]);
    }
    node_lo[node * 3 + 0] = blo.x;
    node_lo[node * 3 + 1] = blo.y;
    node_lo[node * 3 + 2] = blo.z;
    node_hi[node * 3 + 0] = bhi.x;
    node_hi[node * 3 + 1] = bhi.y;
    node_hi[node * 3 + 2] = bhi.z;
    right_child[node] = -1;
    prim_start[node] = 0;
    n_prims[node] = 0;
    axis_out[node] = 0;

    int64_t count = r.end - r.start;
    auto make_leaf = [&]() {
      prim_start[node] = (int32_t)r.start;
      n_prims[node] = (int32_t)count;
    };
    if (count <= 1) {
      make_leaf();
      continue;
    }

    Vec3 diag = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = 0;
    if (diag.y > diag[axis]) axis = 1;
    if (diag.z > diag[axis]) axis = 2;
    axis_out[node] = axis;
    if (diag[axis] < 1e-12f) {
      make_leaf();
      continue;
    }

    int64_t mid;
    if (count <= 2) {
      // Median split (stable by centroid).
      std::stable_sort(
          prim_order + r.start, prim_order + r.end,
          [&](int32_t a, int32_t b) { return cent[a][axis] < cent[b][axis]; });
      mid = r.start + count / 2;
    } else {
      // Bucketed SAH.
      int64_t bucket_n[kBuckets] = {0};
      Vec3 bucket_lo[kBuckets], bucket_hi[kBuckets];
      for (int i = 0; i < kBuckets; ++i) {
        bucket_lo[i] = {std::numeric_limits<float>::max(),
                        std::numeric_limits<float>::max(),
                        std::numeric_limits<float>::max()};
        bucket_hi[i] = {-std::numeric_limits<float>::max(),
                        -std::numeric_limits<float>::max(),
                        -std::numeric_limits<float>::max()};
      }
      float inv = 1.0f / diag[axis];
      auto bucket_of = [&](int32_t id) {
        float rel = (cent[id][axis] - clo[axis]) * inv;
        int bk = (int)(rel * kBuckets);
        return std::min(bk, kBuckets - 1);
      };
      for (int64_t k = r.start; k < r.end; ++k) {
        int32_t id = prim_order[k];
        int bk = bucket_of(id);
        bucket_n[bk]++;
        bucket_lo[bk] = vmin(bucket_lo[bk], lo_all[id]);
        bucket_hi[bk] = vmax(bucket_hi[bk], hi_all[id]);
      }
      double total_sa = std::max(surface_area(blo, bhi), 1e-20);
      double best_cost = std::numeric_limits<double>::infinity();
      int best_split = -1;
      for (int split = 0; split < kBuckets - 1; ++split) {
        int64_t nl = 0, nr = 0;
        Vec3 llo = bucket_lo[0], lhi = bucket_hi[0];
        llo = {std::numeric_limits<float>::max(),
               std::numeric_limits<float>::max(),
               std::numeric_limits<float>::max()};
        lhi = {-std::numeric_limits<float>::max(),
               -std::numeric_limits<float>::max(),
               -std::numeric_limits<float>::max()};
        Vec3 rlo = llo, rhi = lhi;
        for (int i = 0; i <= split; ++i) {
          if (!bucket_n[i]) continue;
          nl += bucket_n[i];
          llo = vmin(llo, bucket_lo[i]);
          lhi = vmax(lhi, bucket_hi[i]);
        }
        for (int i = split + 1; i < kBuckets; ++i) {
          if (!bucket_n[i]) continue;
          nr += bucket_n[i];
          rlo = vmin(rlo, bucket_lo[i]);
          rhi = vmax(rhi, bucket_hi[i]);
        }
        if (nl == 0 || nr == 0) continue;
        double cost = 1.0 + (nl * surface_area(llo, lhi) +
                             nr * surface_area(rlo, rhi)) /
                                total_sa;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = split;
        }
      }
      double leaf_cost = (double)count;
      if (best_split < 0 ||
          (count <= max_prims_per_leaf && best_cost >= leaf_cost)) {
        make_leaf();
        continue;
      }
      // Stable partition (matches numpy concatenate of masked ids).
      int64_t w = 0;
      for (int64_t k = r.start; k < r.end; ++k)
        if (bucket_of(prim_order[k]) <= best_split)
          tmp[w++] = prim_order[k];
      int64_t nl = w;
      for (int64_t k = r.start; k < r.end; ++k)
        if (bucket_of(prim_order[k]) > best_split)
          tmp[w++] = prim_order[k];
      if (nl == 0 || nl == count) {
        make_leaf();
        continue;
      }
      std::memcpy(prim_order + r.start, tmp.data(),
                  sizeof(int32_t) * (size_t)count);
      mid = r.start + nl;
    }

    stack.push_back({mid, r.end, node, true});
    stack.push_back({r.start, mid, node, false});
  }
  return n_nodes;
}

// Bottom-up bounds refit for animated geometry with fixed topology
// (BASELINE.json config 5). The flattened layout is depth-first with the
// first child adjacent, so every child index is greater than its parent's
// — one reverse sweep updates leaves from fresh primitive bounds and
// interiors from their (already refreshed) children.
extern "C" void bvh_refit(const float *bounds, int64_t /*t_count*/,
                          int64_t n_nodes, float *node_lo, float *node_hi,
                          const int32_t *right_child,
                          const int32_t *prim_start, const int32_t *n_prims,
                          const int32_t *prim_order) {
  for (int64_t node = n_nodes - 1; node >= 0; --node) {
    Vec3 blo = {std::numeric_limits<float>::max(),
                std::numeric_limits<float>::max(),
                std::numeric_limits<float>::max()};
    Vec3 bhi = {-std::numeric_limits<float>::max(),
                -std::numeric_limits<float>::max(),
                -std::numeric_limits<float>::max()};
    if (n_prims[node] > 0) {
      for (int32_t k = 0; k < n_prims[node]; ++k) {
        int32_t id = prim_order[prim_start[node] + k];
        blo = vmin(blo, {bounds[id * 6 + 0], bounds[id * 6 + 1],
                         bounds[id * 6 + 2]});
        bhi = vmax(bhi, {bounds[id * 6 + 3], bounds[id * 6 + 4],
                         bounds[id * 6 + 5]});
      }
    } else {
      int64_t c0 = node + 1;
      int64_t c1 = right_child[node];
      blo = vmin({node_lo[c0 * 3], node_lo[c0 * 3 + 1], node_lo[c0 * 3 + 2]},
                 {node_lo[c1 * 3], node_lo[c1 * 3 + 1], node_lo[c1 * 3 + 2]});
      bhi = vmax({node_hi[c0 * 3], node_hi[c0 * 3 + 1], node_hi[c0 * 3 + 2]},
                 {node_hi[c1 * 3], node_hi[c1 * 3 + 1], node_hi[c1 * 3 + 2]});
    }
    node_lo[node * 3 + 0] = blo.x;
    node_lo[node * 3 + 1] = blo.y;
    node_lo[node * 3 + 2] = blo.z;
    node_hi[node * 3 + 0] = bhi.x;
    node_hi[node * 3 + 1] = bhi.y;
    node_hi[node * 3 + 2] = bhi.z;
  }
}

// Subtree cluster cut over the flattened tree — native counterpart of
// accel/clusters.py:_subtree_ranges plus the cut stack loop (the two
// per-node Python loops dominate 1M-triangle builds, ~14 s of the ~27 s
// accelerator attach). The depth-first first-child-adjacent layout makes
// every subtree's primitives a contiguous range of prim_order; one
// reverse sweep yields subtree counts, one DFS carrying the running
// range start emits the frontier of subtrees with <= leaf_tris prims.
// Emission order (left child first) matches the Python oracle exactly.
extern "C" int64_t bvh_cluster_cut(int64_t n_nodes,
                                   const int32_t *right_child,
                                   const int32_t *n_prims,
                                   int32_t leaf_tris, int64_t capacity,
                                   int32_t *cut_nodes, int64_t *cut_starts,
                                   int64_t *cut_counts) {
  if (n_nodes <= 0) return 0;
  std::vector<int64_t> count(n_nodes);
  for (int64_t node = n_nodes - 1; node >= 0; --node) {
    count[node] = n_prims[node] > 0
                      ? n_prims[node]
                      : count[node + 1] + count[right_child[node]];
  }
  struct Item {
    int64_t node, s;
  };
  std::vector<Item> stack;
  stack.push_back({0, 0});
  int64_t c = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    if (count[it.node] <= leaf_tris || n_prims[it.node] > 0) {
      if (c >= capacity) return -1;
      cut_nodes[c] = (int32_t)it.node;
      cut_starts[c] = it.s;
      cut_counts[c] = count[it.node];
      ++c;
    } else {
      stack.push_back(
          {(int64_t)right_child[it.node], it.s + count[it.node + 1]});
      stack.push_back({it.node + 1, it.s});
    }
  }
  return c;
}

// Cluster block packing — native counterpart of the numpy packing tail of
// accel/clusters.py:build_clusters / refit_clusters (gather + f64
// Moller-Trumbore constants; ~9 s of a 1M-triangle build). Layouts match
// the numpy oracle exactly:
//   packed    [c, packed_stride]: v0|v1|v2 blocks, each l slots of
//             interleaved xyz (3l floats); zero padding.
//   packed_mt [c, mt_stride]: nrm|e1|e2|w|q component-major (3l each,
//             all-x then all-y then all-z) then v0n (l); zero padding.
// All constants are computed in double and rounded once to f32, exactly
// as the numpy path does (the library is built with -ffp-contract=off so
// no FMA contraction changes the roundings). tri_id < 0 slots stay zero
// (det = 0, never hit). Optional bounds output (pass null to skip) for
// the refit path.
extern "C" void cluster_pack(const float *v0, const float *v1,
                             const float *v2, const int32_t *tri_id,
                             int64_t c, int32_t l, int64_t packed_stride,
                             int64_t mt_stride, float *packed,
                             float *packed_mt, float *b_lo, float *b_hi) {
  for (int64_t i = 0; i < c; ++i) {
    float *pk = packed + i * packed_stride;
    float *mt = packed_mt + i * mt_stride;
    std::memset(pk, 0, sizeof(float) * (size_t)packed_stride);
    std::memset(mt, 0, sizeof(float) * (size_t)mt_stride);
    float lo[3] = {3e38f, 3e38f, 3e38f};
    float hi[3] = {-3e38f, -3e38f, -3e38f};
    for (int32_t k = 0; k < l; ++k) {
      int32_t id = tri_id[i * l + k];
      if (id < 0) continue;
      double a[3], b[3], d[3];
      for (int j = 0; j < 3; ++j) {
        float f0 = v0[(int64_t)id * 3 + j];
        float f1 = v1[(int64_t)id * 3 + j];
        float f2 = v2[(int64_t)id * 3 + j];
        a[j] = f0;
        b[j] = f1;
        d[j] = f2;
        pk[0 * 3 * l + k * 3 + j] = f0;
        pk[1 * 3 * l + k * 3 + j] = f1;
        pk[2 * 3 * l + k * 3 + j] = f2;
        if (b_lo) {
          float mn = std::min(f0, std::min(f1, f2));
          float mx = std::max(f0, std::max(f1, f2));
          lo[j] = std::min(lo[j], mn);
          hi[j] = std::max(hi[j], mx);
        }
      }
      double e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      double e2[3] = {d[0] - a[0], d[1] - a[1], d[2] - a[2]};
      double nrm[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                       e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]};
      double w[3] = {e2[1] * a[2] - e2[2] * a[1],
                     e2[2] * a[0] - e2[0] * a[2],
                     e2[0] * a[1] - e2[1] * a[0]};
      double q[3] = {a[1] * e1[2] - a[2] * e1[1],
                     a[2] * e1[0] - a[0] * e1[2],
                     a[0] * e1[1] - a[1] * e1[0]};
      double v0n = a[0] * nrm[0] + a[1] * nrm[1] + a[2] * nrm[2];
      for (int j = 0; j < 3; ++j) {
        mt[(0 * 3 + j) * l + k] = (float)nrm[j];
        mt[(1 * 3 + j) * l + k] = (float)e1[j];
        mt[(2 * 3 + j) * l + k] = (float)e2[j];
        mt[(3 * 3 + j) * l + k] = (float)w[j];
        mt[(4 * 3 + j) * l + k] = (float)q[j];
      }
      mt[15 * l + k] = (float)v0n;
    }
    if (b_lo) {
      for (int j = 0; j < 3; ++j) {
        b_lo[i * 3 + j] = lo[j];
        b_hi[i * 3 + j] = hi[j];
      }
    }
  }
}
