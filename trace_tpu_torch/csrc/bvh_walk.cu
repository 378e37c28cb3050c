// Per-ray BVH stack walk for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's two BVH walks, which are XLA while_loops, not
// Pallas kernels: trace_tpu/accel/wbvh.py::traverse_batch (a batch of rays
// one tree step per loop trip, the "wbvh" limit) and
// trace_tpu/accel/bvh.py::_traverse_one (one ray, vmapped; the "bvh"
// limit). Each step of those loops is dozens of XLA ops over the whole
// batch; here one thread walks one ray from the root to its last node.
//
// The walk, as the JAX loops run it:
//   - a node's slab test uses precomputed 1/d; a NaN from (lo - o) * inf
//     (the origin on a slab plane, d = 0 on that axis) opens the slab:
//     near -inf, far +inf, as jnp.minimum / jnp.maximum propagate the NaN
//     and the where() heals it (fminf / fmaxf would drop it instead and
//     open or close the wrong boxes); the far distance is padded by
//     1.00000024f; the box is entered when tn <= tf, tf > 0 and tn < the
//     running best t;
//   - at an interior node the near child (by the sign of 1/d on the
//     split axis; d = -0.0 gives -inf, negative) is visited next and the
//     far child pushed; at a leaf, and after a miss, the stack is popped;
//   - a leaf tests EVERY one of its n_prims triangles with the watertight
//     test (wavefront/geom.py::_watertight): the JAX walks stop at
//     max_leaf, and the builders' coincident-centroid leaves are larger;
//   - strict t < best: on a t-tie the first-visited triangle keeps it;
//   - "wbvh" limit: the test's t_max is the running best; "bvh" limit:
//     the test's t_max is +inf. Then t < best in both: the best starts
//     at t_max and only falls, so the "bvh" walk's t <= t_max (JAX's
//     bvh.py) is implied. The two arms differ only in the test's t_max;
//   - any-hit retires a lane at its first hit;
//   - a lane whose t_max is not > 0 (or NaN) walks nothing: no triangle
//     could pass either limit's tests for it.
// The stack holds at most the tree's interior depth; the accelerators
// (accel/wbvh.py) refuse a stack_depth below depth + 2, and this launch
// any above kStackCap. A push beyond stack_depth is dropped, as in JAX.
//
// Rounding: built with --fmad=false; every product, sum and IEEE division
// in the association order of the plain version (accel/wbvh.py::
// walk_plain), so the two agree bit for bit.
//
// What bounds it on this card: FP32 instructions -- ~32 a node visit (the
// slab) and ~80 a triangle test (the watertight test) -- for the visits
// and tests the rays' own walks need, or the bytes that must come from
// HBM (each distinct node row, 32 B, and triangle row, 48 B, the walks
// touch, once; the rays and the outputs), whichever is more. The
// counting arm marks the rows it touches for that. What holds it back
// instead is a call's longest walks: up to ~600 visits on the 1M
// terrain's grazing rays, each a dependent node load, ~290 ns a visit
// on an idle H100 and more under load; a 1M-ray call lasts about twice
// its longest walk (PERF.md section 6). The design: one thread a ray,
// 128 threads a CTA, node rows read as two float4 and triangle rows as
// three, the stack of node indices in local memory; and three changes,
// each measured faster on the same calls:
//   - a ray that walks nothing (t_max not > 0, or NaN: most lanes of a
//     wavefront's later depths) reads only its t_max and writes its miss,
//     so a 1M-lane call with a few thousand live lanes is done with its
//     dead lanes in a few microseconds instead of after a pass of loads
//     and divisions on every lane;
//   - the watertight test returns at its first failed condition (edge
//     signs, det, the t range, a degenerate triangle) and divides only
//     for a triangle that passes: a leaf's misses cost a few dozen
//     instructions, and a warp's lanes at leaves hold its other lanes
//     back less;
//   - the slab's NaN heal is one test of a + b (NaN exactly when a or b is,
//     or when they are infinities of opposite sign, whose min and max are
//     -inf and +inf anyway) and fminf / fmaxf, with no branch.
// Not kept, each measured slower on this card on the same calls
// (PERF.md section 6): persistent warps taking rays from a counter, the
// while-while loop, both children's rows at each step with the far
// child's slab key on the stack, the first child's row loaded with its
// parent's, the next triangle's row loaded early, 64-thread CTAs, a
// 40-register bound, and an L2 persisting window over the node rows. Rays
// come in the caller's order (WBVHAccelerator's sort_rays, off by
// default, sorts them for coherence first).
//
// Layouts (all contiguous):
//   nodes f32 [M, 8]:  lo.xyz, hi.xyz, link (leaf: first row of its
//                      triangles; interior: right child), meta
//                      (n_prims << 2 | axis); link and meta int32 bits
//   tris  f32 [T, 12]: leaf-ordered v0.xyz v1.xyz v2.xyz, original id
//                      (int32 bits), 2 pad
//   o, d  f32 [N, 3]; t_max f32 [N]
//   out_t f32 [N] (+inf on a miss), out_i i32 [N] (-1 on a miss),
//   stats i32 [2, N] (node visits, triangle tests) when asked for, and
//   with them, where given, node_seen u8 [M] and tri_seen u8 [T] set to 1
//   at each row a walk touched (the caller zeroes them)

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStackCap = 64;  // trace_tpu/accel/bvh.py:25 STACK_DEPTH

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;       // 1 / d
  bool m0, m1;            // the watertight permutation: kz = 0, kz = 1
  float sx, sy, sz;       // its shear
};

// (w[kx], w[ky], w[kz]) of the cyclic permutation with kz = argmax |d|.
__device__ __forceinline__ void perm3(const Ray &r, float wx, float wy,
                                      float wz, float &vx, float &vy,
                                      float &vz) {
  vx = r.m0 ? wy : (r.m1 ? wz : wx);
  vy = r.m0 ? wz : (r.m1 ? wx : wy);
  vz = r.m0 ? wx : (r.m1 ? wy : wz);
}

// One axis of the slab test, NaN-propagating min/max then healed. The
// slab's result is a set of comparisons, so fminf / fmaxf's choice
// between -0.0 and +0.0 cannot change it.
__device__ __forceinline__ void near_far(float lo, float hi, float o,
                                         float inv, float &n, float &f) {
  const float a = (lo - o) * inv;
  const float b = (hi - o) * inv;
  const bool open = isnan(a + b);
  n = open ? -CUDART_INF_F : fminf(a, b);
  f = open ? CUDART_INF_F : fmaxf(a, b);
}

__device__ __forceinline__ bool slab(const Ray &r, float4 a, float4 b,
                                     float limit) {
  float nx, fx, ny, fy, nz, fz;
  near_far(a.x, a.w, r.ox, r.ix, nx, fx);
  near_far(a.y, b.x, r.oy, r.iy, ny, fy);
  near_far(a.z, b.y, r.oz, r.iz, nz, fz);
  const float tn = fmaxf(fmaxf(nx, ny), nz);
  const float tf = fminf(fminf(fx, fy), fz) * 1.00000024f;
  return tn <= tf && tf > 0.0f && tn < limit;
}

__device__ __forceinline__ void shear(const Ray &r, float vx, float vy,
                                      float vz, float &x, float &y,
                                      float &z) {
  float tx, ty, tz;
  perm3(r, vx - r.ox, vy - r.oy, vz - r.oz, tx, ty, tz);
  x = tx + r.sx * tz;
  y = ty + r.sy * tz;
  z = tz;
}

// The watertight test (wavefront/geom.py::_watertight, exact_edges off):
// whether the ray hits the triangle with 0 < t <= t_lim; t on a hit. The
// plain version's conditions, tested in order of cost; t is computed
// only for a hit, the only case in which the caller reads it.
__device__ __forceinline__ bool watertight(const Ray &r, float4 p, float4 q,
                                           float4 s, float t_lim, float &t) {
  // v0 = p.xyz, v1 = (p.w, q.x, q.y), v2 = (q.z, q.w, s.x)
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  shear(r, p.x, p.y, p.z, x0, y0, z0);
  shear(r, p.w, q.x, q.y, x1, y1, z1);
  shear(r, q.z, q.w, s.x, x2, y2, z2);
  const float e0 = x1 * y2 - y1 * x2;
  const float e1 = x2 * y0 - y2 * x0;
  const float e2 = x0 * y1 - y0 * x1;
  if ((e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) &&
      (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f))
    return false;  // the edge functions' signs are mixed
  const float det = e0 + e1 + e2;
  if (det == 0.0f) return false;
  const float ts = e0 * (z0 * r.sz) + e1 * (z1 * r.sz) + e2 * (z2 * r.sz);
  if (det < 0.0f ? (ts >= 0.0f || ts < t_lim * det)
                 : (ts <= 0.0f || ts > t_lim * det))
    return false;
  const float ax = q.z - p.x, ay = q.w - p.y, az = s.x - p.z;  // v2 - v0
  const float bx = p.w - p.x, by = q.x - p.y, bz = q.y - p.z;  // v1 - v0
  const float cx = ay * bz - az * by;
  const float cy = az * bx - ax * bz;
  const float cz = ax * by - ay * bx;
  if (cx * cx + cy * cy + cz * cz == 0.0f) return false;  // degenerate
  t = ts * (1.0f / det);
  return true;
}

template <bool kAnyHit, bool kBvhLimit, bool kStats>
__global__ void __launch_bounds__(kThreads)
    bvh_walk_kernel(const float4 *__restrict__ nodes,
                    const float4 *__restrict__ tris,
                    const float *__restrict__ o, const float *__restrict__ d,
                    const float *__restrict__ t_max,
                    float *__restrict__ out_t, int32_t *__restrict__ out_i,
                    int32_t *__restrict__ stats,
                    uint8_t *__restrict__ node_seen,
                    uint8_t *__restrict__ tri_seen, int n, int stack_depth) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float tm = t_max[lane];
  if (!(tm > 0.0f)) {  // walks nothing
    out_t[lane] = CUDART_INF_F;
    out_i[lane] = -1;
    if (kStats) {
      stats[lane] = 0;
      stats[n + lane] = 0;
    }
    return;
  }
  Ray r;
  r.ox = o[3 * lane];
  r.oy = o[3 * lane + 1];
  r.oz = o[3 * lane + 2];
  r.dx = d[3 * lane];
  r.dy = d[3 * lane + 1];
  r.dz = d[3 * lane + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  const float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
  r.m0 = adx >= ady && adx >= adz;
  r.m1 = !r.m0 && ady >= adz;
  float pdx, pdy, pdz;
  perm3(r, r.dx, r.dy, r.dz, pdx, pdy, pdz);
  const float inv_dz = 1.0f / pdz;
  r.sx = -pdx * inv_dz;
  r.sy = -pdy * inv_dz;
  r.sz = inv_dz;
  const bool negx = r.ix < 0.0f, negy = r.iy < 0.0f, negz = r.iz < 0.0f;

  float bt = tm;
  int32_t bi = -1;
  int stack[kStackCap];
  int sp = 0;
  int cur = 0;
  int visits = 0, tests = 0;
  while (cur >= 0) {
    ++visits;
    if (kStats && node_seen) node_seen[cur] = 1;
    const float4 a = nodes[2 * cur];
    const float4 b = nodes[2 * cur + 1];
    const int link = __float_as_int(b.z);
    const int meta = __float_as_int(b.w);
    const int nprim = meta >> 2;
    const bool box = slab(r, a, b, bt);
    int nxt;
    if (box && nprim > 0) {
      for (int k = 0; k < nprim; ++k) {
        const float4 *row = tris + 3 * (int64_t)(link + k);
        const float4 p = row[0], q = row[1], s = row[2];
        float t;
        const bool h = watertight(r, p, q, s, kBvhLimit ? CUDART_INF_F : bt,
                                  t);
        if (kStats) {
          ++tests;
          if (tri_seen) tri_seen[link + k] = 1;
        }
        if (h && t < bt) {
          bt = t;
          bi = __float_as_int(s.y);
        }
      }
      nxt = sp > 0 ? stack[--sp] : -1;
    } else if (box) {
      const int axis = meta & 3;
      const bool neg = axis == 0 ? negx : (axis == 1 ? negy : negz);
      const int first = cur + 1;
      if (sp < stack_depth) stack[sp++] = neg ? first : link;
      nxt = neg ? link : first;
    } else {
      nxt = sp > 0 ? stack[--sp] : -1;
    }
    if (kAnyHit && bi >= 0) nxt = -1;
    cur = nxt;
  }
  out_t[lane] = bi >= 0 ? bt : CUDART_INF_F;
  out_i[lane] = bi;
  if (kStats) {
    stats[lane] = visits;
    stats[n + lane] = tests;
  }
}

template <bool kAnyHit, bool kBvhLimit, bool kStats>
void launch(const float4 *nodes, const float4 *tris, const float *o,
            const float *d, const float *t_max, float *out_t,
            int32_t *out_i, int32_t *stats, uint8_t *node_seen,
            uint8_t *tri_seen, int n, int stack_depth, cudaStream_t stream) {
  bvh_walk_kernel<kAnyHit, kBvhLimit, kStats>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          nodes, tris, o, d, t_max, out_t, out_i, stats, node_seen, tri_seen,
          n, stack_depth);
}

template <bool kAnyHit, bool kBvhLimit>
void launch_stats(bool with_stats, const float4 *nodes, const float4 *tris,
                  const float *o, const float *d, const float *t_max,
                  float *out_t, int32_t *out_i, int32_t *stats,
                  uint8_t *node_seen, uint8_t *tri_seen, int n,
                  int stack_depth, cudaStream_t stream) {
  if (with_stats)
    launch<kAnyHit, kBvhLimit, true>(nodes, tris, o, d, t_max, out_t, out_i,
                                     stats, node_seen, tri_seen, n,
                                     stack_depth, stream);
  else
    launch<kAnyHit, kBvhLimit, false>(nodes, tris, o, d, t_max, out_t,
                                      out_i, stats, nullptr, nullptr, n,
                                      stack_depth, stream);
}

}  // namespace

// Launches on ``stream`` (stats may be null: no counts, and no marks;
// node_seen and tri_seen may be null: no marks); returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a stack
// depth outside [1, kStackCap] or n < 1.
extern "C" int bvh_walk_launch(const float *nodes, const float *tris,
                               const float *o, const float *d,
                               const float *t_max, float *out_t,
                               int32_t *out_i, int32_t *stats,
                               uint8_t *node_seen, uint8_t *tri_seen, int n,
                               int stack_depth, int any_hit, int bvh_limit,
                               void *stream) {
  if (stack_depth < 1 || stack_depth > kStackCap || n < 1)
    return (int)cudaErrorInvalidValue;
  const float4 *nd = reinterpret_cast<const float4 *>(nodes);
  const float4 *tr = reinterpret_cast<const float4 *>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = stats != nullptr;
  if (any_hit) {
    if (bvh_limit)
      launch_stats<true, true>(st, nd, tr, o, d, t_max, out_t, out_i, stats,
                               node_seen, tri_seen, n, stack_depth, s);
    else
      launch_stats<true, false>(st, nd, tr, o, d, t_max, out_t, out_i, stats,
                                node_seen, tri_seen, n, stack_depth, s);
  } else {
    if (bvh_limit)
      launch_stats<false, true>(st, nd, tr, o, d, t_max, out_t, out_i, stats,
                                node_seen, tri_seen, n, stack_depth, s);
    else
      launch_stats<false, false>(st, nd, tr, o, d, t_max, out_t, out_i,
                                 stats, node_seen, tri_seen, n, stack_depth,
                                 s);
  }
  return (int)cudaGetLastError();
}
