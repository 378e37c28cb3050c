// Brute-force fused ray/triangle intersection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel trace_tpu/ops/intersect_pallas.py::_kernel
// (called through intersect_fused): every ray is tested against every
// triangle with the matmul-factored Moller-Trumbore test, and a per-ray
// running (t, id) minimum is kept, so nothing [rays x triangles]-shaped
// ever reaches device memory. The TPU kernel carries triangle ids as f32
// in a constant-1 matmul column; here they are int32 beside the panel.
//
// Rules kept from the TPU kernel: the sign-folded epilogue
// (accel/mxu.py::mt_epilogue), strict t < t_max, padding slots (id < 0)
// never hit, within a triangle block the lowest id among equal t, across
// blocks strict '<' (the earlier block wins), and a miss is id -1, t inf.
//
// What bounds it on this card: FP32 instructions, ~40 per (ray, triangle)
// pair over all pairs (the bytes -- rays, panel, ids, outputs -- are a few
// MB). The design keeps the FP32 pipe busy with that work and little else:
//   - each thread tests kRays rays against four triangles at a time, so a
//     16-byte shared load of one panel row (four triangles' constant)
//     serves 4 x kRays tests: four shared loads per 4 x kRays pairs where
//     a one-ray-a-thread kernel issues sixteen 4-byte loads per pair;
//   - the hot loop only asks whether each of its 4 x kRays pairs passes
//     the sign, barycentric and tn > 0 tests, branch-free and with the
//     sign flips done as bit flips (`passes`); the IEEE division t = tn /
//     adet, the t_max, id and tie tests run, in the plain version's
//     arithmetic, only for the pairs that pass, which `ok` needs anyway, so
//     which pairs hit does not change (one pair in thousands gets there);
//   - triangle blocks are staged with cp.async into two shared buffers,
//     the next block's copy in flight while the current one is tested.
// Work: one CTA of kThreads threads per kThreads * kRays rays; it walks
// all triangle blocks of 128 (16 rows x 128 f32 = 8 KB: n, e1, e2, w, q,
// v0.n, as ops/intersect.py::pack_tris lays them out, plus 128 ids).
//
// Rounding: built with --fmad=false, in the association order of the
// plain PyTorch version (ops/intersect.py::intersect_plain); the two agree
// bit for bit.
//
// Layouts (all contiguous):
//   rays  f32 [10, N]:       o.xyz, d.xyz, m.xyz (m = o x d), t_max;
//                            N a multiple of kThreads * kRays
//   tris  f32 [NT, 16, 128]: per triangle block, rows n, e1, e2, w, q, v0.n
//   ids   i32 [NT * 128]:    triangle id per slot, -1 = padding
//   out_t f32 [N], out_i i32 [N]

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTriBlock = 128;
constexpr int kQuads = kTriBlock / 4;  // float4 columns of a panel row
constexpr int kRays = 2;               // rays per thread
constexpr int kThreads = 64;           // a CTA serves 128 rays
constexpr int kPanel4 = 16 * kQuads;   // float4s of one staged panel

struct Stage {
  float4 p[kPanel4];  // [16 rows][32 quads]: the global layout
  int4 id[kQuads];
};

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void stage(Stage &st, const float4 *tris,
                                      const int4 *ids, int j) {
  const float4 *p = tris + (int64_t)j * kPanel4;
  const int4 *q = ids + (int64_t)j * kQuads;
  for (int x = threadIdx.x; x < kPanel4 + kQuads; x += kThreads) {
    if (x < kPanel4)
      cp_async16(&st.p[x], p + x);
    else
      cp_async16(&st.id[x - kPanel4], q + (x - kPanel4));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float pick(const float4 &v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, t_max;
};

// Whether the pair passes the sign, barycentric and tn > 0 tests of
// mt_epilogue -- everything `ok` needs but t < t_max and the id -- without
// a select or a multiply by the sign: det = -dd exactly, so |det| = |dd|;
// for a live pair (|det| > 1e-12) det < 0 is det's sign bit, and the
// multiplies by sign (+-1, exact) are flips of the sign bit, which the XORs
// below do. v_det = -va - vb equals -(va + vb) but for the sign of a zero,
// which no comparison sees. Not a live pair: false either way.
__device__ __forceinline__ bool passes(const Ray &y, const float4 *p,
                                       int c) {
#define ROW(k) pick(p[k], c)
  const float nx = ROW(0), ny = ROW(1), nz = ROW(2);
  const float dd = (y.dx * nx + y.dy * ny) + y.dz * nz;
  const float u_det = ((y.mx * ROW(6) + y.my * ROW(7)) + y.mz * ROW(8)) -
                      ((y.dx * ROW(9) + y.dy * ROW(10)) + y.dz * ROW(11));
  const float v_sum = ((y.mx * ROW(3) + y.my * ROW(4)) + y.mz * ROW(5)) +
                      ((y.dx * ROW(12) + y.dy * ROW(13)) + y.dz * ROW(14));
  const float t_det = ((y.ox * nx + y.oy * ny) + y.oz * nz) - ROW(15);
#undef ROW
  const unsigned neg = ~__float_as_uint(dd) & 0x80000000u;  // det < 0
  const float u = __uint_as_float(__float_as_uint(u_det) ^ neg);
  const float v = __uint_as_float(__float_as_uint(v_sum) ^ neg ^ 0x80000000u);
  const float tn = __uint_as_float(__float_as_uint(t_det) ^ neg);
  const float adet = fabsf(dd);
  return adet > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= adet &&
         tn > 0.0f;
}

// A pair that passed: the plain version's arithmetic, the division and
// the t_max, id and tie tests; keeps (t, id) in (cur_t, cur_i) if it wins.
__device__ __forceinline__ void keep(const Ray &y, const float *sp, int32_t id,
                                     int k, float &cur_t, int32_t &cur_i) {
#define ROW(x) sp[(x) * kTriBlock + k]
  const float nx = ROW(0), ny = ROW(1), nz = ROW(2);
  const float det = -((y.dx * nx + y.dy * ny) + y.dz * nz);
  const float u_det = ((y.mx * ROW(6) + y.my * ROW(7)) + y.mz * ROW(8)) -
                      ((y.dx * ROW(9) + y.dy * ROW(10)) + y.dz * ROW(11));
  const float v_det = -((y.mx * ROW(3) + y.my * ROW(4)) + y.mz * ROW(5)) -
                      ((y.dx * ROW(12) + y.dy * ROW(13)) + y.dz * ROW(14));
  const float t_det = ((y.ox * nx + y.oy * ny) + y.oz * nz) - ROW(15);
#undef ROW
  const float sign = det < 0.0f ? -1.0f : 1.0f;
  const float adet = det * sign;
  const float u = u_det * sign;
  const float v = v_det * sign;
  const float tn = t_det * sign;
  const float t = __fdiv_rn(tn, adet);
  const bool ok = adet > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= adet &&
                  tn > 0.0f && t < y.t_max && id >= 0;
  if (ok && (t < cur_t || (t == cur_t && id < cur_i))) {
    cur_t = t;
    cur_i = id;
  }
}

__global__ void __launch_bounds__(kThreads)
    intersect_kernel(const float *__restrict__ rays,
                     const float4 *__restrict__ tris,
                     const int4 *__restrict__ ids, float *__restrict__ out_t,
                     int32_t *__restrict__ out_i, int n_tri_blocks) {
  __shared__ Stage st[2];
  const int n_lanes = gridDim.x * kThreads * kRays;
  Ray r[kRays];
  float best_t[kRays], cur_t[kRays];
  int32_t best_i[kRays], cur_i[kRays];
#pragma unroll
  for (int a = 0; a < kRays; ++a) {
    const int lane = blockIdx.x * kThreads * kRays + a * kThreads +
                     threadIdx.x;
    const float *x = rays + lane;
    r[a] = Ray{x[0], x[n_lanes], x[2 * n_lanes], x[3 * n_lanes],
               x[4 * n_lanes], x[5 * n_lanes], x[6 * n_lanes],
               x[7 * n_lanes], x[8 * n_lanes], x[9 * n_lanes]};
    best_t[a] = CUDART_INF_F;
    best_i[a] = -1;
  }
  if (n_tri_blocks > 0) stage(st[0], tris, ids, 0);
  for (int j = 0; j < n_tri_blocks; ++j) {
    if (j + 1 < n_tri_blocks) {
      stage(st[(j + 1) & 1], tris, ids, j + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // block j is in st[j & 1] for every thread
    const Stage &s = st[j & 1];
    const float *sp = reinterpret_cast<const float *>(s.p);
    const int32_t *sid = reinterpret_cast<const int32_t *>(s.id);
#pragma unroll
    for (int a = 0; a < kRays; ++a) {
      cur_t[a] = CUDART_INF_F;
      cur_i[a] = -1;
    }
#pragma unroll 1
    for (int q = 0; q < kQuads; ++q) {
      float4 p[16];
#pragma unroll
      for (int row = 0; row < 16; ++row) p[row] = s.p[row * kQuads + q];
      unsigned pend = 0;  // bit c * kRays + a: pair (triangle 4q + c, ray a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int a = 0; a < kRays; ++a)
          if (passes(r[a], p, c)) pend |= 1u << (c * kRays + a);
      }
      // Rare: the pairs that passed.
      while (pend) {
        const int bit = __ffs(pend) - 1;
        pend &= pend - 1;
        const int k = 4 * q + bit / kRays;
#pragma unroll
        for (int a = 0; a < kRays; ++a)
          if (bit % kRays == a) keep(r[a], sp, sid[k], k, cur_t[a], cur_i[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < kRays; ++a) {
      if (cur_t[a] < best_t[a]) {
        best_t[a] = cur_t[a];
        best_i[a] = cur_i[a];
      }
    }
    __syncthreads();  // st[j & 1] is free for block j + 2
  }
#pragma unroll
  for (int a = 0; a < kRays; ++a) {
    const int lane = blockIdx.x * kThreads * kRays + a * kThreads +
                     threadIdx.x;
    out_t[lane] = best_t[a];
    out_i[lane] = best_i[a];
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a block of rays other than a CTA's.
extern "C" int intersect_launch(const float *rays, const float *tris,
                                const int32_t *ids, float *out_t,
                                int32_t *out_i, int n_ray_blocks,
                                int block_rays, int n_tri_blocks,
                                void *stream) {
  if (block_rays != kThreads * kRays) return (int)cudaErrorInvalidValue;
  intersect_kernel<<<n_ray_blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, reinterpret_cast<const float4 *>(tris),
      reinterpret_cast<const int4 *>(ids), out_t, out_i, n_tri_blocks);
  return (int)cudaGetLastError();
}
