// Brute-force fused ray/triangle intersection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel trace_tpu/ops/intersect_pallas.py::_kernel
// (called through intersect_fused): every ray is tested against every
// triangle with the matmul-factored Moller-Trumbore test, and a per-ray
// running (t, id) minimum is kept, so nothing [rays x triangles]-shaped
// ever reaches device memory. The TPU kernel carries triangle ids as f32
// in a constant-1 matmul column; here they are int32 beside the panel.
//
// Work: one CTA per block of RB rays, one thread per ray; the CTA walks
// all triangle blocks of 128, staging each block's constants (16 rows x
// 128 f32 = 8 KB: n, e1, e2, w, q, v0.n; ops/intersect.py::pack_tris)
// and its 128 ids through shared memory; every thread reads them as
// broadcasts. Rules kept from the TPU kernel: the sign-folded epilogue
// (accel/mxu.py::mt_epilogue), strict t < t_max, padding slots (id < 0)
// never hit, within a triangle block the lowest id among equal t, across
// blocks strict '<' (the earlier block wins), and a miss is id -1, t inf.
//
// What bounds it on this card: FP32 ALU work, ~40 operations per (ray,
// triangle) pair over all pairs; the 8 KB block is re-read from L2 by
// every CTA. A simple kernel: no culling, no double buffering.
//
// Rounding: built with --fmad=false, in the association order of the
// plain PyTorch version (ops/intersect.py::intersect_plain); the two agree
// bit for bit.
//
// Layouts (all contiguous):
//   rays  f32 [10, N]:       o.xyz, d.xyz, m.xyz (m = o x d), t_max;
//                            N a multiple of the CTA size
//   tris  f32 [NT, 16, 128]: per triangle block, rows n, e1, e2, w, q, v0.n
//   ids   i32 [NT * 128]:    triangle id per slot, -1 = padding
//   out_t f32 [N], out_i i32 [N]

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTriBlock = 128;

__global__ void intersect_kernel(const float *__restrict__ rays,
                                 const float4 *__restrict__ tris,
                                 const int32_t *__restrict__ ids,
                                 float *__restrict__ out_t,
                                 int32_t *__restrict__ out_i,
                                 int n_tri_blocks) {
  __shared__ float4 sp4[16 * kTriBlock / 4];
  __shared__ int32_t sid[kTriBlock];
  const float *sp = reinterpret_cast<const float *>(sp4);

  const int n_lanes = gridDim.x * blockDim.x;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = rays[0 * n_lanes + lane];
  const float oy = rays[1 * n_lanes + lane];
  const float oz = rays[2 * n_lanes + lane];
  const float dx = rays[3 * n_lanes + lane];
  const float dy = rays[4 * n_lanes + lane];
  const float dz = rays[5 * n_lanes + lane];
  const float mx = rays[6 * n_lanes + lane];
  const float my = rays[7 * n_lanes + lane];
  const float mz = rays[8 * n_lanes + lane];
  const float t_max = rays[9 * n_lanes + lane];

  float best_t = CUDART_INF_F;
  int32_t best_i = -1;
  for (int j = 0; j < n_tri_blocks; ++j) {
    __syncthreads();  // every thread is done with the last block
    const float4 *src = tris + (int64_t)j * (16 * kTriBlock / 4);
    for (int x = threadIdx.x; x < 16 * kTriBlock / 4; x += blockDim.x)
      sp4[x] = src[x];
    for (int x = threadIdx.x; x < kTriBlock; x += blockDim.x)
      sid[x] = ids[(int64_t)j * kTriBlock + x];
    __syncthreads();

    float cur_t = CUDART_INF_F;
    int32_t cur_i = -1;
    for (int k = 0; k < kTriBlock; ++k) {
#define ROW(r) sp[(r) * kTriBlock + k]
      const float nx = ROW(0), ny = ROW(1), nz = ROW(2);
      const float det = -((dx * nx + dy * ny) + dz * nz);
      const float u_det = ((mx * ROW(6) + my * ROW(7)) + mz * ROW(8)) -
                          ((dx * ROW(9) + dy * ROW(10)) + dz * ROW(11));
      const float v_det = -((mx * ROW(3) + my * ROW(4)) + mz * ROW(5)) -
                          ((dx * ROW(12) + dy * ROW(13)) + dz * ROW(14));
      const float t_det = ((ox * nx + oy * ny) + oz * nz) - ROW(15);
#undef ROW
      const float sign = det < 0.0f ? -1.0f : 1.0f;
      const float adet = det * sign;
      const float u = u_det * sign;
      const float v = v_det * sign;
      const float tn = t_det * sign;
      const bool live = adet > 1e-12f;
      const float t = tn / (live ? adet : 1.0f);
      const int32_t id = sid[k];
      const bool ok = live && u >= 0.0f && v >= 0.0f && u + v <= adet &&
                      tn > 0.0f && t < t_max && id >= 0;
      if (ok && (t < cur_t || (t == cur_t && id < cur_i))) {
        cur_t = t;
        cur_i = id;
      }
    }
    if (cur_t < best_t) {
      best_t = cur_t;
      best_i = cur_i;
    }
  }
  out_t[lane] = best_t;
  out_i[lane] = best_i;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int intersect_launch(const float *rays, const float *tris,
                                const int32_t *ids, float *out_t,
                                int32_t *out_i, int n_ray_blocks,
                                int block_rays, int n_tri_blocks,
                                void *stream) {
  intersect_kernel<<<n_ray_blocks, block_rays, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, reinterpret_cast<const float4 *>(tris), ids, out_t, out_i,
      n_tri_blocks);
  return (int)cudaGetLastError();
}
