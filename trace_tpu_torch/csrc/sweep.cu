// Per-ray-block sparse sweep: closest-hit and any-hit ray/triangle
// traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel trace_tpu/ops/sweep_pallas.py::_sweep_kernel
// (f32 panel, certified=False). What it computes is the same; the Mosaic
// layout (8-sublane order/suffix rows, 16-row ray packing, 8-row
// broadcast outputs) is not carried over.
//
// Work: one CTA per block of B rays, one thread per ray. The CTA walks
// its own demand-ordered list of super-clusters (order[b, :], built by
// ops/sweep.py). Each step copies one super's Moller-Trumbore panel,
// 16 rows x GL columns of f32 (32 KB at G=8 clusters x L=64 triangles),
// into shared memory; each thread then tests its ray against all GL
// triangles:
//   det   = -d.n          u*det = m.e2 - d.w      (m = o x d)
//   v*det = -m.e1 - d.q   t*det = o.n - v0.n
// with the sign-folded epilogue of trace_tpu/accel/mxu.py::mt_epilogue,
// keeping a per-lane running minimum t and, among equal t, the lowest
// slot (strict '<' both within a super and across supers, so the
// earliest-visited super wins a tie across supers, as in the TPU kernel).
// The CTA leaves the loop when no live lane can still improve:
// __syncthreads_or(suffix[b, s] < lane_limit), where suffix is the
// suffix-min of the block's entry distances. Any-hit retires a lane at
// its first hit (lane_limit = -inf once best_t <= t_lim).
//
// What bounds it on this card: FP32 ALU work on the dense (ray x
// triangle) tests -- about 40 FP32 operations per pair, every ray
// against every triangle of every super its block enters -- plus
// re-reading panels from L2 (a 1M-triangle panel is ~100 MB, twice the
// 50 MB L2). The design keeps the panel in shared memory so each byte
// loaded from L2/HBM feeds B ray tests, reads it there with broadcast
// loads (all lanes read the same word), and keeps per-lane state in
// registers. Not done yet: double-buffering the next panel (cp.async or
// TMA) behind the tests, and vectorised shared loads.
//
// Rounding: built with --fmad=false, so every product and sum rounds
// separately in the association order of the plain PyTorch version
// (ops/sweep.py::sweep_plain); the two then agree bit for bit.
//
// Layouts (all contiguous):
//   rays   f32 [10, NB*B]: o.xyz, d.xyz, m.xyz, t_lim (t_lim < 0: dead)
//   order  i32 [NB, S]:    super ids, near-first per block
//   suffix f32 [NB, S]:    suffix-min of the ordered entry distances
//   panel  f32 [S, 16, GL]
//   out_t  f32 [NB*B]:     best t, +inf when nothing was found
//   out_i  i32 [NB*B]:     best local slot s*GL + k, -1 when nothing

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__global__ void sweep_kernel(const float *__restrict__ rays,
                             const int32_t *__restrict__ order,
                             const float *__restrict__ suffix,
                             const float *__restrict__ panel,
                             float *__restrict__ out_t,
                             int32_t *__restrict__ out_i, int n_supers,
                             int gl, int any_hit) {
  extern __shared__ float4 smem4[];
  float *sp = reinterpret_cast<float *>(smem4);

  const int b = blockIdx.x;
  const int n_lanes = gridDim.x * blockDim.x;
  const int lane = b * blockDim.x + threadIdx.x;

  const float ox = rays[0 * n_lanes + lane];
  const float oy = rays[1 * n_lanes + lane];
  const float oz = rays[2 * n_lanes + lane];
  const float dx = rays[3 * n_lanes + lane];
  const float dy = rays[4 * n_lanes + lane];
  const float dz = rays[5 * n_lanes + lane];
  const float mx = rays[6 * n_lanes + lane];
  const float my = rays[7 * n_lanes + lane];
  const float mz = rays[8 * n_lanes + lane];
  const float t_lim = rays[9 * n_lanes + lane];

  const int32_t *ord = order + (int64_t)b * n_supers;
  const float *suf = suffix + (int64_t)b * n_supers;
  const int n4 = (16 * gl) / 4;

  float best_t = CUDART_INF_F;
  int32_t best_i = -1;

  for (int s = 0; s < n_supers; ++s) {
    float lane_limit;
    if (any_hit) {
      lane_limit = (best_t <= t_lim) ? -CUDART_INF_F : t_lim;
    } else {
      lane_limit = fminf(best_t, t_lim);
    }
    // Also the barrier that ends every thread's reads of the last panel.
    if (!__syncthreads_or(suf[s] < lane_limit)) break;

    const int sid = ord[s];
    const float4 *src =
        reinterpret_cast<const float4 *>(panel + (int64_t)sid * 16 * gl);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) smem4[j] = src[j];
    __syncthreads();

    const float *n_x = sp + 0 * gl, *n_y = sp + 1 * gl, *n_z = sp + 2 * gl;
    const float *a_x = sp + 3 * gl, *a_y = sp + 4 * gl, *a_z = sp + 5 * gl;
    const float *c_x = sp + 6 * gl, *c_y = sp + 7 * gl, *c_z = sp + 8 * gl;
    const float *w_x = sp + 9 * gl, *w_y = sp + 10 * gl, *w_z = sp + 11 * gl;
    const float *q_x = sp + 12 * gl, *q_y = sp + 13 * gl,
                *q_z = sp + 14 * gl;
    const float *v0n = sp + 15 * gl;

    const float limit = fminf(best_t, t_lim);
    float cur_t = CUDART_INF_F;
    int cur_k = -1;
    for (int k = 0; k < gl; ++k) {
      const float nx = n_x[k], ny = n_y[k], nz = n_z[k];
      const float det = -((dx * nx + dy * ny) + dz * nz);
      const float u_det = ((mx * c_x[k] + my * c_y[k]) + mz * c_z[k]) -
                          ((dx * w_x[k] + dy * w_y[k]) + dz * w_z[k]);
      const float v_det = -((mx * a_x[k] + my * a_y[k]) + mz * a_z[k]) -
                          ((dx * q_x[k] + dy * q_y[k]) + dz * q_z[k]);
      const float t_det = ((ox * nx + oy * ny) + oz * nz) - v0n[k];
      const float sign = det < 0.0f ? -1.0f : 1.0f;
      const float adet = det * sign;
      const float u = u_det * sign;
      const float v = v_det * sign;
      const float tn = t_det * sign;
      const bool live = adet > 1e-12f;
      const float t = tn / (live ? adet : 1.0f);
      const bool ok = live && u >= 0.0f && v >= 0.0f && u + v <= adet &&
                      tn > 0.0f && t < limit;
      if (ok && t < cur_t) {
        cur_t = t;
        cur_k = k;
      }
    }
    if (cur_t < best_t) {
      best_t = cur_t;
      best_i = sid * gl + cur_k;
    }
  }
  out_t[lane] = best_t;
  out_i[lane] = best_i;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int sweep_launch(const float *rays, const int32_t *order,
                            const float *suffix, const float *panel,
                            float *out_t, int32_t *out_i, int n_blocks,
                            int block_rays, int n_supers, int gl,
                            int any_hit, void *stream) {
  const size_t smem = sizeof(float) * 16 * (size_t)gl;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<<<n_blocks, block_rays, smem, (cudaStream_t)stream>>>(
      rays, order, suffix, panel, out_t, out_i, n_supers, gl, any_hit);
  return (int)cudaGetLastError();
}
