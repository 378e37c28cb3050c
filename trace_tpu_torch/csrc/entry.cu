// Block entry distances: the sweep's prologue for NVIDIA Hopper (sm_90a).
//
// Computes entry_b[b, s], the least slab entry distance over the B rays
// of ray block b into the box of super-cluster s, +inf where no live ray
// of the block enters it. The sweep (csrc/sweep.cu) walks each block's
// supers in the order of this row and stops on its suffix-min.
//
// What it replaces: the JAX package computes this outside Pallas
// (trace_tpu/ops/sweep_pallas.py::PallasSweepAccelerator._traverse_chunk:
// accel/clusters.py::_entry_boxes, where(t < 0, inf), then a per-block
// min), where XLA fuses it into one pass. Eager PyTorch instead builds an
// [N, S] table (724 MB at 65536 rays x 2760 supers) and several
// temporaries of its size; the plain version
// (ops/sweep.py::block_entry_plain) still does. This kernel writes only
// the [NB, S] result.
//
// Work: one CTA per (ray block, range of kSupers supers). The block's
// origins, reciprocal directions and t_lim go to shared memory; each
// thread loads one super's box and loops over the block's rays, reading
// them as broadcasts, and keeps the least entry.
//
// Rules, as accel/clusters.py::entry_boxes and the JAX _entry_boxes:
//   - 1/d is the correctly rounded reciprocal (__frcp_rn), as torch's and
//     XLA's 1.0 / d;
//   - per axis, t0 = (lo - o) * inv_d and t1 = (hi - o) * inv_d; near =
//     min(t0, t1) and far = max(t0, t1) are NaN when either is NaN (0 *
//     inf at a slab plane), as torch.minimum/maximum propagate NaN, and
//     NaN then counts as an open slab (near -inf, far +inf) -- fminf and
//     fmaxf alone would return the number instead;
//   - the far plane is widened by 1.00000024f (= 1 + 2 ulp, the f32 that
//     the reference's constant rounds to), one rounded product;
//   - a hit needs tn <= tf, tf > 0 and tn < t_lim; the entry is
//     max(tn, 0), else +inf; dead lanes (t_lim < 0) give +inf.
//
// What bounds it on this card: ~30 FP32 operations per (ray, box) pair,
// about 0.08 ms for 65536 rays x 2760 supers at the FP32 peak; the bytes
// (rays, boxes and the [NB, S] output, ~23 MB) take less. The design
// touches device memory only for those bytes, keeps the rays in shared
// memory and the boxes in registers.
//
// Rounding: built with --fmad=false; every operation is a single rounding
// or exact (min, max, compares), so kernel and plain agree bit for bit.
//
// Layouts (all contiguous):
//   lo, hi  f32 [S, 3]:     super boxes
//   o, d    f32 [NB*B, 3]:  ray origins and directions
//   t_lim   f32 [NB*B]:     t limit (< 0: dead)
//   out     f32 [NB, S]

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSupers = 128;  // supers per CTA, one thread each

__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float &tn, float &tf) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  tn = fmaxf(tn, nan ? -CUDART_INF_F : fminf(t0, t1));
  tf = fminf(tf, nan ? CUDART_INF_F : fmaxf(t0, t1));
}

__global__ void entry_kernel(const float *__restrict__ lo,
                             const float *__restrict__ hi,
                             const float *__restrict__ o,
                             const float *__restrict__ d,
                             const float *__restrict__ t_lim,
                             float *__restrict__ out, int n_supers,
                             int block_rays) {
  extern __shared__ float ray[];  // [7][B]: o.xyz, 1/d.xyz, t_lim
  const int b = blockIdx.x;
  const int nb = block_rays;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int64_t lane = (int64_t)b * nb + i;
    for (int a = 0; a < 3; ++a) {
      ray[a * nb + i] = o[3 * lane + a];
      ray[(3 + a) * nb + i] = __frcp_rn(d[3 * lane + a]);
    }
    ray[6 * nb + i] = t_lim[lane];
  }
  __syncthreads();
  const int s = blockIdx.y * kSupers + threadIdx.x;
  if (s >= n_supers) return;
  const float lx = lo[3 * s], ly = lo[3 * s + 1], lz = lo[3 * s + 2];
  const float hx = hi[3 * s], hy = hi[3 * s + 1], hz = hi[3 * s + 2];
  float best = CUDART_INF_F;
  for (int i = 0; i < nb; ++i) {
    const float tl = ray[6 * nb + i];
    if (tl < 0.0f) continue;  // dead lane
    // The first axis starts from (-inf, +inf): max/min with it is exact.
    float tn = -CUDART_INF_F, tf = CUDART_INF_F;
    slab(lx, hx, ray[i], ray[3 * nb + i], tn, tf);
    slab(ly, hy, ray[nb + i], ray[4 * nb + i], tn, tf);
    slab(lz, hz, ray[2 * nb + i], ray[5 * nb + i], tn, tf);
    tf = tf * 1.00000024f;
    if (tn <= tf && tf > 0.0f && tn < tl) best = fminf(best, fmaxf(tn, 0.0f));
  }
  out[(int64_t)b * n_supers + s] = best;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int entry_launch(const float *lo, const float *hi, const float *o,
                            const float *d, const float *t_lim, float *out,
                            int n_blocks, int block_rays, int n_supers,
                            void *stream) {
  const dim3 grid(n_blocks, (n_supers + kSupers - 1) / kSupers);
  entry_kernel<<<grid, kSupers, 7 * block_rays * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
      lo, hi, o, d, t_lim, out, n_supers, block_rays);
  return (int)cudaGetLastError();
}
