// Per-ray-block sparse sweep: closest-hit and any-hit ray/triangle
// traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels trace_tpu/ops/sweep_pallas.py::_sweep_kernel
// (every arm: f32, bf16 and hi/lo panels, plain or certified epilogue,
// with or without step counts) and ::_sweep_kernel_pipelined (the
// double-buffered panel copy). What they compute is the same; the Mosaic
// layout (8-sublane order/suffix rows, 16-row ray packing, 8-row
// broadcast outputs) is not carried over.
//
// Work: one CTA per block of B rays, made of kWarps column groups of B
// threads each: thread (w, r) holds ray r of the block and tests it
// against columns [w*GL/kWarps, (w+1)*GL/kWarps) of the staged super.
// The CTA walks its own demand-ordered list of super-clusters (order[b,
// :], built by ops/sweep.py). Each step copies one super's
// Moller-Trumbore panel, 16 rows x GL columns (32 KB of f32 at G=8
// clusters x L=64 triangles; 16 KB as bf16; 32 KB as hi/lo bf16 pairs),
// into shared memory with every thread of the CTA, then each thread tests
// its ray against its column slice:
//   det   = -d.n          u*det = m.e2 - d.w      (m = o x d)
//   v*det = -m.e1 - d.q   t*det = o.n - v0.n
// with the sign-folded epilogue of trace_tpu/accel/mxu.py::mt_epilogue.
// t = tn / |det| is divided out only for a pair that passed every other
// test (the division is the costliest operation, and most pairs miss).
// Each thread keeps the least t of its slice and, among equal t, the
// lowest column (strict '<' in column order). The slices' (t, k) then
// meet in a [kWarps][B] shared scratch, and every thread merges its ray's
// kWarps entries: the least t, and among equal t the lowest group, which
// holds the lower columns -- the plain version's rule, so the result is
// the same bit for bit. Across supers the rule is strict '<' (the
// earliest-visited super wins a tie, as in the TPU kernel). Every group
// holds the merged best t of its ray, so the stop test
// __syncthreads_or(suffix[b, s] < lane_limit) -- suffix is the suffix-min
// of the block's entry distances -- leaves the loop in every group at
// once. Any-hit retires a lane at its first hit (lane_limit = -inf once
// best_t <= t_lim).
//
// Arms (template parameters, one instantiation each):
//   CERT   the certified epilogue (mxu.py::mt_epilogue_certified): every
//          boundary test is widened by err_eps times the abs-dot bounds
//          |d|.|n|, ma.|e2| + |d|.|w|, ma.|e1| + |d|.|q|, |o|.|n| + |v0.n|
//          (ma = abs-cross of |o| and |d|). |o|, |d| and ma are computed
//          once per ray, in registers.
//   KIND   the panel type: f32, bf16 (upcast = bits << 16, exact), or
//          hi/lo (32 rows; f32(hi) + f32(lo), one rounding).
//   STATS  write the number of supers the CTA swept (steps[b]): one count
//          per ray block, not per group.
//   PIPE   double-buffer the panel: while super s is tested, super s+1's
//          panel is already in flight into the other shared slot, by
//          cp.async (16 bytes per thread and instruction, through L2
//          only: .cg). cp.async was chosen over a 1-D cp.async.bulk with
//          an mbarrier because every thread of the CTA is idle at the
//          copy point anyway, the copy is one contiguous 16-32 KB run,
//          and commit/wait groups need no barrier object in shared
//          memory. The order rows are not padded, so the prefetch is
//          guarded (s+1 < S); an empty group keeps the wait count
//          uniform.
//
// kWarps = 16 (ops/sweep.py's SWEEP_WARPS mirrors it).
// scripts/sweep_warps.py builds copies of this file at 4, 8 and 16 and
// times them on the 1M-triangle frames' chunks; 16 was the fastest on an
// H100 (PERF.md). The block is B = 32 rays, so a CTA has 512 threads; at
// 16 warps ptxas gives 72-96 registers a thread, so registers, not the
// 32-64 KB of shared memory, hold an SM to one CTA. A block of 64 rays
// (1024 threads) would need more registers than an SM has: launch()
// refuses any B but 32.
//
// What bounds it on this card: the busiest block's serial steps. The
// work is FP32 ALU tests on the dense (ray x triangle) pairs -- about 40
// FP32 operations per pair (some 90 when certified), every ray against
// every triangle of every super its block enters -- but a launch lasts as
// long as its longest walk, and a block's steps run one after another
// (stage the panel, test, merge), so the time of one step on one CTA is
// what counts. A CTA of one warp took ~110 us a step: it walked 512
// columns alone, with nothing to hide its shared-memory loads or its
// divisions. Splitting the columns over kWarps groups divides that walk,
// keeps several warps per scheduler, and leaves the panel in shared
// memory, read with broadcast loads (all lanes of a warp read the same
// word), so each byte loaded from L2/HBM feeds B ray tests.
//
// Rounding: built with --fmad=false, so every product and sum rounds
// separately in the association order of the plain PyTorch version
// (ops/sweep.py::sweep_plain); the two then agree bit for bit.
//
// Layouts (all contiguous):
//   rays   f32 [10, NB*B]: o.xyz, d.xyz, m.xyz, t_lim (t_lim < 0: dead)
//   order  i32 [NB, S]:    super ids, near-first per block
//   suffix f32 [NB, S]:    suffix-min of the ordered entry distances
//   panel  [S, 16, GL] f32 or bf16, or [S, 32, GL] bf16 (hi rows, then lo)
//   out_t  f32 [NB*B]:     best t, +inf when nothing was found
//   out_i  i32 [NB*B]:     best local slot s*GL + k, -1 when nothing
//   steps  i32 [NB]:       supers swept per block (STATS only)

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kBlockRays = 32;

enum PanelKind { kF32 = 0, kBF16 = 1, kHiLo = 2 };

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Row r, column k of a staged panel, as f32.
template <int KIND>
struct Panel;

template <>
struct Panel<kF32> {
  static constexpr int kRows = 16;
  static constexpr int kElemBytes = 4;
  __device__ __forceinline__ static float at(const void *p, int gl, int r,
                                             int k) {
    return static_cast<const float *>(p)[r * gl + k];
  }
};

template <>
struct Panel<kBF16> {
  static constexpr int kRows = 16;
  static constexpr int kElemBytes = 2;
  __device__ __forceinline__ static float at(const void *p, int gl, int r,
                                             int k) {
    return bf16_to_f32(static_cast<const uint16_t *>(p)[r * gl + k]);
  }
};

template <>
struct Panel<kHiLo> {
  static constexpr int kRows = 32;
  static constexpr int kElemBytes = 2;
  __device__ __forceinline__ static float at(const void *p, int gl, int r,
                                             int k) {
    const uint16_t *h = static_cast<const uint16_t *>(p);
    return bf16_to_f32(h[r * gl + k]) + bf16_to_f32(h[(16 + r) * gl + k]);
  }
};

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int KIND>
__host__ __device__ constexpr int panel_bytes_per_col() {
  return Panel<KIND>::kRows * Panel<KIND>::kElemBytes;
}

template <bool CERT, int KIND, bool STATS, bool PIPE>
__global__ void sweep_kernel(const float *__restrict__ rays,
                             const int32_t *__restrict__ order,
                             const float *__restrict__ suffix,
                             const uint4 *__restrict__ panel,
                             float *__restrict__ out_t,
                             int32_t *__restrict__ out_i,
                             int32_t *__restrict__ out_steps, int n_supers,
                             int gl, int block_rays, int any_hit,
                             float err_eps) {
  using P = Panel<KIND>;
  extern __shared__ uint4 smem[];
  const int n16 = gl * panel_bytes_per_col<KIND>() / 16;  // 16-byte chunks
  // The merge scratch sits after the panel slot(s): [kWarps][B] t, then k.
  float *sc_t = reinterpret_cast<float *>(smem + (PIPE ? 2 : 1) * n16);
  int32_t *sc_k = reinterpret_cast<int32_t *>(sc_t + kWarps * block_rays);

  const int b = blockIdx.x;
  const int w = threadIdx.x / block_rays;  // column group (whole warps)
  const int r = threadIdx.x - w * block_rays;
  const int n_lanes = gridDim.x * block_rays;
  const int lane = b * block_rays + r;
  const int k0 = w * gl / kWarps;
  const int k1 = (w + 1) * gl / kWarps;

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

  // Per-ray factors of the certified error bounds.
  const float oax = fabsf(ox), oay = fabsf(oy), oaz = fabsf(oz);
  const float dax = fabsf(dx), day = fabsf(dy), daz = fabsf(dz);
  const float max_ = oay * daz + oaz * day;
  const float may = oaz * dax + oax * daz;
  const float maz = oax * day + oay * dax;

  const int32_t *ord = order + (int64_t)b * n_supers;
  const float *suf = suffix + (int64_t)b * n_supers;

  // Copy super sid's panel into shared slot ``slot``, four 16-byte loads
  // in flight per thread.
  auto stage = [&](int slot, int sid) {
    const uint4 *src = panel + (int64_t)sid * n16;
    uint4 *dst = smem + slot * n16;
    const int nt = blockDim.x;
    int j = threadIdx.x;
    if (PIPE) {
      for (; j < n16; j += nt) cp_async16(dst + j, src + j);
      cp_async_commit();
    } else {
      for (; j + 3 * nt < n16; j += 4 * nt) {
        const uint4 a0 = src[j], a1 = src[j + nt], a2 = src[j + 2 * nt],
                    a3 = src[j + 3 * nt];
        dst[j] = a0;
        dst[j + nt] = a1;
        dst[j + 2 * nt] = a2;
        dst[j + 3 * nt] = a3;
      }
      for (; j < n16; j += nt) dst[j] = src[j];
    }
  };

  float best_t = CUDART_INF_F;
  int32_t best_i = -1;

  if (PIPE && n_supers > 0) stage(0, ord[0]);
  int s = 0;
  for (; s < n_supers; ++s) {
    float lane_limit;
    if (any_hit) {
      lane_limit = (best_t <= t_lim) ? -CUDART_INF_F : t_lim;
    } else {
      lane_limit = fminf(best_t, t_lim);
    }
    // Also the barrier that ends every thread's reads of the last panel
    // and of the merge scratch (so both may be overwritten below).
    if (!__syncthreads_or(suf[s] < lane_limit)) break;

    const int sid = ord[s];
    if (PIPE) {
      if (s + 1 < n_supers) {
        stage((s + 1) & 1, ord[s + 1]);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();  // this thread's copies of super s have landed
    } else {
      stage(0, sid);
    }
    __syncthreads();
    const void *sp = smem + (PIPE ? (s & 1) * n16 : 0);

    const float limit = fminf(best_t, t_lim);
    float cur_t = CUDART_INF_F;
    int cur_k = -1;
    for (int k = k0; k < k1; ++k) {
#define ROW(r) P::at(sp, gl, r, k)
      const float nx = ROW(0), ny = ROW(1), nz = ROW(2);
      const float e1x = ROW(3), e1y = ROW(4), e1z = ROW(5);
      const float e2x = ROW(6), e2y = ROW(7), e2z = ROW(8);
      const float wx = ROW(9), wy = ROW(10), wz = ROW(11);
      const float qx = ROW(12), qy = ROW(13), qz = ROW(14);
      const float v0n = ROW(15);
#undef ROW
      const float det = -((dx * nx + dy * ny) + dz * nz);
      const float u_det = ((mx * e2x + my * e2y) + mz * e2z) -
                          ((dx * wx + dy * wy) + dz * wz);
      const float v_det = -((mx * e1x + my * e1y) + mz * e1z) -
                          ((dx * qx + dy * qy) + dz * qz);
      const float t_det = ((ox * nx + oy * ny) + oz * nz) - v0n;
      const float sign = det < 0.0f ? -1.0f : 1.0f;
      const float adet = det * sign;
      const float u = u_det * sign;
      const float v = v_det * sign;
      const float tn = t_det * sign;
      bool inside;
      if (CERT) {
        const float err_det =
            err_eps * ((dax * fabsf(nx) + day * fabsf(ny)) + daz * fabsf(nz));
        const float err_u =
            err_eps *
            (((max_ * fabsf(e2x) + may * fabsf(e2y)) + maz * fabsf(e2z)) +
             ((dax * fabsf(wx) + day * fabsf(wy)) + daz * fabsf(wz)));
        const float err_v =
            err_eps *
            (((max_ * fabsf(e1x) + may * fabsf(e1y)) + maz * fabsf(e1z)) +
             ((dax * fabsf(qx) + day * fabsf(qy)) + daz * fabsf(qz)));
        const float err_t =
            err_eps *
            (((oax * fabsf(nx) + oay * fabsf(ny)) + oaz * fabsf(nz)) +
             fabsf(v0n));
        // torch.clamp_min(err_det, 1e-12): NaN stays NaN.
        const float floor_det = err_det < 1e-12f ? 1e-12f : err_det;
        inside = adet > floor_det && u >= -err_u && v >= -err_v &&
                 u + v <= ((adet + err_u) + err_v) + err_det && tn > -err_t;
      } else {
        inside = adet > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= adet &&
                 tn > 0.0f;
      }
      if (inside) {
        const float t = tn / adet;
        if (t < limit && t < cur_t) {
          cur_t = t;
          cur_k = k;
        }
      }
    }
    sc_t[w * block_rays + r] = cur_t;
    sc_k[w * block_rays + r] = cur_k;
    __syncthreads();
    // Least t over the groups; among equal t the lowest group (lower
    // columns): strict '<' in group order.
    float mt = sc_t[r];
    int mk = sc_k[r];
#pragma unroll
    for (int g = 1; g < kWarps; ++g) {
      const float tg = sc_t[g * block_rays + r];
      if (tg < mt) {
        mt = tg;
        mk = sc_k[g * block_rays + r];
      }
    }
    if (mt < best_t) {
      best_t = mt;
      best_i = sid * gl + mk;
    }
  }
  if (PIPE) cp_async_wait<0>();  // the prefetch past the last step
  if (w == 0) {
    out_t[lane] = best_t;
    out_i[lane] = best_i;
  }
  if (STATS && threadIdx.x == 0) out_steps[b] = s;
}

struct Args {
  const float *rays;
  const int32_t *order;
  const float *suffix;
  const uint4 *panel;
  float *out_t;
  int32_t *out_i;
  int32_t *out_steps;
  int n_blocks, block_rays, n_supers, gl, any_hit;
  float err_eps;
  cudaStream_t stream;
};

template <bool CERT, int KIND, bool STATS, bool PIPE>
int launch(const Args &a) {
  auto fn = sweep_kernel<CERT, KIND, STATS, PIPE>;
  if (a.block_rays != kBlockRays) return (int)cudaErrorInvalidValue;
  const int threads = kBlockRays * kWarps;
  const size_t smem =
      (PIPE ? 2 : 1) * (size_t)a.gl * panel_bytes_per_col<KIND>() +
      (size_t)kWarps * a.block_rays * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<a.n_blocks, threads, smem, a.stream>>>(
      a.rays, a.order, a.suffix, a.panel, a.out_t, a.out_i, a.out_steps,
      a.n_supers, a.gl, a.block_rays, a.any_hit, a.err_eps);
  return (int)cudaGetLastError();
}

template <bool CERT, int KIND>
int launch_sp(const Args &a, bool stats, bool pipe) {
  if (stats)
    return pipe ? launch<CERT, KIND, true, true>(a)
                : launch<CERT, KIND, true, false>(a);
  return pipe ? launch<CERT, KIND, false, true>(a)
              : launch<CERT, KIND, false, false>(a);
}

template <bool CERT>
int launch_k(const Args &a, int kind, bool stats, bool pipe) {
  switch (kind) {
    case kF32:
      return launch_sp<CERT, kF32>(a, stats, pipe);
    case kBF16:
      return launch_sp<CERT, kBF16>(a, stats, pipe);
    case kHiLo:
      return launch_sp<CERT, kHiLo>(a, stats, pipe);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue when block_rays is not 32. ``out_steps`` may be null
// (then no step counts are written). panel_kind: 0 f32, 1 bf16, 2 hi/lo.
extern "C" int sweep_launch(const float *rays, const int32_t *order,
                            const float *suffix, const void *panel,
                            float *out_t, int32_t *out_i, int32_t *out_steps,
                            int n_blocks, int block_rays, int n_supers,
                            int gl, int any_hit, int certified,
                            int panel_kind, int pipeline, float err_eps,
                            void *stream) {
  const Args a{rays,       order,   suffix,
               static_cast<const uint4 *>(panel),
               out_t,      out_i,   out_steps,
               n_blocks,   block_rays, n_supers,
               gl,         any_hit, err_eps,
               static_cast<cudaStream_t>(stream)};
  const bool stats = out_steps != nullptr;
  return certified ? launch_k<true>(a, panel_kind, stats, pipeline != 0)
                   : launch_k<false>(a, panel_kind, stats, pipeline != 0);
}
