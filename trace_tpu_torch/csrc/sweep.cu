// Per-ray-block sparse sweep: closest-hit and any-hit ray/triangle
// traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels trace_tpu/ops/sweep_pallas.py::_sweep_kernel
// (every arm: f32, bf16 and hi/lo panels, plain or certified epilogue,
// with or without step counts) and ::_sweep_kernel_pipelined (the
// double-buffered panel copy), at every tiling the JAX package uses:
// blocks of 32 to 512 rays, supers of 8 to 64 clusters. What they compute
// is the same; the Mosaic layout (8-sublane order/suffix rows, 16-row ray
// packing, 8-row broadcast outputs) is not carried over.
//
// The semantics, in both kernels below: a block of B rays walks its own
// demand-ordered list of super-clusters (order[b, :], built by
// ops/sweep.py) and tests each ray against every triangle of each super
// it visits with the Moller-Trumbore panel, 16 rows x GL columns (32 KB
// of f32 at G=8 clusters x L=64 triangles, 256 KB at G=64; half as bf16;
// the same as hi/lo bf16 pairs):
//   det   = -d.n          u*det = m.e2 - d.w      (m = o x d)
//   v*det = -m.e1 - d.q   t*det = o.n - v0.n
// with the sign-folded epilogue of trace_tpu/accel/mxu.py::mt_epilogue.
// t = tn / |det| is divided out only for a pair that passed every other
// test (the division is the costliest operation, and most pairs miss).
// Within a super the least t wins and, among equal t, the lowest column;
// across supers strict '<' (the earliest-visited super wins a tie, as in
// the TPU kernel). The block leaves the loop at the first step s where
// no lane's limit exceeds suffix[b, s] (the suffix-min of the block's
// entry distances). Any-hit retires a lane at its first hit (lane_limit
// = -inf once best_t <= t_lim), but the lane keeps its best t while its
// block goes on, so the stop is a block-wide vote.
//
// Arms (template parameters, one instantiation each):
//   CERT   the certified epilogue (mxu.py::mt_epilogue_certified): every
//          boundary test is widened by err_eps times the abs-dot bounds
//          |d|.|n|, ma.|e2| + |d|.|w|, ma.|e1| + |d|.|q|, |o|.|n| + |v0.n|
//          (ma = abs-cross of |o| and |d|). |o|, |d| and ma are computed
//          once per ray, in registers.
//   KIND   the panel type: f32, bf16 (upcast = bits << 16, exact), or
//          hi/lo (32 rows; f32(hi) + f32(lo), one rounding).
//   STATS  write the number of supers the block swept (steps[b]).
//   PIPE   (sweep_kernel) double-buffer the panel by cp.async.
//
// Rounding: built with --fmad=false, so every product and sum rounds
// separately in the association order of the plain PyTorch version
// (ops/sweep.py::sweep_plain); the two agree bit for bit.
//
// Two kernels:
//
// sweep_kernel: B = 32 with a super's whole panel staged at once (GL <=
// kTileCols), the default route. One CTA a block:
// kWarps = 16 column groups of 32 threads, thread (w, r) tests ray r
// against columns [w*GL/16, (w+1)*GL/16) of the staged super; the slices'
// (t, k) meet in a [16][B] shared scratch and merge (least t, then lowest
// group = lowest column). 16 warps were the fastest of 4, 8 and 16 on an
// H100 (scripts/torch_sweep_warps.py, PERF.md); ptxas gives 72-96
// registers a thread, so registers hold an SM to one CTA.
//
// sweep_tiled_kernel: every other block B = 32k (k = 1..16) and any GL
// that is a multiple of 8 -- the JAX package's tilings: blocks of 128
// (from_tables) and 512 rays (PallasSweepAccelerator, attach), group 64
// at leaf 64 (GL = 4096: a 256 KB f32 panel a super, more than a CTA's
// 227 KB of shared memory).
//
//   What bounds it on this card: a launch lasts as long as its busiest
//   block's serial steps (stage the super's tiles, test, merge, vote), and
//   a step's work is B x GL pair tests of ~40 FP32 instructions (~90
//   certified) fed by 16 panel values a pair from shared memory. A
//   one-CTA-a-block design ran a block's whole step on one SM with each
//   thread walking 4-16x the columns of a B = 32 thread, staged each tile
//   synchronously through registers, and read a pair's 16 panel values as
//   16 scalar loads -- 7.5-16.4% of its bound.
//
//   1. One ray block over a cluster of C CTAs (cudaLaunchKernelEx with a
//      cluster dimension): C is the largest power of two that divides k,
//      at most kMaxCluster; each CTA holds B / C of the block's rays, a
//      thread a ray, in kMaxBlockRays / (B / C) column groups (B 128: 4
//      CTAs of 32 rays x 16 groups, the sweep_kernel CTA; B 512: 8 of 64
//      x 8; B 32: one CTA). A block's step runs on C SMs, and a chunk
//      makes C times more CTAs (config 6's chunks of 8192 rays at B 128:
//      256 CTAs, not 64 on 132 SMs).
//   2. The stop vote is cluster-wide every step: each CTA's
//      __syncthreads_or is stored into every CTA's vote slot through
//      distributed shared memory, a cluster barrier follows, and each CTA
//      ORs the C slots (double-buffered by step parity, so a slot is
//      rewritten only after the barrier that follows its reads). Every
//      CTA leaves at the block's step, so any-hit t and steps keep the
//      block's values; rank 0 writes steps[b]. Step 0 needs no exchange
//      (each CTA reads the whole block's t_lim), so a block that enters
//      no super leaves before any barrier, copy or cluster sync.
//   3. Tiles of kTileCols columns ([rows][kTileCols], the last tile
//      ragged) stream through a ring of kStages slots, staged by bulk
//      asynchronous copies (cp.async.bulk, one a panel row: tc x elem
//      bytes, 16-byte aligned since GL % 8 == 0) that complete on the
//      slot's "full" mbarrier with the tile's byte count. Thread 0 starts
//      them kStages - 1 tiles ahead, across super boundaries (the tiles
//      past a block's last step are drained, not tested), so no thread
//      spends registers or a barrier on the copy; a slot is refilled once
//      its readers have arrived on its "empty" mbarrier (after a
//      __syncthreads that ends the CTA's reads). 1-D row copies and not a
//      2-D TMA tensor map: a tensor map's box is at most 256 elements a
//      dimension (a 1024-column row would take four), it needs
//      cuTensorMapEncodeTiled (libcuda) on the host, and each panel row
//      is one contiguous run already. Multicasting each row to the
//      cluster's CTAs (.multicast::cluster, the rows spread over the
//      ranks, a slot refilled once every CTA released it: a tile leaves
//      L2 once a cluster) was built, held bit-equal and measured 3-11%
//      slower on the card (each refill waits for the cluster's slowest
//      CTA, not only the vote; PERF.md), so each CTA copies its own
//      tiles. The PIPE arm
//      and the plain arm are this one code path: the flag is accepted
//      and counted per arm by the wrapper.
//   4. A thread tests kVec adjacent columns an iteration from one vector
//      load a row (float4 of f32, 8 bytes of bf16), 4x fewer shared-memory
//      instructions than a load a value; each dot is folded row by row
//      in sweep_plain's association order, and the columns are taken in
//      ascending order, so the tie rule holds. A group's columns are
//      whole vectors: group w of G takes vectors [w*nv/G, (w+1)*nv/G) of
//      a tile's nv; the merge by (t, column) makes the result independent
//      of the split.
//   A thread keeps its ray's least t over its slices with strict '<' in
//   column order; at each super's end the CTA's groups merge each ray's
//   (t, column): least t, among equal t the lowest column -- the plain
//   version's rule, bit for bit. The constants (kMaxCluster 8, kStages 2,
//   kVec 4, kTileCols 1024) are the fastest of the variants timed on the
//   card (scripts/torch_sweep_tilings.py --kernels; PERF.md section 6).
//
//   ptxas (-Xptxas -v, sm_90a): 78 registers (f32), 69 (bf16), 72 (hi/lo),
//   91-98 certified, no spills; one CTA an SM (512 threads).
//
// launch() refuses any B that is not 32k with 1 <= k <= 16 or GL not a
// multiple of 8, and returns the CUDA error of a refused launch (too much
// shared memory, no cluster that fits): the wrapper raises on it.
//
// Layouts (all contiguous):
//   rays   f32 [10, NB*B]: o.xyz, d.xyz, m.xyz, t_lim (t_lim < 0: dead)
//   order  i32 [NB, S]:    super ids, near-first per block
//   suffix f32 [NB, S]:    suffix-min of the ordered entry distances
//   panel  [S, 16, GL] f32 or bf16, or [S, 32, GL] bf16 (hi rows, then lo)
//   out_t  f32 [NB*B]:     best t, +inf when nothing was found
//   out_i  i32 [NB*B]:     best local slot s*GL + k, -1 when nothing
//   steps  i32 [NB]:       supers swept per block (STATS only)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kBlockRays = 32;   // rays a column group's warp row holds
constexpr int kMaxBlockRays = kWarps * kBlockRays;  // 512
constexpr int kTileCols = 1024;  // panel columns staged at once (tiled)
// The tiled kernel: CTAs a block spans at most, tile slots in the ring,
// adjacent columns a thread tests an iteration.
constexpr int kMaxCluster = 8;
constexpr int kStages = 2;
constexpr int kVec = 4;

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

// -- The tiled kernel ------------------------------------------------------

// The cluster a block of ``block_rays`` rays spans: the largest power of
// two C <= kMaxCluster that divides block_rays / kBlockRays. Each CTA
// holds block_rays / C rays in kMaxBlockRays / (block_rays / C) column
// groups (ops/sweep.py::kernel_cluster mirrors it).
__host__ __device__ constexpr int cluster_of(int block_rays) {
  int c = 1;
  while (2 * c <= kMaxCluster && (block_rays / kBlockRays) % (2 * c) == 0)
    c *= 2;
  return c;
}

template <int KIND>
__host__ __device__ constexpr int slot_bytes() {
  return Panel<KIND>::kRows * kTileCols * Panel<KIND>::kElemBytes;
}

// Dynamic shared memory of a tiled CTA: the ring, the full and empty
// mbarriers, the vote slots [2][kMaxCluster], the merge scratch.
template <int KIND>
size_t tiled_smem(int cta_rays, int n_groups) {
  return (size_t)kStages * slot_bytes<KIND>() + 2 * kStages * 8 +
         2 * kMaxCluster * 4 +
         (size_t)n_groups * cta_rays * (sizeof(float) + sizeof(int32_t));
}

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%1], %0;\n" ::"r"(count),
               "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait for the completion of the phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// This thread's arrival on its own ``bar``, expecting ``bytes`` more.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t *bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %0;\n" ::
                   "r"(bytes),
               "r"(smem_addr(bar))
               : "memory");
}

// This thread's arrival on its own ``bar``.
__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// ``bytes`` from global ``src`` to this CTA's shared ``dst``, completing
// on ``bar``.
__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          uint32_t bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One ray of a block, in registers: o, d, m = o x d, and the per-ray
// factors of the certified error bounds (|o|, |d|, and ma = the
// abs-cross of |o| and |d|; unused, and so not computed, without CERT).
struct Ray {
  float ox, oy, oz, dx, dy, dz, mx, my, mz;
  float oax, oay, oaz, dax, day, daz, max_, may, maz;
};

__device__ __forceinline__ Ray load_ray(const float *rays, int n_lanes,
                                        int lane) {
  Ray r;
  r.ox = rays[0 * n_lanes + lane];
  r.oy = rays[1 * n_lanes + lane];
  r.oz = rays[2 * n_lanes + lane];
  r.dx = rays[3 * n_lanes + lane];
  r.dy = rays[4 * n_lanes + lane];
  r.dz = rays[5 * n_lanes + lane];
  r.mx = rays[6 * n_lanes + lane];
  r.my = rays[7 * n_lanes + lane];
  r.mz = rays[8 * n_lanes + lane];
  r.oax = fabsf(r.ox), r.oay = fabsf(r.oy), r.oaz = fabsf(r.oz);
  r.dax = fabsf(r.dx), r.day = fabsf(r.dy), r.daz = fabsf(r.dz);
  r.max_ = r.oay * r.daz + r.oaz * r.day;
  r.may = r.oaz * r.dax + r.oax * r.daz;
  r.maz = r.oax * r.day + r.oay * r.dax;
  return r;
}

// Columns k..k+V-1 of row q of a staged tile ([rows][kTileCols]), as f32,
// from one vector load a row (two for hi/lo).
template <int V>
__device__ __forceinline__ void load_bits(const uint16_t *p,
                                          uint32_t (&x)[V]) {
  static_assert(V == 1 || V == 2 || V == 4, "kVec is 1, 2 or 4");
  if constexpr (V == 4) {
    const uint2 a = *reinterpret_cast<const uint2 *>(p);
    x[0] = a.x << 16, x[1] = a.x & 0xffff0000u;
    x[2] = a.y << 16, x[3] = a.y & 0xffff0000u;
  } else if constexpr (V == 2) {
    const uint32_t a = *reinterpret_cast<const uint32_t *>(p);
    x[0] = a << 16, x[1] = a & 0xffff0000u;
  } else {
    x[0] = static_cast<uint32_t>(*p) << 16;
  }
}

template <int KIND, int V>
__device__ __forceinline__ void load_row(const uint8_t *slot, int q, int k,
                                         float (&x)[V]) {
  if constexpr (KIND == kF32) {
    const float *p = reinterpret_cast<const float *>(slot) + q * kTileCols + k;
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4 *>(p);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    } else if constexpr (V == 2) {
      const float2 a = *reinterpret_cast<const float2 *>(p);
      x[0] = a.x, x[1] = a.y;
    } else {
      x[0] = p[0];
    }
  } else {
    const uint16_t *p =
        reinterpret_cast<const uint16_t *>(slot) + q * kTileCols + k;
    uint32_t h[V];
    load_bits<V>(p, h);
    if constexpr (KIND == kHiLo) {
      uint32_t l[V];
      load_bits<V>(p + 16 * kTileCols, l);
#pragma unroll
      for (int i = 0; i < V; ++i)
        x[i] = __uint_as_float(h[i]) + __uint_as_float(l[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = __uint_as_float(h[i]);
    }
  }
}

// The ray against columns k..k+V-1 of a staged tile whose first column is
// panel column c0; updates the thread's (cur_t, cur_k) with strict '<' in
// ascending column order. Each dot is folded row by row in sweep_plain's
// order: ((a0 * p0 + a1 * p1) + a2 * p2).
template <bool CERT, int KIND, int V>
__device__ __forceinline__ void test_cols(const Ray &y, const uint8_t *slot,
                                          int k, int c0, float err_eps,
                                          float limit, float &cur_t,
                                          int &cur_k) {
  float det[V], tdt[V], ud[V], vd[V], ed[V], et[V], eu[V], ev[V];
  float a[V], b[V], c[V];
  // n: det = -(d.n), t*det = o.n - v0.n; |d|.|n|, |o|.|n|
  load_row<KIND, V>(slot, 0, k, a);
  load_row<KIND, V>(slot, 1, k, b);
  load_row<KIND, V>(slot, 2, k, c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    det[i] = -((y.dx * a[i] + y.dy * b[i]) + y.dz * c[i]);
    tdt[i] = (y.ox * a[i] + y.oy * b[i]) + y.oz * c[i];
    if (CERT) {
      ed[i] = (y.dax * fabsf(a[i]) + y.day * fabsf(b[i])) +
              y.daz * fabsf(c[i]);
      et[i] = (y.oax * fabsf(a[i]) + y.oay * fabsf(b[i])) +
              y.oaz * fabsf(c[i]);
    }
  }
  // e1: v*det = -(m.e1) - d.q; ma.|e1|
  load_row<KIND, V>(slot, 3, k, a);
  load_row<KIND, V>(slot, 4, k, b);
  load_row<KIND, V>(slot, 5, k, c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    vd[i] = -((y.mx * a[i] + y.my * b[i]) + y.mz * c[i]);
    if (CERT)
      ev[i] = (y.max_ * fabsf(a[i]) + y.may * fabsf(b[i])) +
              y.maz * fabsf(c[i]);
  }
  // e2: u*det = m.e2 - d.w; ma.|e2|
  load_row<KIND, V>(slot, 6, k, a);
  load_row<KIND, V>(slot, 7, k, b);
  load_row<KIND, V>(slot, 8, k, c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ud[i] = (y.mx * a[i] + y.my * b[i]) + y.mz * c[i];
    if (CERT)
      eu[i] = (y.max_ * fabsf(a[i]) + y.may * fabsf(b[i])) +
              y.maz * fabsf(c[i]);
  }
  // w
  load_row<KIND, V>(slot, 9, k, a);
  load_row<KIND, V>(slot, 10, k, b);
  load_row<KIND, V>(slot, 11, k, c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ud[i] = ud[i] - ((y.dx * a[i] + y.dy * b[i]) + y.dz * c[i]);
    if (CERT)
      eu[i] = eu[i] + ((y.dax * fabsf(a[i]) + y.day * fabsf(b[i])) +
                       y.daz * fabsf(c[i]));
  }
  // q
  load_row<KIND, V>(slot, 12, k, a);
  load_row<KIND, V>(slot, 13, k, b);
  load_row<KIND, V>(slot, 14, k, c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    vd[i] = vd[i] - ((y.dx * a[i] + y.dy * b[i]) + y.dz * c[i]);
    if (CERT)
      ev[i] = ev[i] + ((y.dax * fabsf(a[i]) + y.day * fabsf(b[i])) +
                       y.daz * fabsf(c[i]));
  }
  // v0.n
  load_row<KIND, V>(slot, 15, k, a);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    tdt[i] = tdt[i] - a[i];
    if (CERT) et[i] = et[i] + fabsf(a[i]);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float sign = det[i] < 0.0f ? -1.0f : 1.0f;
    const float adet = det[i] * sign;
    const float u = ud[i] * sign;
    const float v = vd[i] * sign;
    const float tn = tdt[i] * sign;
    bool inside;
    if (CERT) {
      const float err_det = err_eps * ed[i];
      const float err_u = err_eps * eu[i];
      const float err_v = err_eps * ev[i];
      const float err_t = err_eps * et[i];
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
        cur_k = c0 + k + i;
      }
    }
  }
}

template <bool CERT, int KIND>
__global__ void __launch_bounds__(kMaxBlockRays, 1)
    sweep_tiled_kernel(const float *__restrict__ rays,
                       const int32_t *__restrict__ order,
                       const float *__restrict__ suffix,
                       const uint8_t *__restrict__ panel,
                       float *__restrict__ out_t, int32_t *__restrict__ out_i,
                       int32_t *__restrict__ out_steps, int n_supers, int gl,
                       int cta_rays, int n_groups, int any_hit,
                       float err_eps) {
  using P = Panel<KIND>;
  constexpr int kRows = P::kRows;
  constexpr int kEB = P::kElemBytes;
  constexpr int kSlot = slot_bytes<KIND>();
  extern __shared__ uint4 smem_raw[];  // 16-byte aligned, as bulk copies need
  uint8_t *smem = reinterpret_cast<uint8_t *>(smem_raw);
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + kStages * kSlot);
  uint64_t *empty = full + kStages;
  uint32_t *votes = reinterpret_cast<uint32_t *>(empty + kStages);
  float *sc_t = reinterpret_cast<float *>(votes + 2 * kMaxCluster);
  int32_t *sc_k = reinterpret_cast<int32_t *>(sc_t + n_groups * cta_rays);

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_cta;
  const int block_rays = cta_rays * n_cta;
  const int w = threadIdx.x / cta_rays;  // column group (whole warps)
  const int r = threadIdx.x - w * cta_rays;
  const int n_lanes = gridDim.x / n_cta * block_rays;
  const int lane = b * block_rays + rank * cta_rays + r;
  const int n_tiles = (gl + kTileCols - 1) / kTileCols;
  const int total = n_supers * n_tiles;
  const float t_lim = rays[9 * n_lanes + lane];

  // Step 0's vote needs no exchange: every lane's limit is still a
  // function of its t_lim alone, and a CTA has at least B threads, so
  // each CTA reads the whole block's t_lim and takes the block's
  // decision. A block that enters nothing leaves here, with no barrier,
  // copy or cluster synchronisation.
  {
    bool enter = false;
    if (n_supers > 0 && threadIdx.x < block_rays) {
      const float tl = rays[9 * n_lanes + b * block_rays + threadIdx.x];
      const float best = CUDART_INF_F;
      const float lim =
          any_hit ? ((best <= tl) ? -CUDART_INF_F : tl) : fminf(best, tl);
      enter = suffix[(int64_t)b * n_supers] < lim;
    }
    if (!__syncthreads_or(enter)) {
      if (w == 0) {
        out_t[lane] = CUDART_INF_F;
        out_i[lane] = -1;
      }
      if (out_steps != nullptr && rank == 0 && threadIdx.x == 0)
        out_steps[b] = 0;
      return;
    }
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_init_fence();
  }
  // The barriers are initialised before any copy or wait, and every CTA
  // of the cluster has started before any stores a vote into it.
  cluster.sync();

  const Ray ray = load_ray(rays, n_lanes, lane);
  const int32_t *ord = order + (int64_t)b * n_supers;
  const float *suf = suffix + (int64_t)b * n_supers;

  // Thread 0: the block's tiles (flat index j = s * n_tiles + tile) up to
  // ``last``, each into slot j % kStages once this CTA has released the
  // slot's previous tile j - kStages, a bulk copy a panel row.
  int started = 0;
  auto copy_upto = [&](int last) {
    for (; started <= last; ++started) {
      const int slot = started % kStages;
      if (started >= kStages)
        mbar_wait(&empty[slot], ((started / kStages) - 1) & 1);
      const int s2 = started / n_tiles;
      const int c0 = (started - s2 * n_tiles) * kTileCols;
      const uint32_t row_bytes = min(kTileCols, gl - c0) * kEB;
      mbar_arrive_expect_tx(&full[slot], kRows * row_bytes);
      const uint8_t *src =
          panel + ((int64_t)ord[s2] * kRows * gl + c0) * kEB;
      uint8_t *dst = smem + slot * kSlot;
      for (int q = 0; q < kRows; ++q)
        bulk_copy(dst + q * kTileCols * kEB, src + (int64_t)q * gl * kEB,
                  row_bytes, &full[slot]);
    }
  };

  float best_t = CUDART_INF_F;
  int32_t best_i = -1;
  int s = 0;
  for (; s < n_supers; ++s) {
    float lane_limit;
    if (any_hit) {
      lane_limit = (best_t <= t_lim) ? -CUDART_INF_F : t_lim;
    } else {
      lane_limit = fminf(best_t, t_lim);
    }
    // Also the barrier that ends every thread's reads of the merge
    // scratch (so it may be overwritten below). Step 0 was voted above.
    int go = s == 0 || __syncthreads_or(suf[s] < lane_limit);
    if (n_cta > 1 && s > 0) {
      uint32_t *slot_votes = votes + (s & 1) * kMaxCluster;
      if (threadIdx.x < n_cta)
        *cluster.map_shared_rank(slot_votes + rank, threadIdx.x) = go;
      __syncwarp();
      cluster.sync();
      go = 0;
      for (int q = 0; q < n_cta; ++q) go |= slot_votes[q];
    }
    if (!go) break;

    const int sid = ord[s];
    const float limit = fminf(best_t, t_lim);
    float cur_t = CUDART_INF_F;
    int cur_k = -1;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int j = s * n_tiles + tile;
      if (threadIdx.x == 0) copy_upto(min(j + kStages - 1, total - 1));
      const int slot = j % kStages;
      mbar_wait(&full[slot], (j / kStages) & 1);
      const uint8_t *sp = smem + slot * kSlot;
      const int c0 = tile * kTileCols;
      const int nv = min(kTileCols, gl - c0) / kVec;
      const int v1 = (w + 1) * nv / n_groups;
      for (int v = w * nv / n_groups; v < v1; ++v)
        test_cols<CERT, KIND, kVec>(ray, sp, v * kVec, c0, err_eps, limit,
                                    cur_t, cur_k);
      __syncthreads();  // every thread of this CTA is done with the slot
      if (threadIdx.x == 0) mbar_arrive(&empty[slot]);
    }
    sc_t[w * cta_rays + r] = cur_t;
    sc_k[w * cta_rays + r] = cur_k;
    __syncthreads();
    // Least t over the groups; among equal t the lowest column (a group's
    // slices interleave with the others' once a super has several tiles).
    float mt = sc_t[r];
    int mk = sc_k[r];
    for (int g = 1; g < n_groups; ++g) {
      const float tg = sc_t[g * cta_rays + r];
      const int kg = sc_k[g * cta_rays + r];
      if (tg < mt || (tg == mt && kg < mk)) {
        mt = tg;
        mk = kg;
      }
    }
    if (mt < best_t) {
      best_t = mt;
      best_i = sid * gl + mk;
    }
  }
  // The tiles started past the block's last step land before this CTA
  // exits.
  if (threadIdx.x == 0)
    for (int j = s * n_tiles; j < started; ++j)
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
  if (w == 0) {
    out_t[lane] = best_t;
    out_i[lane] = best_i;
  }
  if (out_steps != nullptr && rank == 0 && threadIdx.x == 0) out_steps[b] = s;
  // No CTA exits while a peer may still store a vote into it.
  if (n_cta > 1) {
    __syncwarp();
    cluster.sync();
  }
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

int set_smem(const void *fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool CERT, int KIND, bool STATS, bool PIPE>
int launch(const Args &a) {
  auto fn = sweep_kernel<CERT, KIND, STATS, PIPE>;
  const int threads = kBlockRays * kWarps;
  const size_t smem =
      (PIPE ? 2 : 1) * (size_t)a.gl * panel_bytes_per_col<KIND>() +
      (size_t)kWarps * a.block_rays * (sizeof(float) + sizeof(int32_t));
  if (const int e = set_smem((const void *)fn, smem)) return e;
  fn<<<a.n_blocks, threads, smem, a.stream>>>(
      a.rays, a.order, a.suffix, a.panel, a.out_t, a.out_i, a.out_steps,
      a.n_supers, a.gl, a.block_rays, a.any_hit, a.err_eps);
  return (int)cudaGetLastError();
}

template <bool CERT, int KIND>
int launch_tiled(const Args &a) {
  auto fn = sweep_tiled_kernel<CERT, KIND>;
  const int c = cluster_of(a.block_rays);
  const int cta_rays = a.block_rays / c;
  const int n_groups = kMaxBlockRays / cta_rays;
  const size_t smem = tiled_smem<KIND>(cta_rays, n_groups);
  if (const int e = set_smem((const void *)fn, smem)) return e;
  if (c > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void *)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_blocks * c);
  cfg.blockDim = dim3(n_groups * cta_rays);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fn, a.rays, a.order, a.suffix,
      reinterpret_cast<const uint8_t *>(a.panel), a.out_t, a.out_i,
      a.out_steps, a.n_supers, a.gl, cta_rays, n_groups, a.any_hit,
      a.err_eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool CERT, int KIND>
int launch_sp(const Args &a, bool stats, bool pipe) {
  if (a.block_rays != kBlockRays || a.gl > kTileCols)
    return launch_tiled<CERT, KIND>(a);  // one path, with or without PIPE
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

bool served(int block_rays, int gl) {
  return block_rays >= kBlockRays && block_rays <= kMaxBlockRays &&
         block_rays % kBlockRays == 0 && gl > 0 && gl % 8 == 0;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch (or the
// error of a refused cluster launch), or cudaErrorInvalidValue when
// block_rays is not 32k with 1 <= k <= 16 or GL is not a multiple of 8.
// ``out_steps`` may be null (then no step counts are written).
// panel_kind: 0 f32, 1 bf16, 2 hi/lo. B = 32 with GL <= kTileCols takes
// sweep_kernel, everything else sweep_tiled_kernel.
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
  if (!served(block_rays, gl)) return (int)cudaErrorInvalidValue;
  return certified ? launch_k<true>(a, panel_kind, stats, pipeline != 0)
                   : launch_k<false>(a, panel_kind, stats, pipeline != 0);
}

// The tiled kernel's shape for a block of ``block_rays`` rays and a panel
// kind: shape[0..3] = cluster CTAs, rays a CTA, column groups, dynamic
// shared memory bytes a CTA. Returns cudaErrorInvalidValue for a block the
// kernel does not serve.
extern "C" int sweep_tiled_shape(int block_rays, int panel_kind,
                                 int *shape) {
  if (!served(block_rays, 8) || panel_kind < kF32 || panel_kind > kHiLo)
    return (int)cudaErrorInvalidValue;
  const int c = cluster_of(block_rays);
  const int cta_rays = block_rays / c;
  const int n_groups = kMaxBlockRays / cta_rays;
  shape[0] = c;
  shape[1] = cta_rays;
  shape[2] = n_groups;
  shape[3] = (int)(panel_kind == kF32    ? tiled_smem<kF32>(cta_rays, n_groups)
                   : panel_kind == kBF16 ? tiled_smem<kBF16>(cta_rays,
                                                         n_groups)
                                         : tiled_smem<kHiLo>(cta_rays,
                                                             n_groups));
  return 0;
}
