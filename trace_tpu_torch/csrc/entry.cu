// The sweep's prologue for NVIDIA Hopper (sm_90a): from a chunk's rays to
// each ray block's demand order and suffix-min over the super-clusters.
//
// prologue_kernel writes, for ray block b (B rays) and the S supers:
//   order[b, :]  the super ids by ascending entry distance, ties by id
//                (the stable argsort of the row), every position a valid id;
//   suffix[b, i] min over j >= i of the entry of super order[b, j], +inf
//                past the last super the block enters.
// The entry of (b, s) is the least slab entry distance over the block's
// live rays into super s's box, +inf where none enters it. The sweep
// (csrc/sweep.cu) walks order[b, :] and stops on suffix[b, :].
//
// What it replaces: the JAX package computes this outside Pallas
// (trace_tpu/ops/sweep_pallas.py::PallasSweepAccelerator._traverse_chunk,
// :527-536: accel/clusters.py::_entry_boxes, where(t < 0, inf), a
// per-block min, jnp.argsort and a reverse associative_scan), where XLA
// fuses the entry table. The port's plain version
// (ops/sweep.py::prologue_plain) runs the same steps in PyTorch.
// entry_kernel below computes the [NB, S] entry table alone; it is kept
// for measurement (ops/sweep.py::prologue_torch: it, then torch.argsort
// and a reverse cummin) and no render path launches it.
//
// Work: one CTA of kThreads threads per ray block.
//   1. The block's origins, reciprocal directions and t_lim go to shared
//      memory, two float4s a ray. A block with no live lane writes order =
//      0..S-1 and suffix = +inf and computes nothing.
//   2. The CTA walks the supers in tiles of kThreads x kPer, kPer supers a
//      thread (their boxes in registers), each thread looping over the
//      block's rays: one pair of 16-byte broadcast loads a ray serves its
//      kPer box tests. The finite entries are compacted by a block-wide
//      prefix count into 64-bit keys (f32 bits of the entry) << 32 | super
//      id: the entry is >= 0, so its bits order as the floats do, and -0.0
//      becomes +0.0 (it equals +0.0 for argsort, but its bits would sort
//      last). Keys are unique, so any correct sort gives the stable order.
//      The ids of the +inf supers go, in ascending order, to the head of
//      the block's suffix row, used as scratch.
//   3. A bitonic network sorts the k keys, padded virtually to a power of
//      two with +inf keys (every compare-exchange puts the smaller key
//      first, so the padding never moves and is never stored). Up to
//      key_cap keys sort in shared memory; a row with more (tens of
//      thousands of supers, or tables packed at group 1) sorts in its row
//      of the global workspace ws [NB, S] instead.
//   4. order[b, :k] are the sorted ids, suffix[b, :k] their entries (the
//      row is ascending, so its suffix-min is itself), then the +inf supers
//      in id order with suffix +inf: a full row, as the sweep's
//      double-buffered arm prefetches order[b, s + 1] whatever the suffix.
//
// Rules of the entry, as accel/clusters.py::entry_boxes and the JAX
// _entry_boxes:
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
// What bounds it on this card: ~30 FP32 instructions per (live ray, box)
// pair -- 0.16 ms for 65536 live rays x 2760 supers at 33.5e12 unfused
// instructions/s -- then ~log2(k)^2 compare-exchanges per key of the
// sort; the bytes (rays, boxes, two [NB, S] outputs, ~46 MB for a full
// chunk) take ~0.014 ms. The design touches device memory only for those
// bytes (the scratch ids are written and read once more, from L2), keeps
// rays and keys in shared memory and the boxes in registers, and sorts
// only the finite entries.
//
// Rounding: built with --fmad=false; every operation is a single rounding
// or exact (min, max, compares), so kernel and plain agree bit for bit.
//
// Layouts (all contiguous):
//   lo, hi  f32 [S, 3]:     super boxes
//   o, d    f32 [NB*B, 3]:  ray origins and directions
//   t_lim   f32 [NB*B]:     t limit (< 0: dead)
//   order   i32 [NB, S], suffix f32 [NB, S]  (prologue_kernel)
//   ws      u64 [NB, S]:    workspace, only when S > key_cap (else null)
//   out     f32 [NB, S]                       (entry_kernel)

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSupers = 128;  // entry_kernel: supers per CTA, one a thread
constexpr int kThreads = 128;  // prologue_kernel: threads per ray block
constexpr int kPer = 2;        // prologue_kernel: supers a thread tests
constexpr int kTile = kThreads * kPer;
// prologue_kernel's static shared memory: warp_count[kPer][kThreads / 32].
constexpr size_t kStaticSmem = sizeof(int) * kPer * (kThreads / 32);

__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float &tn, float &tf) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  tn = fmaxf(tn, nan ? -CUDART_INF_F : fminf(t0, t1));
  tf = fminf(tf, nan ? CUDART_INF_F : fmaxf(t0, t1));
}

// Stages block b's rays as float4 pairs (o.xyz, t_lim), (1/d.xyz, 0).
// Returns whether this thread staged a live lane.
__device__ __forceinline__ bool stage_rays(float4 *ray, const float *o,
                                           const float *d,
                                           const float *t_lim, int b,
                                           int nb) {
  bool live = false;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int64_t lane = (int64_t)b * nb + i;
    const float tl = t_lim[lane];
    ray[2 * i] = make_float4(o[3 * lane], o[3 * lane + 1], o[3 * lane + 2],
                             tl);
    ray[2 * i + 1] =
        make_float4(__frcp_rn(d[3 * lane]), __frcp_rn(d[3 * lane + 1]),
                    __frcp_rn(d[3 * lane + 2]), 0.0f);
    live |= !(tl < 0.0f);
  }
  return live;
}

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ Box load_box(const float *lo, const float *hi,
                                        int s) {
  return Box{lo[3 * s], lo[3 * s + 1], lo[3 * s + 2],
             hi[3 * s], hi[3 * s + 1], hi[3 * s + 2]};
}

// The least entry over the staged block's live rays into each of N boxes:
// one pair of 16-byte shared loads per ray serves the N boxes.
template <int N>
__device__ __forceinline__ void block_entries(const float4 *ray, int nb,
                                              const Box *box, float *best) {
#pragma unroll
  for (int n = 0; n < N; ++n) best[n] = CUDART_INF_F;
  for (int i = 0; i < nb; ++i) {
    const float4 a = ray[2 * i];  // o.xyz, t_lim
    if (a.w < 0.0f) continue;     // dead lane
    const float4 v = ray[2 * i + 1];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      // The first axis starts from (-inf, +inf): max/min with it is exact.
      float tn = -CUDART_INF_F, tf = CUDART_INF_F;
      slab(box[n].lx, box[n].hx, a.x, v.x, tn, tf);
      slab(box[n].ly, box[n].hy, a.y, v.y, tn, tf);
      slab(box[n].lz, box[n].hz, a.z, v.z, tn, tf);
      tf = tf * 1.00000024f;
      if (tn <= tf && tf > 0.0f && tn < a.w)
        best[n] = fminf(best[n], fmaxf(tn, 0.0f));
    }
  }
}

__global__ void entry_kernel(const float *__restrict__ lo,
                             const float *__restrict__ hi,
                             const float *__restrict__ o,
                             const float *__restrict__ d,
                             const float *__restrict__ t_lim,
                             float *__restrict__ out, int n_supers,
                             int block_rays) {
  extern __shared__ float4 ray[];
  const int b = blockIdx.x;
  stage_rays(ray, o, d, t_lim, b, block_rays);
  __syncthreads();
  const int s = blockIdx.y * kSupers + threadIdx.x;
  if (s >= n_supers) return;
  const Box box = load_box(lo, hi, s);
  float e;
  block_entries<1>(ray, block_rays, &box, &e);
  out[(int64_t)b * n_supers + s] = e;
}

// Ascending sort of key[0, k) in place (shared or global memory), by the
// bitonic network whose first step of each merge compares mirror images;
// positions k..p-1 of the padded power of two p hold +inf keys virtually.
// Every thread of the CTA calls it; it ends with a barrier.
__device__ __forceinline__ void sort_keys(unsigned long long *key, int k) {
  int p = 1;
  while (p < k) p <<= 1;
  for (int m = 2; m <= p; m <<= 1) {
    for (int j = m >> 1; j > 0; j >>= 1) {
      for (int x = threadIdx.x; x < (p >> 1); x += blockDim.x) {
        const int lo = ((x & ~(j - 1)) << 1) | (x & (j - 1));  // bit j clear
        const int hi = j == (m >> 1) ? lo ^ (m - 1) : lo | j;
        if (hi < k) {
          const unsigned long long a = key[lo], c = key[hi];
          if (a > c) {
            key[lo] = c;
            key[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    prologue_kernel(const float *__restrict__ lo, const float *__restrict__ hi,
                    const float *__restrict__ o, const float *__restrict__ d,
                    const float *__restrict__ t_lim, int32_t *order,
                    float *suffix, unsigned long long *ws, int n_supers,
                    int block_rays, int key_cap) {
  // The rays [B][2] float4, then [key_cap] keys.
  extern __shared__ float4 ray[];
  unsigned long long *keys =
      reinterpret_cast<unsigned long long *>(ray + 2 * block_rays);
  __shared__ int warp_count[kPer][kThreads / 32];
  const int b = blockIdx.x;
  const int nb = block_rays;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t *ord = order + (int64_t)b * n_supers;
  float *suf = suffix + (int64_t)b * n_supers;
  const bool live = stage_rays(ray, o, d, t_lim, b, nb);
  if (!__syncthreads_or(live)) {  // a dead block enters nothing
    for (int s = tid; s < n_supers; s += kThreads) {
      ord[s] = s;
      suf[s] = CUDART_INF_F;
    }
    return;
  }
  unsigned long long *ws_row = ws + (int64_t)b * n_supers;
  int k = 0;  // finite entries in the tiles walked so far (every thread)
  for (int base = 0; base < n_supers; base += kTile) {
    // Thread tid tests supers base + n * kThreads + tid, n < kPer.
    Box box[kPer];
    float e[kPer];
#pragma unroll
    for (int n = 0; n < kPer; ++n)
      box[n] = load_box(lo, hi, min(base + n * kThreads + tid, n_supers - 1));
    block_entries<kPer>(ray, nb, box, e);
    unsigned ball[kPer];
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const bool fin = base + n * kThreads + tid < n_supers &&
                       e[n] < CUDART_INF_F;
      ball[n] = __ballot_sync(0xffffffffu, fin);
      if (lane == 0) warp_count[n][warp] = __popc(ball[n]);
    }
    __syncthreads();
    // Supers base + n * kThreads + tid come in id order n-major, so the
    // finite ones below s are those of the earlier tiles (k), of the
    // earlier rows m < n, of the earlier warps and of the earlier lanes.
    int below = k;
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      int before = 0, row = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int c = warp_count[n][w];
        before += w < warp ? c : 0;
        row += c;
      }
      const int s = base + n * kThreads + tid;
      const int q = below + before + __popc(ball[n] & ((1u << lane) - 1u));
      if ((ball[n] >> lane) & 1u) {
        unsigned bits = __float_as_uint(e[n]);
        if (bits == 0x80000000u) bits = 0u;  // -0.0 sorts as +0.0
        const unsigned long long key =
            (unsigned long long)bits << 32 | (unsigned)s;
        if (q < key_cap)
          keys[q] = key;
        else
          ws_row[q] = key;
      } else if (s < n_supers) {
        suf[s - q] = __int_as_float(s);  // the (s - q)-th +inf super
      }
      below += row;
    }
    k = below;
    __syncthreads();  // warp_count is rewritten by the next tile
  }
  const unsigned long long *sorted = keys;
  if (k > key_cap) {
    for (int i = tid; i < key_cap; i += kThreads) ws_row[i] = keys[i];
    __syncthreads();
    sort_keys(ws_row, k);
    sorted = ws_row;
  } else {
    sort_keys(keys, k);
  }
  // The +inf supers after the sorted ones, read from the scratch before
  // the suffix row is written.
  for (int r = tid; r < n_supers - k; r += kThreads)
    ord[k + r] = __float_as_int(suf[r]);
  __syncthreads();
  for (int i = tid; i < n_supers; i += kThreads) {
    if (i < k) {
      const unsigned long long key = sorted[i];
      ord[i] = (int32_t)(unsigned)key;
      suf[i] = __uint_as_float((unsigned)(key >> 32));
    } else {
      suf[i] = CUDART_INF_F;
    }
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int prologue_launch(const float *lo, const float *hi,
                               const float *o, const float *d,
                               const float *t_lim, int32_t *order,
                               float *suffix, void *ws, int n_blocks,
                               int block_rays, int n_supers, int key_cap,
                               void *stream) {
  const size_t smem = (size_t)2 * block_rays * sizeof(float4) +
                      (size_t)key_cap * sizeof(unsigned long long);
  // The static warp counts share the 48 KB a launch may take without the
  // attribute (a block of 512 rays with 4096 keys needs exactly 48 KB of
  // dynamic memory, and the launch failed without it).
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prologue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  prologue_kernel<<<n_blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      lo, hi, o, d, t_lim, order, suffix,
      static_cast<unsigned long long *>(ws), n_supers, block_rays, key_cap);
  return (int)cudaGetLastError();
}

// The [NB, S] entry table alone (measurement only); launches on
// ``stream`` and returns cudaGetLastError() of the launch.
extern "C" int entry_launch(const float *lo, const float *hi, const float *o,
                            const float *d, const float *t_lim, float *out,
                            int n_blocks, int block_rays, int n_supers,
                            void *stream) {
  const dim3 grid(n_blocks, (n_supers + kSupers - 1) / kSupers);
  entry_kernel<<<grid, kSupers, 2 * block_rays * sizeof(float4),
                 static_cast<cudaStream_t>(stream)>>>(
      lo, hi, o, d, t_lim, out, n_supers, block_rays);
  return (int)cudaGetLastError();
}
