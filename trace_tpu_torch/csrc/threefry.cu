// The Threefry-2x32 hash for NVIDIA Hopper (sm_90a): every fold_in and
// uniform_lanes of the port on the card.
//
// Replaces no Pallas kernel: it is the counterpart of jax.random's
// threefry2x32, which XLA fuses into one loop for the JAX package
// (trace_tpu/sampler/uniform.py). The port's plain version
// (sampler/uniform.py::threefry2x32) runs the 20 rounds as int64 tensor
// ops masked to 32 bits, since torch has few uint32 ops: ~174 kernels a
// call, each of which writes an int64 temporary of the call's shape. On
// the 1024^2 SPPM camera chunk that is ~180 GB of device traffic an
// iteration; here each thread keeps its words in registers.
//
// The hash, as sampler/uniform.py::threefry2x32 computes it: key words
// (k0, k1), k2 = k0 ^ k1 ^ 0x1BD11BDA; counter words (x0, x1) += (k0, k1);
// five times four rounds x0 += x1, x1 = rotl(x1, r) ^ x0 with r from
// (13, 15, 26, 6) and (17, 29, 16, 24) in turn, each four followed by the
// key injection x0 += ks[(i + 1) % 3], x1 += ks[(i + 2) % 3] + i + 1.
// uint32 arithmetic wraps as the plain version's masks do, so the two
// agree bit for bit on every input (only the keys' and data's low 32 bits
// enter the plain sums too).
//
// Two entry points:
//   - fold (fold_in, lane_keys, fold_lanes, split): out[i] = the hash of
//     the counter (0, data & 0xFFFFFFFF) under key i; a key array of one
//     key or one a lane, data of one value (a launch argument, or one
//     element read on the device: a graph's iteration number) or one a
//     lane, int32 or int64;
//   - uniform (uniform_lanes, uniform, uniform2): out[l, c] =
//     ((y0 ^ y1) >> 9) * 2^-23, (y0, y1) the hash of the counter (0, c)
//     under key l; a thread an element of [N, cols], so one key of a
//     long row (uniform(key, (n, 2)): N = 1) fills the card as N keys do.
//
// What bounds it on this card: a hash is ~80 integer instructions (60
// in the rounds, the rotation one funnel shift; 18 in the schedule and
// the injections), a uniform 4 more. At 64 integer instructions a clock
// an SM (132 SMs, 1.98 GHz: 16.7e12/s) the 1M-lane fold takes ~5 us of
// instructions against 40 MB of keys, data and output (~12 us at 3.35
// TB/s): bytes bound it; the uniform of [1M, 5] is ~26 us of
// instructions against 37 MB (~11 us): instructions bound it. Design:
// a key is one 16-byte load (longlong2), an output key one 16-byte
// store, the rotations funnel shifts; nothing is staged in shared memory,
// as no word is read twice but a key by the threads of one row.
//
// Layouts (all contiguous): keys [K, 2] int64 (words < 2^32, K = 1 or
// the lanes); data [D] int32 or int64 (D = 1 or the lanes); fold out
// [n, 2] int64; uniform out [N, cols] float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Data of a fold: a launch argument, or int32 / int64 elements.
enum DataKind { kScalar = 0, kInt32 = 1, kInt64 = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// The hash of the counter (0, x1) under (k0, k1) -> (y0, y1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;
  x1 += k1;
  TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND

__global__ void __launch_bounds__(kThreads)
    threefry_fold_kernel(const longlong2 *__restrict__ keys, int key_step,
                         const void *__restrict__ data, int data_kind,
                         int data_step, uint32_t scalar,
                         longlong2 *__restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const longlong2 k = keys[key_step ? i : 0];
  const long long j = data_step ? i : 0;
  uint32_t d = scalar;
  if (data_kind == kInt32)
    d = (uint32_t)static_cast<const int *>(data)[j];
  else if (data_kind == kInt64)
    d = (uint32_t)static_cast<const long long *>(data)[j];
  const uint2 y = threefry2x32((uint32_t)k.x, (uint32_t)k.y, d);
  out[i] = make_longlong2((long long)y.x, (long long)y.y);
}

__global__ void __launch_bounds__(kThreads)
    threefry_uniform_kernel(const longlong2 *__restrict__ keys, int one_key,
                            uint32_t cols, float *__restrict__ out,
                            uint32_t total) {
  const unsigned long long e64 =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (e64 >= total) return;
  const uint32_t e = (uint32_t)e64;
  const uint32_t lane = one_key ? 0u : e / cols;
  const uint32_t c = e - lane * cols;
  const longlong2 k = keys[lane];
  const uint2 y = threefry2x32((uint32_t)k.x, (uint32_t)k.y, c);
  // (bits >> 9) < 2^23 converts exactly; the product by 2^-23 is exact.
  out[e] = (float)((y.x ^ y.y) >> 9) * 1.1920928955078125e-7f;
}

}  // namespace

// ops/threefry.py::ThreefryKernel.fold: n output keys; key_step and
// data_step 0 (one, broadcast) or 1 (one a lane); data null with kScalar.
extern "C" int threefry_fold_launch(const void *keys, int key_step,
                                    const void *data, int data_kind,
                                    int data_step, unsigned int scalar,
                                    void *out, long long n, void *stream) {
  if (n < 1 || (n + kThreads - 1) / kThreads > INT32_MAX ||
      data_kind < kScalar || data_kind > kInt64 ||
      (data_kind != kScalar && data == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  threefry_fold_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2 *>(keys), key_step, data, data_kind,
      data_step, scalar, static_cast<longlong2 *>(out), n);
  return (int)cudaGetLastError();
}

// ops/threefry.py::ThreefryKernel.uniform: n_keys rows of cols uniforms,
// n_keys * cols < 2^32.
extern "C" int threefry_uniform_launch(const void *keys, long long n_keys,
                                       long long cols, void *out,
                                       void *stream) {
  const long long total = n_keys * cols;
  if (n_keys < 1 || cols < 1 || total > (long long)UINT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  threefry_uniform_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2 *>(keys), n_keys == 1, (uint32_t)cols,
      static_cast<float *>(out), (uint32_t)total);
  return (int)cudaGetLastError();
}
