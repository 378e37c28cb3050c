// The film's gather splat for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package splats a chunk of samples
// with XLA's scatter-add (trace_tpu/film/film.py::Film.add_samples). The
// port's scatter (film/film.py::Film.add_samples through
// core/math.py::scatter_add, PyTorch's deterministic index_put_) sorts a
// chunk's 16 footprint entries a lane and walks each pixel's run of
// duplicates serially; the render loop's padded tail chunk puts ~1M
// zero-weight entries on the few pixels at (0, 0), and the two chunk
// splats took 20.5 ms of the 1M Whitted frame's 53.7 ms on an H100. This
// kernel is the render loop's splat of one chunk on the card
// (Film.add_samples with ``lanes``).
//
// The splat, as Film.add_samples computes it, per lane and film pixel:
//   - d = p_film - 0.5; the footprint p0 = max(ceil(d - r), lo) ..
//     p1 = min(floor(d + r) + 1, hi) on each axis (lo = max(crop_min, 1),
//     hi = crop_max), at most fp entries an axis from p0;
//   - the table offsets off_x = clamp(ceil(|(px - d) / r| * 16), 1, 16) - 1
//     and off_y the same with floor, the weight w = table[off_y][off_x]
//     (Film.filter_table: the filter at the 16 x 16 quantized points, the
//     values add_samples evaluates entry by entry);
//   - xyz += w * lane_xyz and weight_sum += w.
//
// Summation order, the kernel's contract: one thread owns one film pixel
// and adds its lanes one at a time in ascending lane order (grid row, then
// column), starting from the pixel's current sums. A lane gives a pixel at
// most one footprint entry, so this is the order of the CPU's
// deterministic index_put_ (a serial loop in update order), and the card
// gives the same bits every run with no atomics (ROADMAP section C,
// "The scatter's association"). The scatter also adds its zero-weight
// entries (outside a footprint, clamped onto the film's edge); the kernel
// skips them, which changes no bit while the lanes' xyz is finite (the
// render loop's radiance is: integrators/common.py::sanitize_radiance).
//
// Candidate lanes: a sample of grid pixel P lies in [P, P + 1] and touches
// P + delta for delta in the film's stencil (Film.stencil_x / _y); the
// window is that stencil widened by one pixel each way, so a sample that
// rounds past its pixel's edge is still visited. Only lanes in the chunk's
// valid range [start, start + n_valid) are read: the padded tail never is.
//
// What bounds it on this card: launch latency. A 256^2 film and a chunk of
// 65,536 lanes are ~1.3 MB of lanes read and ~2.1 MB of film read and
// written, ~1 us at 3.35 TB/s; the window's 36 candidates a pixel are
// reread from L1/L2, and neighbouring threads (neighbouring pixels of a
// row) read neighbouring lanes.
//
// Rounding: built with --fmad=false; every product and sum in the order of
// the plain version (ops/splat.py::splat_plain), so the two agree bit for
// bit, and with the per-entry arithmetic of Film.add_samples.
//
// Layouts (all contiguous, f32):
//   xyz_in, xyz_out [H, W, 3]; ws_in, ws_out [H, W]; p_film [C, 2] and
//   lane_xyz [C, 3] (the chunk's lanes); table [16, 16] (row off_y)

#include <cuda_runtime.h>
#include <stdint.h>

// ops/splat.py::SplatParams mirrors this layout.
struct SplatParams {
  int height, width;     // film pixels (the crop window)
  int crop_x, crop_y;    // 1-based pixel of film pixel (0, 0)
  int fp_x, fp_y;        // footprint entries an axis
  int grid_x, grid_y;    // 1-based pixel of grid lane 0
  int grid_w;            // grid columns
  int start, n_valid;    // the chunk: grid lanes [start, start + n_valid)
  int win_x0, win_x1;    // candidate lanes: pixel + [win_x0, win_x1] ...
  int win_y0, win_y1;    // ... and rows pixel + [win_y0, win_y1]
  float lo_x, lo_y;      // p0's clamp
  float hi_x, hi_y;      // p1's clamp
  float r_x, r_y;        // the filter radius
  float inv_rx, inv_ry;  // 1 / r in f32
};

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 16;  // film/film.py FILTER_TABLE_WIDTH

__device__ __forceinline__ int table_offset(float f) {
  // clamp(f, 1, 16) - 1 (f >= 0 and finite here)
  return (int)(f < 1.0f ? 1.0f : (f > (float)kTable ? (float)kTable : f)) -
         1;
}

__global__ void __launch_bounds__(kThreads)
    splat_gather_kernel(const float *__restrict__ xyz_in,
                        const float *__restrict__ ws_in,
                        const float *__restrict__ p_film,
                        const float *__restrict__ lane_xyz,
                        const float *__restrict__ table,
                        float *__restrict__ xyz_out,
                        float *__restrict__ ws_out, const SplatParams p) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= p.height * p.width) return;
  const int iy = pix / p.width;
  const int ix = pix - iy * p.width;
  const int px = p.crop_x + ix;
  const int py = p.crop_y + iy;
  const float xf = (float)px;
  const float yf = (float)py;
  float ax = xyz_in[3 * pix];
  float ay = xyz_in[3 * pix + 1];
  float az = xyz_in[3 * pix + 2];
  float aw = ws_in[pix];
  for (int ky = p.win_y0; ky <= p.win_y1; ++ky) {
    const int gy = py + ky - p.grid_y;
    for (int kx = p.win_x0; kx <= p.win_x1; ++kx) {
      const int gx = px + kx - p.grid_x;
      if (gx < 0 || gx >= p.grid_w) continue;
      const long long lane = (long long)gy * p.grid_w + gx - p.start;
      if (lane < 0 || lane >= p.n_valid) continue;
      const float dx = __ldg(p_film + 2 * lane) - 0.5f;
      const float dy = __ldg(p_film + 2 * lane + 1) - 0.5f;
      // The clamps keep a NaN, as torch's clamp_min / clamp_max do; a NaN
      // footprint then fails the test below.
      float p0x = ceilf(dx - p.r_x);
      p0x = p0x < p.lo_x ? p.lo_x : p0x;
      float p0y = ceilf(dy - p.r_y);
      p0y = p0y < p.lo_y ? p.lo_y : p0y;
      float p1x = floorf(dx + p.r_x) + 1.0f;
      p1x = p1x > p.hi_x ? p.hi_x : p1x;
      float p1y = floorf(dy + p.r_y) + 1.0f;
      p1y = p1y > p.hi_y ? p.hi_y : p1y;
      if (!(p0x <= xf && xf <= p1x && xf - p0x < (float)p.fp_x &&
            p0y <= yf && yf <= p1y && yf - p0y < (float)p.fp_y))
        continue;
      const int ox = table_offset(ceilf(fabsf((xf - dx) * p.inv_rx) *
                                        (float)kTable));
      const int oy = table_offset(floorf(fabsf((yf - dy) * p.inv_ry) *
                                         (float)kTable));
      const float w = __ldg(table + oy * kTable + ox);
      ax = ax + w * __ldg(lane_xyz + 3 * lane);
      ay = ay + w * __ldg(lane_xyz + 3 * lane + 1);
      az = az + w * __ldg(lane_xyz + 3 * lane + 2);
      aw = aw + w;
    }
  }
  xyz_out[3 * pix] = ax;
  xyz_out[3 * pix + 1] = ay;
  xyz_out[3 * pix + 2] = az;
  ws_out[pix] = aw;
}

}  // namespace

extern "C" int splat_gather_launch(const float *xyz_in, const float *ws_in,
                                   const float *p_film,
                                   const float *lane_xyz, const float *table,
                                   float *xyz_out, float *ws_out,
                                   const SplatParams *params, void *stream) {
  const SplatParams p = *params;
  const long long n = (long long)p.height * p.width;
  if (n < 1 || n > INT32_MAX / 3 || p.n_valid < 1 || p.grid_w < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  splat_gather_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xyz_in, ws_in, p_film, lane_xyz, table, xyz_out, ws_out, p);
  return (int)cudaGetLastError();
}
