// Mandelbrot escape counts on an (x, y) f32 image over the view
// (xmin, ymin) + pixel centre * (dx, dy), up to max_iter trips; an escaped
// pixel (|z|^2 >= 4 at the start of a trip) freezes.
//
// Replaces src/repro/kernels/mandelbrot/kernel.py: mandelbrot_pallas (body
// _mandel_kernel).
//
// Bound: f32 operations.  The kernel reads nothing and writes 4 bytes a pixel
// (268 MB at 8192x8192, 0.08 ms at 3.35 TB/s), while each pixel runs up to 64
// trips of about 10 f32 operations.  A warp leaves the loop once all its
// lanes have escaped, so the work done follows the escape counts.
//
// Geometry as add: one 256-thread block per launch-plan tile, walking its t_z
// row sub-tiles, 2 rows of 128 columns at a time.  c is computed from the
// clamped tile origin plus the thread's offset, as the Pallas kernel computes
// it from the block indices plus iota, in the same order of f32 operations.
// The _rn intrinsics keep the compiler from contracting a multiply and an
// add into one rounding, so every step rounds as the plain version's
// separate tensor operations do.  Lanes past the ragged edge stay in the loop
// as escaped pixels, so the warp vote always sees all 32 lanes.
#include "common.cuh"

__global__ void __launch_bounds__(kThreads)
mandelbrot_kernel(float* __restrict__ out, int x, int y, int bm, int tz, int bn,
                  int nblk_r, int nblk_c, int max_iter, float xmin, float ymin,
                  float dx, float dy) {
  const int r0 = clamped_tile(blockIdx.y, nblk_r) * bm * tz;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int tr = threadIdx.x / kLaneCols;
  const int tc = threadIdx.x % kLaneCols;
  for (int t = 0; t < tz; ++t) {
    for (int r = tr; r < bm; r += kLaneRows) {
      const int row = r0 + t * bm + r;
      if (row >= x) return;  // uniform across the warp: one row per warp
      const float cim = __fadd_rn(ymin, __fmul_rn((float)row + 0.5f, dy));
      for (int cc = tc; cc < bn; cc += kLaneCols) {
        const int col = c0 + cc;
        const bool inside = col < y;
        const float cre = __fadd_rn(xmin, __fmul_rn((float)col + 0.5f, dx));
        float zr = 0.0f, zi = 0.0f, count = 0.0f;
        for (int it = 0; it < max_iter; ++it) {
          const float zr2 = __fmul_rn(zr, zr), zi2 = __fmul_rn(zi, zi);
          const bool alive = inside && __fadd_rn(zr2, zi2) < 4.0f;
          if (__all_sync(0xffffffffu, !alive)) break;
          if (alive) {
            const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cre);
            zi = __fadd_rn(__fmul_rn(2.0f * zr, zi), cim);
            zr = nzr;
            count += 1.0f;
          }
        }
        if (inside) out[(size_t)row * y + col] = count;
      }
    }
  }
}

extern "C" int repro_mandelbrot_f32(void* out, int x, int y, int bm, int tz,
                                    int bn, int nblk_r, int nblk_c, int grid_r,
                                    int grid_c, int max_iter, float xmin,
                                    float ymin, float dx, float dy, int device,
                                    void* stream) {
  return launch_tiles(mandelbrot_kernel, grid_r, grid_c, device, stream,
               (float*)out, x, y, bm, tz, bn, nblk_r, nblk_c, max_iter, xmin,
               ymin, dx, dy);
}

extern "C" int repro_mandelbrot_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, mandelbrot_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}
