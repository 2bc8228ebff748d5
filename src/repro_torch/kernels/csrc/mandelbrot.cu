// Mandelbrot escape counts on an (x, y) f32 image over the view
// (xmin, ymin) + pixel centre * (dx, dy), up to max_iter trips; an escaped
// pixel (|z|^2 >= 4 at the start of a trip) freezes.
//
// Replaces src/repro/kernels/mandelbrot/kernel.py: mandelbrot_pallas (body
// _mandel_kernel).
//
// Bound: f32 operations.  The kernel reads nothing and writes 4 bytes a pixel
// (268 MB at 8192x8192, 0.08 ms at 3.35 TB/s), while each pixel runs up to 64
// trips of 7 f32 operations (zr*zr, zi*zi, their difference, + cre, 2*zr,
// * zi, + cim) and needs one escape test.  Every operation rounds on its own
// (the _rn intrinsics keep the compiler from contracting a multiply and an
// add), so none issues as half of an FMA and the reachable rate is the card's
// unfused f32 rate, half its FMA-counted peak.  A per-trip escape test adds an
// add, a compare, a warp vote, a branch and loop bookkeeping to every trip,
// and a warp runs until its slowest lane escapes.
//
// Design:
// - Blocked escape test.  A lane saves (zr, zi), runs a block of K trips
//   unrolled with no test, vote or count, then tests !(zr^2 + zi^2 < 4) once,
//   which also catches the inf and NaN an escaped orbit runs into.  A lane
//   that passes adds K to its count.  A lane that failed restores its saved
//   state and replays the block one trip at a time with the per-trip test,
//   which gives its exact count; it is then done.  (The compiler keeps the
//   block's intermediate z and |z|^2 in registers, so the replay re-reads
//   them instead of recomputing them.)  This is exact because escape is
//   permanent over this view: once |z| > 2 and |z| >= |c| (z1 = c, and
//   |c| <= 2.8 here), |z^2 + c| > |z|, so an orbit that tests alive after a
//   block tested alive on every trip inside it.  The first block is
//   kFirstBlock trips and the rest kBlock: about half of the view's pixels
//   escape by trip 3, and a full first block would run them on for nothing.
//   Trips left over after the last whole block run one at a time.  One warp
//   vote per block ends the loop once every lane is done.
// - Compact warp footprint.  A warp covers a 4-row by 8-column patch, not a
//   1x32 strip, so its lanes' escape counts differ less at the set's
//   boundary, and its stores are full 32-byte sectors.  The block's 8 warps
//   form a pass of 8 rows by 32 columns, and the block walks its tile of
//   (8*t_x*t_z) rows by (128*t_y) columns pass by pass, its t_z row
//   sub-tiles in order, as the Pallas body does.
// - Every trip computes what the plain version computes, in the same order
//   of f32 operations and with one rounding each; c is computed from the
//   clamped tile origin plus the thread's offset, as the Pallas kernel
//   computes it from the block indices plus iota.  Lanes past the ragged
//   edge (rows or columns) stay in the loop as done pixels, so every vote
//   sees all 32 lanes; only whole passes past the edge are skipped, which
//   every thread of the block decides alike.
#include "common.cuh"

namespace {

constexpr int kFirstBlock = 4;              // trips before the first escape test
constexpr int kBlock = 8;                   // trips between later escape tests
constexpr int kPatchRows = 4;               // a warp's patch
constexpr int kPatchCols = 32 / kPatchRows;
constexpr int kWarpCols = 4;                // warps across a pass
constexpr int kPassRows = kPatchRows * (kThreads / 32 / kWarpCols);
constexpr int kPassCols = kPatchCols * kWarpCols;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kPassRows == 8 && kPassCols == 32, "a pass must divide every tile");

// One trip of z <- z^2 + c, as mandelbrot_ref computes it.
__device__ __forceinline__ void trip(float& zr, float& zi, float zr2, float zi2,
                                     float cre, float cim) {
  const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cre);
  zi = __fadd_rn(__fmul_rn(2.0f * zr, zi), cim);
  zr = nzr;
}

__device__ __forceinline__ bool below_four(float zr2, float zi2) {
  return __fadd_rn(zr2, zi2) < 4.0f;
}

// One block of K trips of the lane's orbit, then its escape test; a lane
// that escaped inside the block replays it from the saved state for its
// exact count and is done.  Lanes already done run along and change nothing
// that is read again.
template <int K>
__device__ __forceinline__ void run_block(float& zr, float& zi, int& count,
                                          bool& done, float cre, float cim) {
  const float sr = zr, si = zi;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    trip(zr, zi, __fmul_rn(zr, zr), __fmul_rn(zi, zi), cre, cim);
  }
  if (done) return;
  if (below_four(__fmul_rn(zr, zr), __fmul_rn(zi, zi))) {
    count += K;
    return;
  }
  zr = sr;
  zi = si;
  for (int k = 0; k < K; ++k) {
    const float zr2 = __fmul_rn(zr, zr), zi2 = __fmul_rn(zi, zi);
    if (!below_four(zr2, zi2)) break;
    trip(zr, zi, zr2, zi2, cre, cim);
    ++count;
  }
  done = true;
}

// Escape count of c = (cre, cim); a lane with done set on entry runs along
// for the votes and returns 0.
__device__ __forceinline__ int escape_count(float cre, float cim, int max_iter,
                                            bool done) {
  float zr = 0.0f, zi = 0.0f;
  int count = 0;
  int it = 0;
  if (kFirstBlock <= max_iter) {
    if (__all_sync(kFullWarp, done)) return count;
    run_block<kFirstBlock>(zr, zi, count, done, cre, cim);
    it = kFirstBlock;
  }
  for (; it + kBlock <= max_iter; it += kBlock) {
    if (__all_sync(kFullWarp, done)) return count;
    run_block<kBlock>(zr, zi, count, done, cre, cim);
  }
  for (; it < max_iter; ++it) {
    if (__all_sync(kFullWarp, done)) break;
    if (!done) {
      const float zr2 = __fmul_rn(zr, zr), zi2 = __fmul_rn(zi, zi);
      if (below_four(zr2, zi2)) {
        trip(zr, zi, zr2, zi2, cre, cim);
        ++count;
      } else {
        done = true;
      }
    }
  }
  return count;
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
mandelbrot_kernel(float* __restrict__ out, int x, int y, int bm, int tz, int bn,
                  int nblk_r, int nblk_c, int max_iter, float xmin, float ymin,
                  float dx, float dy) {
  const int r0 = clamped_tile(blockIdx.y, nblk_r) * bm * tz;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int pr = (warp / kWarpCols) * kPatchRows + lane / kPatchCols;
  const int pc = (warp % kWarpCols) * kPatchCols + lane % kPatchCols;
  for (int t = 0; t < tz; ++t) {
    for (int rr = 0; rr < bm; rr += kPassRows) {
      const int row0 = r0 + t * bm + rr;
      if (row0 >= x) return;  // the whole pass, alike in every thread
      const int row = row0 + pr;
      const float cim = __fadd_rn(ymin, __fmul_rn((float)row + 0.5f, dy));
      for (int cc = 0; cc < bn && c0 + cc < y; cc += kPassCols) {
        const int col = c0 + cc + pc;
        const bool inside = row < x && col < y;
        const float cre = __fadd_rn(xmin, __fmul_rn((float)col + 0.5f, dx));
        const int count = escape_count(cre, cim, max_iter, !inside);
        if (inside) out[(size_t)row * y + col] = (float)count;
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
