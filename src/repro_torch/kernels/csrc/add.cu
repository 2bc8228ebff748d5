// C = A + B on an (x, y) image, f32 or bf16.
//
// Replaces src/repro/kernels/add/kernel.py: add_pallas (body _add_kernel).
//
// Bound: device memory.  The sum reads two arrays and writes one, with no
// reuse: at 8192x8192 f32 that is 805 MB per call, 0.24 ms at 3.35 TB/s.  So
// the kernel keeps nothing in shared memory and only has to keep loads and
// stores coalesced and enough blocks in flight.
//
// Geometry: one 256-thread block per launch-plan tile of (8*t_x*t_z) rows by
// (128*t_y) columns.  The block walks its t_z row sub-tiles of 8*t_x rows in
// turn, as the Pallas body's fori_loop does.  Its threads form 2 rows of 128
// columns, so each warp moves 32 neighbouring elements per array per step.
// The ragged edge is masked (the reference pads with Pallas edge blocks);
// clamped duplicate blocks rewrite the last tile with identical values.
#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float add_op(float a, float b) { return a + b; }

// bf16 adds in f32 and rounds to nearest even, as PyTorch and XLA do.
__device__ __forceinline__ __nv_bfloat16 add_op(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
add_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
           int x, int y, int bm, int tz, int bn, int nblk_r, int nblk_c) {
  const int r0 = clamped_tile(blockIdx.y, nblk_r) * bm * tz;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int tr = threadIdx.x / kLaneCols;
  const int tc = threadIdx.x % kLaneCols;
  for (int t = 0; t < tz; ++t) {
    for (int r = tr; r < bm; r += kLaneRows) {
      const int row = r0 + t * bm + r;
      if (row >= x) return;
      for (int cc = tc; cc < bn; cc += kLaneCols) {
        const int col = c0 + cc;
        if (col < y) {
          const size_t k = (size_t)row * y + col;
          c[k] = add_op(a[k], b[k]);
        }
      }
    }
  }
}

extern "C" int repro_add_f32(const void* a, const void* b, void* c, int x, int y,
                             int bm, int tz, int bn, int nblk_r, int nblk_c,
                             int grid_r, int grid_c, int device, void* stream) {
  return launch_tiles(add_kernel<float>, grid_r, grid_c, device, stream,
               (const float*)a, (const float*)b, (float*)c, x, y, bm, tz, bn,
               nblk_r, nblk_c);
}

extern "C" int repro_add_bf16(const void* a, const void* b, void* c, int x, int y,
                              int bm, int tz, int bn, int nblk_r, int nblk_c,
                              int grid_r, int grid_c, int device, void* stream) {
  return launch_tiles(add_kernel<__nv_bfloat16>, grid_r, grid_c, device, stream,
               (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
               (__nv_bfloat16*)c, x, y, bm, tz, bn, nblk_r, nblk_c);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int repro_add_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, add_kernel<float>) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}
