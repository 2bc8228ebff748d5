// Harris corner response R = det(M) - k * tr(M)^2 on an (x, y) f32 image.  M
// holds the 3x3 box sums of Ix^2, Iy^2 and Ix*Iy, where Ix and Iy are 3x3
// Sobel gradients of the image zero-extended by 2 (so gradients on the ring
// just outside the image count too).  The Sobel masks are cross-correlated as
// the reference's oracle applies them (harris_ref: SOBEL_X and its
// transpose); the Pallas kernel's masks are their negation, which leaves R
// unchanged because the gradients enter only as products.
//
// Replaces src/repro/kernels/harris/kernel.py: harris_pallas (body
// _harris_kernel, helper _shift_conv3).
//
// Bound: device memory.  R reads the image once and writes R once: 537 MB
// at 8192x8192, 0.16 ms at 3.35 TB/s, against about 60 f32 operations a
// pixel (0.06 ms at 67 TFLOP/s).  The stencil's re-reads therefore have to
// come from on-chip memory, not from device memory.
//
// Geometry: the TPU kernel streams full-width row bands through VMEM; a band
// of 8192 columns has no place in shared memory, so this kernel tiles both
// axes by the launch plan, as add does (t_y and w_y become live, which is a
// divergence from the reference).  Inside its tile a block walks 8x128
// output sub-tiles.  For each it stages the (8+4)x(128+4) input window in
// shared memory (zeros outside the image), computes Ix and Iy on the
// (8+2)x(128+2) gradient window, then the box sums and R, 4 outputs per
// thread.  Shared memory is 16,736 bytes per block whatever the config; the
// halo's extra reads (55% over the tile) are served mostly by L2.
#include "common.cuh"

namespace {
constexpr int kSubR = 8;             // output rows of a sub-tile
constexpr int kSubC = kLaneCols;     // output cols of a sub-tile
constexpr int kInR = kSubR + 4;      // staged input window
constexpr int kInC = kSubC + 4;
constexpr int kGrR = kSubR + 2;      // gradient window
constexpr int kGrC = kSubC + 2;
}  // namespace

__global__ void __launch_bounds__(kThreads)
harris_kernel(const float* __restrict__ img, float* __restrict__ out, int x,
              int y, int rows, int bn, int nblk_r, int nblk_c, float k) {
  __shared__ float s_in[kInR][kInC];
  __shared__ float s_gx[kGrR][kGrC];
  __shared__ float s_gy[kGrR][kGrC];

  const int r0 = clamped_tile(blockIdx.y, nblk_r) * rows;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int r_end = min(r0 + rows, x);
  const int c_end = min(c0 + bn, y);
  const int tid = threadIdx.x;

  for (int sr = r0; sr < r_end; sr += kSubR) {
    for (int sc = c0; sc < c_end; sc += kSubC) {
      // input window: image rows [sr-2, sr+10), cols [sc-2, sc+130)
      for (int i = tid; i < kInR * kInC; i += kThreads) {
        const int ir = i / kInC, ic = i % kInC;
        const int gr = sr - 2 + ir, gc = sc - 2 + ic;
        s_in[ir][ic] = (gr >= 0 && gr < x && gc >= 0 && gc < y)
                           ? img[(size_t)gr * y + gc]
                           : 0.0f;
      }
      __syncthreads();
      // gradients centred on image rows [sr-1, sr+9), cols [sc-1, sc+129)
      for (int i = tid; i < kGrR * kGrC; i += kThreads) {
        const int r = i / kGrC, c = i % kGrC;
        const float p00 = s_in[r][c], p01 = s_in[r][c + 1], p02 = s_in[r][c + 2];
        const float p10 = s_in[r + 1][c], p12 = s_in[r + 1][c + 2];
        const float p20 = s_in[r + 2][c], p21 = s_in[r + 2][c + 1], p22 = s_in[r + 2][c + 2];
        s_gx[r][c] = (p02 - p00) + 2.0f * (p12 - p10) + (p22 - p20);
        s_gy[r][c] = (p20 - p00) + 2.0f * (p21 - p01) + (p22 - p02);
      }
      __syncthreads();
      for (int i = tid; i < kSubR * kSubC; i += kThreads) {
        const int r = i / kSubC, c = i % kSubC;
        float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const float gx = s_gx[r + dr][c + dc];
            const float gy = s_gy[r + dr][c + dc];
            sxx += gx * gx;
            syy += gy * gy;
            sxy += gx * gy;
          }
        }
        const int row = sr + r, col = sc + c;
        if (row < r_end && col < c_end) {
          const float det = sxx * syy - sxy * sxy;
          const float tr = sxx + syy;
          out[(size_t)row * y + col] = det - k * tr * tr;
        }
      }
      __syncthreads();
    }
  }
}

extern "C" int repro_harris_f32(const void* img, void* out, int x, int y,
                                int rows, int bn, int nblk_r, int nblk_c,
                                int grid_r, int grid_c, float k, int device,
                                void* stream) {
  return launch_tiles(harris_kernel, grid_r, grid_c, device, stream,
               (const float*)img, (float*)out, x, y, rows, bn, nblk_r, nblk_c, k);
}

extern "C" int repro_harris_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, harris_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}
