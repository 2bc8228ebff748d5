// C = A + B on an (x, y) image, f32 or bf16.
//
// Replaces src/repro/kernels/add/kernel.py: add_pallas (body _add_kernel).
//
// Bound: device memory.  The sum reads two arrays and writes one, with no
// reuse: at 8192x8192 f32 that is 805 MB per call, 0.24 ms at 3.35 TB/s.  To
// come near that rate the card needs several MB of loads in flight at once
// to cover DRAM latency; one 4-byte element per array per thread, with each
// step's loads waiting on the previous step's store, leaves too few.
//
// Design: each thread moves 16 bytes per array per access (a float4, or 8
// bf16 values as one uint4, summed in f32 and rounded to nearest even as
// PyTorch and XLA do), so a 128-column row is 32 lanes in f32 and 16 in bf16.
// Inside its tile a thread issues the loads of up to kUnroll rows (a compile-
// time count) before its first add and store, from one 64-bit offset per
// group of rows.  At the default 8x128 f32 tile the 256 threads of a block
// cover the tile with exactly one vector each, so what matters there is how
// many blocks an SM holds: the launch bound keeps the kernel at 48 registers
// or fewer, 5 blocks of 256 threads per SM.  No shared memory.  Loads and
// stores are plain: streaming hints (__ldcs/__stcs, ld.global.nc with
// L1::no_allocate) measured 1-4 % slower on the H100 (PERF.md).
//
// The vector path needs every row start 16-byte aligned: all three pointers
// aligned and y a multiple of 4 (f32) or 8 (bf16).  The wrapper decides this
// on the host and passes it as `vec`; otherwise the same kernel runs its
// scalar path (one element per access, 128 lanes across a row, one row at a
// time).  Where y is a multiple of the vector width the ragged column edge
// falls on a vector boundary, so the vector path never splits a vector.
//
// Geometry: one 256-thread block per launch-plan tile of (8*t_x*t_z) rows by
// (128*t_y) columns; the t_z row sub-tiles of the Pallas body's fori_loop
// are consecutive rows of that tile, walked in order.  The ragged edge is
// masked (the reference pads with Pallas edge blocks); clamped duplicate
// blocks rewrite the last tile with identical values.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;      // rows whose loads a thread issues before storing
constexpr int kMinBlocks = 5;   // blocks per SM the register budget must allow

template <typename T>
struct Storage;
template <>
struct Storage<float> {
  using Bits = float;    // one element as loaded and stored
  using Pack = float4;   // 16 bytes
};
template <>
struct Storage<__nv_bfloat16> {
  using Bits = unsigned short;
  using Pack = uint4;
};

__device__ __forceinline__ float add_bits(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add_bits(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// bf16 holds the top 16 bits of an f32: widen exactly, add in f32, round to
// nearest even.
__device__ __forceinline__ unsigned short add_bits(unsigned short a, unsigned short b) {
  const float s = __uint_as_float((unsigned)a << 16) + __uint_as_float((unsigned)b << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi = __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint4 add_bits(uint4 a, uint4 b) {
  return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y),
                    add_bf16x2(a.z, b.z), add_bf16x2(a.w, b.w));
}

// Streams rows [r0, r0 + nr) and columns [c0, col_end) of the tile in items
// of type E, each kW elements of T wide.  kL lanes span 128 columns, so a
// pass of the block covers kP rows; a thread takes every kP-th row of its
// column, kRows rows at a time.
template <typename E, int kW, int kRows, typename T>
__device__ __forceinline__ void stream_add(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           T* __restrict__ c, int y, int r0,
                                           int nr, int c0, int col_end, int bn) {
  constexpr int kL = kLaneCols / kW;
  constexpr int kP = kThreads / kL;
  const int tr = threadIdx.x / kL;
  const int tc = threadIdx.x % kL;
  const size_t pass = (size_t)kP * y;  // elements between a thread's rows
  for (int cs = 0; cs < bn; cs += kLaneCols) {
    const int col = c0 + cs + tc * kW;
    if (col >= col_end) break;
    size_t k = (size_t)(r0 + tr) * y + col;
    for (int r = tr; r < nr; r += kRows * kP, k += kRows * pass) {
      E va[kRows], vb[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (r + u * kP < nr) {
          va[u] = *reinterpret_cast<const E*>(a + k + u * pass);
          vb[u] = *reinterpret_cast<const E*>(b + k + u * pass);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (r + u * kP < nr) {
          *reinterpret_cast<E*>(c + k + u * pass) = add_bits(va[u], vb[u]);
        }
      }
    }
  }
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
add_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
           int x, int y, int bm, int tz, int bn, int nblk_r, int nblk_c, int vec) {
  using Bits = typename Storage<T>::Bits;
  using Pack = typename Storage<T>::Pack;
  constexpr int kVec = (int)(sizeof(Pack) / sizeof(T));
  const int rows = bm * tz;
  const int r0 = clamped_tile(blockIdx.y, nblk_r) * rows;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int nr = min(rows, x - r0);
  const int col_end = min(c0 + bn, y);
  const Bits* ab = reinterpret_cast<const Bits*>(a);
  const Bits* bb = reinterpret_cast<const Bits*>(b);
  Bits* cb = reinterpret_cast<Bits*>(c);
  if (vec) {
    stream_add<Pack, kVec, kUnroll>(ab, bb, cb, y, r0, nr, c0, col_end, bn);
  } else {
    stream_add<Bits, 1, 1>(ab, bb, cb, y, r0, nr, c0, col_end, bn);
  }
}

extern "C" int repro_add_f32(const void* a, const void* b, void* c, int x, int y,
                             int bm, int tz, int bn, int nblk_r, int nblk_c,
                             int grid_r, int grid_c, int vec, int device,
                             void* stream) {
  return launch_tiles(add_kernel<float>, grid_r, grid_c, device, stream,
               (const float*)a, (const float*)b, (float*)c, x, y, bm, tz, bn,
               nblk_r, nblk_c, vec);
}

extern "C" int repro_add_bf16(const void* a, const void* b, void* c, int x, int y,
                              int bm, int tz, int bn, int nblk_r, int nblk_c,
                              int grid_r, int grid_c, int vec, int device,
                              void* stream) {
  return launch_tiles(add_kernel<__nv_bfloat16>, grid_r, grid_c, device, stream,
               (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
               (__nv_bfloat16*)c, x, y, bm, tz, bn, nblk_r, nblk_c, vec);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int repro_add_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, add_kernel<float>) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}
