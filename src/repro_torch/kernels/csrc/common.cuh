// Shared by the port's CUDA kernels: the launch-plan arithmetic of
// src/repro_torch/kernels/common.py and the plain C calling convention.
#pragma once
#include <cuda_runtime.h>

// add and mandelbrot run one block of this many threads per launch-plan tile:
// the paper's workgroup cap of 256, laid out as 2 rows of 128 columns (harris
// runs its own count, see harris.cu).
constexpr int kThreads = 256;
constexpr int kLaneCols = 128;
constexpr int kLaneRows = kThreads / kLaneCols;

// Tile index of grid index g under a clamped region split: the reference's
// min(region * steps + local, n_tiles - 1) with region * steps + local == g.
__device__ __forceinline__ int clamped_tile(int g, int n_tiles) {
  return min(g, n_tiles - 1);
}

// Launch one block of kBlock threads per launch-plan tile (col blocks on
// gridDim.x, row blocks on gridDim.y) on the caller's device and stream
// (PyTorch's current stream).  Returns the launch's error code, which the
// Python wrapper checks.
template <int kBlock = kThreads, typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), int grid_r, int grid_c, int device,
                 void* stream, Args... args) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)grid_c, (unsigned)grid_r), kBlock, 0,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
