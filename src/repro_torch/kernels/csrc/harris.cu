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
// pixel (0.06 ms at 67 TFLOP/s).  So the stencil's re-reads have to come from
// on-chip memory, and the instructions a pixel issues have to stay well
// under what the card issues in that time.  The first design staged a window
// in shared memory and read it back about 32 times per output (a 3x3 gather
// for each gradient, a 3x3 box gather of two gradient arrays), with a
// division and a modulo per staged element and three barriers per 8x128
// sub-tile: its shared-memory instructions alone took longer than the bytes.
//
// Design: separable passes over rolling windows in registers.
// - Sobel and box are separable.  Across a staged row p: d(c) = p(c+1) -
//   p(c-1) and s(c) = p(c-1) + 2 p(c) + p(c+1).  Down the rows: Ix(r) =
//   d(r-1) + 2 d(r) + d(r+1) and Iy(r) = s(r+1) - s(r-1).  The box is a
//   3-sum across the products' row, then a 3-sum down.
// - A block of 64 threads (kHarrisThreads, the same for every config) walks
//   one 128-column strip of its tile at a time, each thread owning kOwn = 2
//   adjacent output columns.  It walks down the tile's rows plus the 2-row
//   halo above and below, one input row a step, and carries in registers the
//   last two rows of d and s (at its 4 columns c-1 .. c+2) and of the three
//   products' row sums (at its 2 columns).  Per step a thread reads its 6
//   input values (c-2 .. c+3) from shared memory as three 8-byte loads, 1.5
//   per output for each input row: 2.25 per output at the default 8-row
//   tile with its 4 halo rows, and no shared-memory stores.  A taller tile
//   (t_x * t_z > 1) walks further, so its halo costs less per output.  Why
//   64 threads and 2 columns: 256 threads would have to split an 8-row tile's
//   rows and walk the halo once per split; 4 columns a thread (32 threads)
//   needs 156 registers and ran slower (PERF.md).  At 96 registers an SM
//   holds 10 blocks, each with its own 12 staged rows in flight at the
//   default tile.
// - Staging: the block copies each input row of the strip, columns c0-4 ..
//   c0+131, into a ring of kRing groups of kGroup rows in shared memory with
//   cp.async (global to shared with no registers in between; src-size 0
//   fills the zeros outside the image), kRing-1 groups ahead of the rows it
//   computes, one barrier per group.  At the default 8x128 tile all 12 input
//   rows are in flight at once.  Where every row of the image starts 16-byte
//   aligned (y a multiple of 4 and aligned pointers; the kernel checks this
//   itself, block-uniformly), the copies move 16 bytes each and a strip's
//   row is 34 of them; elsewhere they move 4 bytes each.  Chosen over TMA,
//   which needs a tensor map made on the host at every call and a second
//   path anyway for row strides that are not a multiple of 16 bytes.
// - A block whose staged window and outputs lie inside the image tests no
//   bounds at all; only edge blocks test each copy and each store.
// - Shared memory is kRing * kGroup * 136 floats, 8,704 bytes per block for
//   every config (harris/ops.py SMEM_BYTES).
//
// Geometry: one block per launch-plan tile of (8*t_x*t_z) rows by (128*t_y)
// columns, as add does (the TPU kernel streams full-width row bands, so t_y
// and w_y are live here and dead there: a divergence from the reference).
// Clamped duplicate blocks rewrite the last tile with identical values.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kStrip = kLaneCols;               // output columns a strip
constexpr int kOwn = 2;                         // output columns a thread owns
constexpr int kHarrisThreads = kStrip / kOwn;   // threads of a block
constexpr int kIn = kOwn + 2;                   // columns of d, s and gradients
constexpr int kGroup = 4;                       // input rows staged together
constexpr int kRing = 4;                        // staged groups
constexpr int kPad = 4;                         // staged columns each side
constexpr int kRowW = kStrip + 2 * kPad;        // floats a staged row
constexpr int kRowChunks = kRowW / 4;           // 16-byte copies a row
constexpr int kChunks = kGroup * kRowChunks;    // 16-byte copies a group
constexpr int kSlots = (kChunks + kHarrisThreads - 1) / kHarrisThreads;
static_assert(kOwn % 2 == 0 && kStrip % kOwn == 0, "threads own pairs of columns");
static_assert(kGroup == 4, "the walk's first group is its 4 warm-up rows");

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy 16 (4) bytes from global to shared memory; with n == 0 it reads
// nothing and writes zeros.  The 16-byte copies ask L2 to fetch the 256
// bytes around them (PERF.md: 1.5 % faster at the default tile).
__device__ __forceinline__ void copy16(float* dst, const float* src, int n) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// What a thread carries down the rows; its output columns are c .. c+kOwn-1.
struct Window {
  float d[2][kIn], s[2][kIn];   // last two input rows, columns c-1 .. c+kOwn
  float h[2][3][kOwn];          // last two gradient rows' row sums of Ix^2,
                                // Iy^2, Ix*Iy
};

// d and s of one staged row at columns c-1 .. c+kOwn of thread t.
__device__ __forceinline__ void across(const float* row, int t, float (&d)[kIn],
                                       float (&s)[kIn]) {
  float p[kIn + 2];   // columns c-2 .. c+kOwn+1, 8 bytes a load
#pragma unroll
  for (int m = 0; m < kIn / 2 + 1; ++m) {
    const float2 v = *reinterpret_cast<const float2*>(row + kOwn * t + 2 + 2 * m);
    p[2 * m] = v.x;
    p[2 * m + 1] = v.y;
  }
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    d[j] = p[j + 2] - p[j];
    s[j] = fmaf(2.0f, p[j + 1], p[j] + p[j + 2]);
  }
}

// The 3-sums at columns c .. c+kOwn-1 of values at c-1 .. c+kOwn; each pair
// of columns shares its middle pair.
__device__ __forceinline__ void box_across(const float (&a)[kIn], float (&h)[kOwn]) {
#pragma unroll
  for (int j = 0; j < kOwn; j += 2) {
    const float u = a[j + 1] + a[j + 2];
    h[j] = a[j] + u;
    h[j + 1] = u + a[j + 3];
  }
}

// The gradient row above the newest input row (d, s): its products' row sums.
__device__ __forceinline__ void gradient(const Window& w, const float (&d)[kIn],
                                         const float (&s)[kIn], float (&h)[3][kOwn]) {
  float xx[kIn], yy[kIn], xy[kIn];
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    const float gx = fmaf(2.0f, w.d[1][j], w.d[0][j] + d[j]);
    const float gy = s[j] - w.s[0][j];
    xx[j] = gx * gx;
    yy[j] = gy * gy;
    xy[j] = gx * gy;
  }
  box_across(xx, h[0]);
  box_across(yy, h[1]);
  box_across(xy, h[2]);
}

__device__ __forceinline__ void push_input(Window& w, const float (&d)[kIn],
                                           const float (&s)[kIn]) {
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    w.d[0][j] = w.d[1][j];
    w.d[1][j] = d[j];
    w.s[0][j] = w.s[1][j];
    w.s[1][j] = s[j];
  }
}

__device__ __forceinline__ void push_gradient(Window& w, const float (&h)[3][kOwn]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      w.h[0][q][j] = w.h[1][q][j];
      w.h[1][q][j] = h[q][j];
    }
  }
}

// Walk one tile, strip by strip.  kInside: every staged element and every
// output lies inside the image, so nothing is tested.
template <bool kInside>
__device__ __forceinline__ void walk_tile(const float* __restrict__ img, float* __restrict__ out,
                                          int x, int y, int r0, int r_end, int c0, int c_end,
                                          float k, bool vec, float (*ring)[kGroup][kRowW]) {
  const int n_groups = (r_end - r0 + 4 + kGroup - 1) / kGroup;
  const int t = threadIdx.x;

  // this thread's 16-byte copies of a group: staged row, column offset
  int slot_row[kSlots], slot_col[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int e = t + i * kHarrisThreads;
    slot_row[i] = e / kRowChunks;
    slot_col[i] = 4 * (e % kRowChunks);
  }

  for (int cs = c0; cs < c_end; cs += kStrip) {
    // stage group g (input rows r0-2+4g .. r0+1+4g) of this strip
    auto stage = [&](int g) {
      float* buf = &ring[(unsigned)g % kRing][0][0];
      const int gr = r0 - 2 + g * kGroup;
      if (vec) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (t + i * kHarrisThreads >= kChunks) break;
          const int r = gr + slot_row[i], c = cs - kPad + slot_col[i];
          const bool ok = kInside || (r >= 0 && r < x && c >= 0 && c < y);
          const float* src = ok ? img + ((long long)r * y + c) : img;
          copy16(buf + slot_row[i] * kRowW + slot_col[i], src, ok ? 16 : 0);
        }
      } else {
        // columns cs-2 .. cs+129, one element a copy
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          for (int j = t; j < kStrip + 4; j += kHarrisThreads) {
            const int r = gr + i, c = cs - 2 + j;
            const bool ok = kInside || (r >= 0 && r < x && c >= 0 && c < y);
            const float* src = ok ? img + ((long long)r * y + c) : img;
            copy4(buf + i * kRowW + j + 2, src, ok ? 4 : 0);
          }
        }
      }
    };
    // group g has landed and every thread is done with group g-1, whose
    // buffer then takes group g+kRing-1
    auto advance = [&](int g) {
      wait_copies<kRing - 2>();
      __syncthreads();
      if (g + kRing - 1 < n_groups) stage(g + kRing - 1);
      commit_copies();
    };

#pragma unroll
    for (int g = 0; g < kRing - 1; ++g) {
      if (g < n_groups) stage(g);
      commit_copies();
    }

    // group 0: the two rows above the tile start the input window, the next
    // two the gradient window
    Window w;
    float d[kIn], s[kIn], h[3][kOwn];
    advance(0);
    across(ring[0][0], t, w.d[0], w.s[0]);
    across(ring[0][1], t, w.d[1], w.s[1]);
    across(ring[0][2], t, d, s);
    gradient(w, d, s, w.h[0]);
    push_input(w, d, s);
    across(ring[0][3], t, d, s);
    gradient(w, d, s, w.h[1]);
    push_input(w, d, s);

    const int col = cs + kOwn * t;
    for (int g = 1; g < n_groups; ++g) {
      advance(g);
      const unsigned buf = (unsigned)g % kRing;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        across(ring[buf][i], t, d, s);
        gradient(w, d, s, h);
        push_input(w, d, s);
        float resp[kOwn];
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          const float sxx = (w.h[0][0][j] + w.h[1][0][j]) + h[0][j];
          const float syy = (w.h[0][1][j] + w.h[1][1][j]) + h[1][j];
          const float sxy = (w.h[0][2][j] + w.h[1][2][j]) + h[2][j];
          const float det = sxx * syy - sxy * sxy;
          const float tr = sxx + syy;
          resp[j] = det - k * tr * tr;
        }
        push_gradient(w, h);
        // an inside tile's rows fill its groups: each row computed is an output
        const int row = r0 + (g - 1) * kGroup + i;
        float* o = out + ((long long)row * y + col);
        if (vec) {
          // c_end is a multiple of 4 here, so a thread's columns all lie
          // inside or all outside
          if (kInside || (row < r_end && col < c_end)) {
#pragma unroll
            for (int j = 0; j < kOwn; j += 2) {
              *reinterpret_cast<float2*>(o + j) = make_float2(resp[j], resp[j + 1]);
            }
          }
        } else if (kInside || row < r_end) {
#pragma unroll
          for (int j = 0; j < kOwn; ++j) {
            if (kInside || col + j < c_end) o[j] = resp[j];
          }
        }
      }
    }
    __syncthreads();   // the next strip's first groups reuse the buffers
  }
}

}  // namespace

__global__ void __launch_bounds__(kHarrisThreads)
harris_kernel(const float* __restrict__ img, float* __restrict__ out, int x,
              int y, int rows, int bn, int nblk_r, int nblk_c, float k) {
  __shared__ __align__(16) float ring[kRing][kGroup][kRowW];

  const int r0 = clamped_tile(blockIdx.y, nblk_r) * rows;
  const int c0 = clamped_tile(blockIdx.x, nblk_c) * bn;
  const int r_end = min(r0 + rows, x);
  const int c_end = min(c0 + bn, y);
  const bool vec = y % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // rows is a multiple of 8, so the walk stages rows r0-2 .. r0+rows+1 and
  // columns c0-4 .. c0+bn+3
  if (r0 >= 2 && r0 + rows + 2 <= x && c0 >= kPad && c0 + bn + kPad <= y) {
    walk_tile<true>(img, out, x, y, r0, r_end, c0, c_end, k, vec, ring);
  } else {
    walk_tile<false>(img, out, x, y, r0, r_end, c0, c_end, k, vec, ring);
  }
}

extern "C" int repro_harris_f32(const void* img, void* out, int x, int y,
                                int rows, int bn, int nblk_r, int nblk_c,
                                int grid_r, int grid_c, float k, int device,
                                void* stream) {
  return launch_tiles<kHarrisThreads>(harris_kernel, grid_r, grid_c, device, stream,
                                      (const float*)img, (float*)out, x, y, rows, bn,
                                      nblk_r, nblk_c, k);
}

extern "C" int repro_harris_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, harris_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}
