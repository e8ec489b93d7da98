// The wide-d tier that csrc/kernel_matvec.cu, kernel_grad_x.cu and kernel_bwd_fused.cu
// share: squared distances for inputs of any number d of dims.
//
// The d = 3 and d <= 64 tiers of those kernels hold a row of x1 in registers.  Past 64
// dims a row no longer fits, so this tier walks the input dims in slabs of kSlab: each
// slab of the block's x1 rows and of the staged x2 rows goes into shared memory, and every
// pair's d2 is summed across the slabs in registers.  The Pallas kernels take any d
// (gpytorch_tpu/ops/pallas_kernels.py pads to Dp = round_up(d, 8) and, past 8 dims, uses
// the quadratic expansion); this tier keeps the direct differences of the narrower tiers.
// Slabs of 32 dims (not 64) keep a block's x1 slab (128 rows, padded to 33 floats a row
// against bank conflicts: 16.9 KB) and its siblings under the 48 KB of static shared
// memory.  The kernels that write a d-wide output (dx) take one output slab of kOutSlab
// dims per block and recompute the distances for each: ceil(d / 16) times the kernel
// evaluation, the price of keeping the output accumulators in registers.  Speed is not this
// tier's job; it exists so that no d raises.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int kSlab = 32;              // input dims staged per pass of the distance
constexpr int kRowStride = kSlab + 1;  // shared-memory stride of the block's x1 rows
constexpr int kOutSlab = 16;           // output dims per block of the dx kernels

// Stages dims [k0, k0 + W) of `rows` rows of a row-major (., d) matrix, from row r0, into
// dst with row stride `stride`; rows at or past r_end and dims at or past d are zeros.
template <int W>
__device__ __forceinline__ void stage_slab(const float* __restrict__ x, int r0, int r_end, int d, int k0, int rows,
                                           int stride, float* __restrict__ dst) {
    for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
        const int r = idx / W, k = idx % W;
        const int row = r0 + r, col = k0 + k;
        dst[r * stride + k] = (row < r_end && col < d) ? x[(int64_t)row * d + col] : 0.0f;
    }
}

// d2[jj] = |x1_i - x2_(j0 + jj)|^2 for this thread's row i = row0 + threadIdx.x of x1 and
// the TJ rows of x2 from j0 (rows of x1 at or past n and of x2 at or past j_end are zeros).
// x1s (ROWS * kRowStride floats) and x2s (TJ * kSlab) are shared memory.  Every thread of
// the block calls it; it begins and ends with a barrier, so the caller may restage its own
// shared tiles before and after.
template <int ROWS, int TJ>
__device__ __forceinline__ void sq_dist_tile(const float* __restrict__ x1, const float* __restrict__ x2, int n,
                                             int j_end, int d, int row0, int j0, float* __restrict__ x1s,
                                             float* __restrict__ x2s, float (&d2)[TJ]) {
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) d2[jj] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kSlab) {
        __syncthreads();
        stage_slab<kSlab>(x1, row0, n, d, k0, ROWS, kRowStride, x1s);
        stage_slab<kSlab>(x2, j0, j_end, d, k0, TJ, kSlab, x2s);
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kSlab; ++k) {
            const float a = x1s[threadIdx.x * kRowStride + k];
#pragma unroll
            for (int jj = 0; jj < TJ; ++jj) {
                const float diff = a - x2s[jj * kSlab + k];
                d2[jj] = fmaf(diff, diff, d2[jj]);
            }
        }
    }
    __syncthreads();
}

}  // namespace wide
