// Streaming periodic-kernel matvec on Hopper:
//   out[i, :] = sum_j K_ij v[j, :],   K_ij = exp(-2 sum_k w_k sin^2(pi (a_ik - b_jk)))
// with a = x1 / period, b = x2 / period and w = 1 / lengthscale^2 (the caller scales).
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_periodic_matvec_pallas (the TPU kernel
// behind every CG iteration, every Lanczos block and every cross-covariance product of a
// periodic exact GP).  Only what it computes is carried over: the TPU kernel's (BN, BM)
// tiles, lane and Dp padding and its per-pair sin are not.
//
// Large arguments: each point is reduced once to its fractional part and its half-angle
// table s, c = sin, cos(pi f) is formed with sincospif; sin(pi (a_i - b_j)) is then
// +-(s_i c_j - c_i s_j), exactly 0 for equal points, whatever the size of a (see
// periodic_common.cuh).  No per-pair transcendental is left but the exp.
//
// Design (as csrc/kernel_matvec.cu): each thread owns one output row and TC output columns
// accumulated in registers (for t = 1 in two levels, one sum per staged tile, which keeps
// float32 CG honest).  A block of 128 threads owns 128 rows and one tile of TC columns
// (blockIdx.y) and walks over all of x2 and v in tiles of kTJ rows: the tile's half-angle
// tables are formed once per block as it is staged into shared memory (O(m d) sincospif
// per 128 rows, against O(128 m d) pair terms).  Every output element is written once by
// one thread, without atomics: the result is deterministic.  Ragged n, m and t are masked:
// out-of-range x2 rows stage zero tables (K = 1) against zero v rows, so they add nothing.
//
// What bounds it on the H100: per (i, j) pair about 5 FP32 instructions per input dim, one
// MUFU exp, and TC FMAs with their shared-memory loads; at t = 64 and d = 2 the FMAs
// dominate and the FP32 instruction rate bounds it, not memory.  Known gaps, as for
// kernel_matvec.cu: a 2048-row cross-covariance strip fills few SMs, and each column tile
// recomputes K.  Tiers: DP input dims in registers (periodic::dispatch_dp); column tiles of
// 1, 32 and 64.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_common.cuh"

namespace {

using periodic::half_angle;
using periodic::sin_diff;

constexpr int kRows = 128;  // threads per block = output rows per block
constexpr int kTJ = 64;     // x2 / v rows staged per shared-memory tile

template <int DP, int TC>
__global__ void __launch_bounds__(kRows)
periodic_matvec_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ w,
                    const float* __restrict__ v, float* __restrict__ out, int n, int m, int d, int t) {
    __shared__ float ss[kTJ * DP];
    __shared__ float cs[kTJ * DP];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int c0 = blockIdx.y * TC;

    float si[DP], ci[DP], wk[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        si[k] = 0.0f;
        ci[k] = 0.0f;
        if (row < n && k < d) half_angle(x1[(int64_t)row * d + k], si[k], ci[k]);
        wk[k] = k < d ? w[k] : 0.0f;
    }
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[c] = 0.0f;

    for (int j0 = 0; j0 < m; j0 += kTJ) {
        for (int idx = threadIdx.x; idx < kTJ * DP; idx += kRows) {
            const int jj = idx / DP, k = idx % DP;
            const int j = j0 + jj;
            float s = 0.0f, c = 0.0f;
            if (j < m && k < d) half_angle(x2[(int64_t)j * d + k], s, c);
            ss[idx] = s;
            cs[idx] = c;
        }
        for (int idx = threadIdx.x; idx < kTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            vs[idx] = (j < m && c0 + c < t) ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_sum = 0.0f;  // t = 1: one sum per staged tile (see kernel_matvec.cu)
#pragma unroll 4
        for (int jj = 0; jj < kTJ; ++jj) {
            float q = 0.0f;
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                const float s = sin_diff(si[k], ci[k], ss[jj * DP + k], cs[jj * DP + k]);
                q = fmaf(wk[k] * s, s, q);
            }
            const float kv = __expf(-2.0f * q);
            if constexpr (TC == 1) {
                tile_sum = fmaf(kv, vs[jj], tile_sum);
            } else {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 b = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    acc[c] = fmaf(kv, b.x, acc[c]);
                    acc[c + 1] = fmaf(kv, b.y, acc[c + 1]);
                    acc[c + 2] = fmaf(kv, b.z, acc[c + 2]);
                    acc[c + 3] = fmaf(kv, b.w, acc[c + 3]);
                }
            }
        }
        if constexpr (TC == 1) acc[0] += tile_sum;
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int c = 0; c < TC; ++c) {
            if (c0 + c < t) out[(int64_t)row * t + c0 + c] = acc[c];
        }
    }
}

// The wide-d tier (d > kMaxDP): the half-angle tables of the block's rows no longer fit in
// registers, so the input dims are walked in slabs of kWideSlab.  For each staged tile of
// kWideTJ rows j, every slab's tables of the block's rows i and of the tile's rows j are
// formed as they are staged into shared memory (the rows i's once per tile: 1/kWideTJ more
// sincospif than pair terms) with the slab's weights, and each pair's weighted sin^2 is
// summed across the slabs in registers.  Columns in tiles of TC = 1 or 32, each summed per
// staged tile.  As in csrc/wide_d.cuh, speed is not this tier's job.
constexpr int kWideSlab = 32;
constexpr int kWideStride = kWideSlab + 1;  // the rows i's tables, padded against bank conflicts
constexpr int kWideTJ = 16;

template <int TC>
__global__ void __launch_bounds__(kRows)
periodic_matvec_wide_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ w,
                         const float* __restrict__ v, float* __restrict__ out, int n, int m, int d, int t) {
    __shared__ float s1[kRows * kWideStride];
    __shared__ float c1[kRows * kWideStride];
    __shared__ float s2[kWideTJ * kWideSlab];
    __shared__ float c2[kWideTJ * kWideSlab];
    __shared__ float ws[kWideSlab];
    __shared__ __align__(16) float vs[kWideTJ * TC];

    const int row0 = blockIdx.x * kRows;
    const int row = row0 + threadIdx.x;
    const int c0 = blockIdx.y * TC;
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[c] = 0.0f;

    for (int j0 = 0; j0 < m; j0 += kWideTJ) {
        float q[kWideTJ];
#pragma unroll
        for (int jj = 0; jj < kWideTJ; ++jj) q[jj] = 0.0f;
        for (int k0 = 0; k0 < d; k0 += kWideSlab) {
            __syncthreads();
            for (int idx = threadIdx.x; idx < kRows * kWideSlab; idx += kRows) {
                const int r = idx / kWideSlab, k = idx % kWideSlab;
                float sv = 0.0f, cv = 0.0f;
                if (row0 + r < n && k0 + k < d) half_angle(x1[(int64_t)(row0 + r) * d + k0 + k], sv, cv);
                s1[r * kWideStride + k] = sv;
                c1[r * kWideStride + k] = cv;
            }
            for (int idx = threadIdx.x; idx < kWideTJ * kWideSlab; idx += kRows) {
                const int jj = idx / kWideSlab, k = idx % kWideSlab;
                float sv = 0.0f, cv = 0.0f;
                if (j0 + jj < m && k0 + k < d) half_angle(x2[(int64_t)(j0 + jj) * d + k0 + k], sv, cv);
                s2[idx] = sv;
                c2[idx] = cv;
            }
            const int k = threadIdx.x;
            if (k < kWideSlab) ws[k] = k0 + k < d ? w[k0 + k] : 0.0f;
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < kWideSlab; ++k) {
                const float si = s1[threadIdx.x * kWideStride + k], ci = c1[threadIdx.x * kWideStride + k];
                const float wk = ws[k];
#pragma unroll
                for (int jj = 0; jj < kWideTJ; ++jj) {
                    const float sd = sin_diff(si, ci, s2[jj * kWideSlab + k], c2[jj * kWideSlab + k]);
                    q[jj] = fmaf(wk * sd, sd, q[jj]);
                }
            }
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < kWideTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            vs[idx] = (j < m && c0 + c < t) ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();
        float tile[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) tile[c] = 0.0f;
#pragma unroll
        for (int jj = 0; jj < kWideTJ; ++jj) {
            const float kv = __expf(-2.0f * q[jj]);
#pragma unroll
            for (int c = 0; c < TC; ++c) tile[c] = fmaf(kv, vs[jj * TC + c], tile[c]);
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[c] += tile[c];
    }

    if (row < n) {
#pragma unroll
        for (int c = 0; c < TC; ++c) {
            if (c0 + c < t) out[(int64_t)row * t + c0 + c] = acc[c];
        }
    }
}

template <int TC>
void launch_wide(const float* x1, const float* x2, const float* w, const float* v, float* out, int n, int m, int d,
                 int t, cudaStream_t stream) {
    const dim3 grid((n + kRows - 1) / kRows, (t + TC - 1) / TC);
    periodic_matvec_wide_f32<TC><<<grid, kRows, 0, stream>>>(x1, x2, w, v, out, n, m, d, t);
}

template <int DP, int TC>
void launch(const float* x1, const float* x2, const float* w, const float* v, float* out, int n, int m, int d,
            int t, cudaStream_t stream) {
    const dim3 grid((n + kRows - 1) / kRows, (t + TC - 1) / TC);
    periodic_matvec_f32<DP, TC><<<grid, kRows, 0, stream>>>(x1, x2, w, v, out, n, m, d, t);
}

template <int DP>
void dispatch_tc(const float* x1, const float* x2, const float* w, const float* v, float* out, int n, int m,
                 int d, int t, cudaStream_t s) {
    if (t == 1) launch<DP, 1>(x1, x2, w, v, out, n, m, d, t, s);
    else if (t <= 32) launch<DP, 32>(x1, x2, w, v, out, n, m, d, t, s);
    else launch<DP, 64>(x1, x2, w, v, out, n, m, d, t, s);
}

}  // namespace

// Launches the periodic matvec on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), w (d,), v (m, t), out (n, t): float32, row-major, contiguous, on
// one device; any d >= 1.
extern "C" int gp_periodic_matvec_f32(const void* x1, const void* x2, const void* w, const void* v, void* out,
                                      int n, int m, int d, int t, void* stream) {
    if (n <= 0 || t <= 0 || m < 0 || d <= 0 || (t + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
    const float* a = static_cast<const float*>(x1);
    const float* b = static_cast<const float*>(x2);
    const float* ww = static_cast<const float*>(w);
    const float* vv = static_cast<const float*>(v);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d > periodic::kMaxDP) {
        if (t == 1) launch_wide<1>(a, b, ww, vv, o, n, m, d, t, s);
        else launch_wide<32>(a, b, ww, vv, o, n, m, d, t, s);
    } else {
        periodic::dispatch_dp(d, [&](auto dp) { dispatch_tc<decltype(dp)::value>(a, b, ww, vv, o, n, m, d, t, s); });
    }
    return (int)cudaGetLastError();
}
