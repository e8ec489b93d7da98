// Fused symmetric backward of the periodic-kernel product on Hopper.
//
// For out = K(a, a) v with K_ij = exp(-2 sum_k w_k sin^2(pi (a_ik - a_jk))) and an output
// cotangent g, one pass over the (i, j) pairs gives, with S_ijk = sin(pi (a_ik - a_jk)) and
// C_ijk = cos(pi (a_ik - a_jk)),
//   dv[i, :]     = sum_j K_ij g[j, :]
//   dx_raw[i, k] = sum_j K_ij (g_i . v_j + v_i . g_j) S_ijk C_ijk
//   dw_raw[i, k] = sum_j K_ij (g_i . v_j) S_ijk^2
// and the wrapper applies the constant factors: dx = -4 pi w_k dx_raw (the cotangent of a,
// both operand slots, since x1 and x2 are one tensor; 2 S C = sin(2 pi (a_i - a_j))) and
// dw_k = -2 sum_i dw_raw[i, k] (the cotangent of w).
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_periodic_bwd_fused_pallas (the backward of
// every mBCG training step of a periodic exact GP).  The TPU kernel forms per-pair sines
// for K and reduces dx and dw through full-angle tables and the identity
// sin^2 = (1 - c_i c_j - s_i s_j) / 2, which cancels near the diagonal.  Here S and C come
// from per-point half-angle tables, S = s_i c_j - c_i s_j and C = c_i c_j + s_i s_j with
// s, c = sin, cos(pi (a - rint(a))) (see periodic_common.cuh): no cancellation of
// O(1) terms, no large-argument rounding, and S = 0 exactly for equal points.  The TPU
// kernel's (BN, bm) tiles, sub-blocks, lane padding and its 128-lane aux output are not
// carried over.
//
// Design (as csrc/kernel_bwd_fused.cu): one thread owns one row i and keeps its tables,
// g_i, v_i and its dv, dx and dw accumulators in registers.  A block of 128 threads owns
// 128 rows and one chunk of TC columns (blockIdx.y), and walks over all rows j in tiles of
// kTJ staged in shared memory (the tile's tables formed once per block as it is staged).
// Columns are chunked at 32 (t = 64 runs two chunks, each recomputing K): dv columns of
// different chunks are disjoint, while dx and dw add across chunks, so each chunk writes
// its own dx_raw and dw_raw partials (chunks, n, d); the wrapper sums them with torch.sum.
// No atomics: the result is deterministic.  dx and dw are summed per staged tile and then
// added to the running sums.  Ragged n and t are masked by staging zeros (a zero g and v
// row adds nothing) and by not storing rows and columns out of range.
//
// What bounds it on the H100: per pair and chunk of 32 columns, 96 FMAs for g_i . v_j,
// v_i . g_j and dv, one exp, and about 15 FP32 instructions per input dim; the bytes are
// negligible.  At n = 100k, d = 2, t = 64 that is about 4.2e12 FP32 operations, or about
// 62 ms at 67 TFLOP/s.  As for kernel_bwd_fused.cu, the t-long dot products per pair are
// a wgmma target left to later work.  Tiers: DP input dims in registers
// (periodic::dispatch_dp), column chunks of 1 (t = 1) and 32.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_common.cuh"

namespace {

using periodic::half_angle;
using periodic::sin_diff;

constexpr int kRows = 128;  // threads per block = rows i per block
constexpr int kTJ = 32;     // rows j staged per shared-memory tile
constexpr int kTC = 32;     // columns per chunk when t > 1

template <int DP, int TC>
__global__ void __launch_bounds__(kRows)
periodic_bwd_fused_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ g,
                       const float* __restrict__ v, float* __restrict__ dv, float* __restrict__ dx_part,
                       float* __restrict__ dw_part, int n, int d, int t) {
    __shared__ float ss[kTJ * DP];
    __shared__ float cs[kTJ * DP];
    __shared__ __align__(16) float gs[kTJ * TC];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;

    float si[DP], ci[DP], wk[DP], dxa[DP], dwa[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        si[k] = 0.0f;
        ci[k] = 0.0f;
        if (row < n && k < d) half_angle(x[(int64_t)row * d + k], si[k], ci[k]);
        wk[k] = k < d ? w[k] : 0.0f;
        dxa[k] = 0.0f;
        dwa[k] = 0.0f;
    }
    float gi[TC], vi[TC], dva[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
        dva[c] = 0.0f;
    }

    for (int j0 = 0; j0 < n; j0 += kTJ) {
        for (int idx = threadIdx.x; idx < kTJ * DP; idx += kRows) {
            const int jj = idx / DP, k = idx % DP;
            const int j = j0 + jj;
            float s = 0.0f, c = 0.0f;
            if (j < n && k < d) half_angle(x[(int64_t)j * d + k], s, c);
            ss[idx] = s;
            cs[idx] = c;
        }
        for (int idx = threadIdx.x; idx < kTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            const bool in = j < n && c0 + c < t;
            gs[idx] = in ? g[(int64_t)j * t + c0 + c] : 0.0f;
            vs[idx] = in ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_dx[DP], tile_dw[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            tile_dx[k] = 0.0f;
            tile_dw[k] = 0.0f;
        }

#pragma unroll 2
        for (int jj = 0; jj < kTJ; ++jj) {
            float sd[DP];
            float q = 0.0f;
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                sd[k] = sin_diff(si[k], ci[k], ss[jj * DP + k], cs[jj * DP + k]);
                q = fmaf(wk[k] * sd[k], sd[k], q);
            }
            const float kv = __expf(-2.0f * q);

            float gv = 0.0f, vg = 0.0f;
            if constexpr (TC % 4 == 0) {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 vj = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    const float4 gj = *reinterpret_cast<const float4*>(&gs[jj * TC + c]);
                    gv = fmaf(gi[c], vj.x, gv);
                    gv = fmaf(gi[c + 1], vj.y, gv);
                    gv = fmaf(gi[c + 2], vj.z, gv);
                    gv = fmaf(gi[c + 3], vj.w, gv);
                    vg = fmaf(vi[c], gj.x, vg);
                    vg = fmaf(vi[c + 1], gj.y, vg);
                    vg = fmaf(vi[c + 2], gj.z, vg);
                    vg = fmaf(vi[c + 3], gj.w, vg);
                    dva[c] = fmaf(kv, gj.x, dva[c]);
                    dva[c + 1] = fmaf(kv, gj.y, dva[c + 1]);
                    dva[c + 2] = fmaf(kv, gj.z, dva[c + 2]);
                    dva[c + 3] = fmaf(kv, gj.w, dva[c + 3]);
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; ++c) {
                    const float vj = vs[jj * TC + c], gj = gs[jj * TC + c];
                    gv = fmaf(gi[c], vj, gv);
                    vg = fmaf(vi[c], gj, vg);
                    dva[c] = fmaf(kv, gj, dva[c]);
                }
            }
            const float kw = kv * gv;           // K (g_i . v_j)
            const float gg = kw + kv * vg;      // K (g_i . v_j + v_i . g_j)
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                const float cd = fmaf(ci[k], cs[jj * DP + k], si[k] * ss[jj * DP + k]);
                tile_dx[k] = fmaf(gg, sd[k] * cd, tile_dx[k]);
                tile_dw[k] = fmaf(kw, sd[k] * sd[k], tile_dw[k]);
            }
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            dxa[k] += tile_dx[k];
            dwa[k] += tile_dw[k];
        }
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            if (k < d) {
                dx_part[((int64_t)chunk * n + row) * d + k] = dxa[k];
                dw_part[((int64_t)chunk * n + row) * d + k] = dwa[k];
            }
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) {
            if (c0 + c < t) dv[(int64_t)row * t + c0 + c] = dva[c];
        }
    }
}

template <int DP, int TC>
void launch(const float* x, const float* w, const float* g, const float* v, float* dv, float* dx_part,
            float* dw_part, int n, int d, int t, int num_chunks, cudaStream_t stream) {
    const dim3 grid((n + kRows - 1) / kRows, num_chunks);
    periodic_bwd_fused_f32<DP, TC><<<grid, kRows, 0, stream>>>(x, w, g, v, dv, dx_part, dw_part, n, d, t);
}

template <int DP>
void dispatch_tc(const float* x, const float* w, const float* g, const float* v, float* dv, float* dx_part,
                 float* dw_part, int n, int d, int t, int num_chunks, cudaStream_t s) {
    if (t == 1) launch<DP, 1>(x, w, g, v, dv, dx_part, dw_part, n, d, t, num_chunks, s);
    else launch<DP, kTC>(x, w, g, v, dv, dx_part, dw_part, n, d, t, num_chunks, s);
}

}  // namespace

// Launches the fused periodic backward on `stream` and returns cudaGetLastError() (0 on
// success).  x (n, d), w (d,), g (n, t), v (n, t): float32, row-major, contiguous, on one
// device; 1 <= d <= 64.  Outputs: dv (n, t); dx_part and dw_part (num_chunks, n, d) of raw
// sums, where num_chunks = 1 for t = 1 and ceil(t / 32) otherwise.  The caller sums the
// partials over chunks and applies dx = -4 pi w dx_raw, dw = -2 sum_i dw_raw.  Sizes that
// disagree are refused.
extern "C" int gp_periodic_bwd_fused_f32(const void* x, const void* w, const void* g, const void* v, void* dv,
                                         void* dx_part, void* dw_part, int n, int d, int t, int num_chunks,
                                         void* stream) {
    if (n <= 0 || t <= 0 || d <= 0 || d > periodic::kMaxDP) return (int)cudaErrorInvalidValue;
    const int want_chunks = t == 1 ? 1 : (t + kTC - 1) / kTC;
    if (num_chunks != want_chunks || want_chunks > 65535) return (int)cudaErrorInvalidValue;
    if (dv == nullptr || dx_part == nullptr || dw_part == nullptr) return (int)cudaErrorInvalidValue;
    const float* xx = static_cast<const float*>(x);
    const float* ww = static_cast<const float*>(w);
    const float* gg = static_cast<const float*>(g);
    const float* vv = static_cast<const float*>(v);
    float* a = static_cast<float*>(dv);
    float* b = static_cast<float*>(dx_part);
    float* c = static_cast<float*>(dw_part);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    periodic::dispatch_dp(d, [&](auto dp) {
        dispatch_tc<decltype(dp)::value>(xx, ww, gg, vv, a, b, c, n, d, t, num_chunks, s);
    });
    return (int)cudaGetLastError();
}
