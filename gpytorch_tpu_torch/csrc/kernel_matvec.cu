// Streaming stationary-kernel matvec on Hopper: out[i, :] = sum_j k(|x1_i - x2_j|^2) v[j, :].
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_matvec_pallas (the TPU kernel behind every
// CG iteration, every Lanczos block and every cross-covariance product of exact-GP serving).
// Only what it computes is carried over.  The TPU kernel's (1024, 2048) tiles, lane padding,
// column chunking, sub-blocking, bf16 / hi-lo MXU emulations and quadratic-expansion
// distances are not: here the distance is a direct difference for every d and the K.V
// product is plain FP32 FMA on the CUDA cores (the "highest" precision the eval path uses;
// TF32 or BF16 would reintroduce the CG stalls the JAX package measured).
//
// Design: each thread owns one output row and TC output columns, accumulated in registers
// (for t = 1 and t > 64 in two levels, one sum per staged tile: CG's residual stays
// honest, and so do the LOVE variances K** - |K*x R|^2, which cancel to 1e-5 of K**).
// A block of 128 threads owns 128 rows and one tile of TC columns (blockIdx.y), and walks
// over all of x2 and v in tiles of TJ rows staged in shared memory.  Every output element is
// written once, by one thread, with no atomics, so the result is deterministic.  Ragged
// n, m and t are masked: out-of-range x2 rows and v entries are staged as zeros, so the
// inner loop needs no branch; out-of-range output rows and columns are never stored.
// K is never stored anywhere.
//
// What bounds it on the H100: for d = 3 and t = 1 each kernel element costs one MUFU exp
// (plus a sqrt for the Matern kernels) and about ten FP32 / shared-memory instructions, so
// the kernel is bound by instruction issue and the SFU, not by memory (x2 and v stream
// through shared memory once per 128 rows).  For wide t the TC accumulating FMAs dominate.
// Known gaps, left to later work: a cross-covariance strip of 2048 test rows fills only
// 16 of the 132 SMs per column tile (no split over j, which would need a second reduction
// pass); column tiles are 1, 32 or 64 wide (t = 20 runs 32 FMAs per element, t = 100 runs
// four tiles of 32 summed per staged tile), and each column tile recomputes k; any d other
// than 3 runs padded to 64 dims.  The template tiers are the ones the paths use (d = 3;
// t = 1, 20, 64, 100), so that nvcc builds 4 x 2 x 4 instantiations; a finer tier waits
// for a measured shape that needs it.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // threads per block = output rows per block
constexpr int kTJ = 64;     // x2 / v rows staged per shared-memory tile

enum KernelType { kRBF = 0, kMatern05 = 1, kMatern15 = 2, kMatern25 = 3 };

template <int KT>
__device__ __forceinline__ float kernel_fn(float d2) {
    if constexpr (KT == kRBF) {
        return __expf(-0.5f * d2);
    }
    const float r = sqrtf(fmaxf(d2, 1e-30f));
    if constexpr (KT == kMatern05) {
        return __expf(-r);
    }
    if constexpr (KT == kMatern15) {
        const float s = 1.7320508075688772f * r;
        return (1.0f + s) * __expf(-s);
    } else {
        const float s = 2.23606797749979f * r;
        return (1.0f + s + s * s * (1.0f / 3.0f)) * __expf(-s);
    }
}

// DP: distance dims held in registers (3, or 64 for any other d, with the extra dims zero
// on both sides so they add nothing).  DS: the row stride of the staged x2 tile, DP rounded
// up to a multiple of 4 for 16-byte shared loads.
// TILED: sum each staged tile's kTJ terms apart before adding them to the running sum
// (always so for TC = 1).
template <int KT, int DP, int TC, bool TILED>
__global__ void __launch_bounds__(kRows)
kernel_matvec_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ v,
                  float* __restrict__ out, int n, int m, int d, int t) {
    constexpr int DS = (DP + 3) / 4 * 4;
    __shared__ __align__(16) float xs[kTJ * DS];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int c0 = blockIdx.y * TC;

    float xi[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        xi[k] = (row < n && k < d) ? x1[(int64_t)row * d + k] : 0.0f;
    }
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        acc[c] = 0.0f;
    }

    for (int j0 = 0; j0 < m; j0 += kTJ) {
        for (int idx = threadIdx.x; idx < kTJ * DS; idx += kRows) {
            const int jj = idx / DS, k = idx % DS;
            const int j = j0 + jj;
            xs[idx] = (j < m && k < d) ? x2[(int64_t)j * d + k] : 0.0f;
        }
        for (int idx = threadIdx.x; idx < kTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            vs[idx] = (j < m && c0 + c < t) ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        // t = 1, the product of every CG iteration: each tile's kTJ terms are summed apart
        // and then added to the running sum, which cuts the float32 summation error about
        // tenfold.  CG needs it: with one running sum it took 10 more iterations at N=100k
        // on an H100 and ended with its true residual 2.4 times over the tolerance.  The
        // t = 20 and t = 64 tiers keep one level, because a second set of TC accumulators
        // made them 40-60 % slower there.  t > 64 (the LOVE root, t = 100) runs TILED tiles
        // of 32: with one level over 100k terms the smallest LOVE variances of the trained
        // flagship (N=100k, on an H100) were 90 % off float64 (5 % through cuBLAS), and their input gradients
        // 2.3e-3 of the largest gradient (1.4e-4).
        float tile_sum = 0.0f;
        float tile[TILED ? TC : 1];
        if constexpr (TILED) {
#pragma unroll
            for (int c = 0; c < TC; ++c) tile[c] = 0.0f;
        }
#pragma unroll 4
        for (int jj = 0; jj < kTJ; ++jj) {
            float d2 = 0.0f;
#pragma unroll
            for (int k4 = 0; k4 < DS; k4 += 4) {
                const float4 b = *reinterpret_cast<const float4*>(&xs[jj * DS + k4]);
                const float bk[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (k4 + q < DP) {
                        const float diff = xi[k4 + q] - bk[q];
                        d2 = fmaf(diff, diff, d2);
                    }
                }
            }
            const float kv = kernel_fn<KT>(d2);
            if constexpr (TC == 1) {
                tile_sum = fmaf(kv, vs[jj], tile_sum);
            } else if constexpr (TILED) {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 w = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    tile[c] = fmaf(kv, w.x, tile[c]);
                    tile[c + 1] = fmaf(kv, w.y, tile[c + 1]);
                    tile[c + 2] = fmaf(kv, w.z, tile[c + 2]);
                    tile[c + 3] = fmaf(kv, w.w, tile[c + 3]);
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 w = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    acc[c] = fmaf(kv, w.x, acc[c]);
                    acc[c + 1] = fmaf(kv, w.y, acc[c + 1]);
                    acc[c + 2] = fmaf(kv, w.z, acc[c + 2]);
                    acc[c + 3] = fmaf(kv, w.w, acc[c + 3]);
                }
            }
        }
        if constexpr (TC == 1) {
            acc[0] += tile_sum;
        }
        if constexpr (TILED) {
#pragma unroll
            for (int c = 0; c < TC; ++c) acc[c] += tile[c];
        }
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int c = 0; c < TC; ++c) {
            if (c0 + c < t) {
                out[(int64_t)row * t + c0 + c] = acc[c];
            }
        }
    }
}

template <int KT, int DP, int TC, bool TILED = false>
void launch(const float* x1, const float* x2, const float* v, float* out, int n, int m, int d, int t,
            cudaStream_t stream) {
    const dim3 grid((n + kRows - 1) / kRows, (t + TC - 1) / TC);
    kernel_matvec_f32<KT, DP, TC, TILED><<<grid, kRows, 0, stream>>>(x1, x2, v, out, n, m, d, t);
}

template <int KT, int DP>
int dispatch_tc(const float* x1, const float* x2, const float* v, float* out, int n, int m, int d, int t,
                cudaStream_t s) {
    if (t == 1) launch<KT, DP, 1>(x1, x2, v, out, n, m, d, t, s);
    else if (t <= 32) launch<KT, DP, 32>(x1, x2, v, out, n, m, d, t, s);
    else if (t <= 64) launch<KT, DP, 64>(x1, x2, v, out, n, m, d, t, s);
    else launch<KT, DP, 32, true>(x1, x2, v, out, n, m, d, t, s);
    return 0;
}

template <int KT>
int dispatch_d(const float* x1, const float* x2, const float* v, float* out, int n, int m, int d, int t,
               cudaStream_t s) {
    if (d == 3) return dispatch_tc<KT, 3>(x1, x2, v, out, n, m, d, t, s);
    if (d <= 64) return dispatch_tc<KT, 64>(x1, x2, v, out, n, m, d, t, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the matvec on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), v (m, t), out (n, t): float32, row-major, contiguous, on one device.
extern "C" int gp_kernel_matvec_f32(const void* x1, const void* x2, const void* v, void* out, int n, int m,
                                    int d, int t, int kernel_type, void* stream) {
    if (n <= 0 || t <= 0 || m < 0 || d <= 0 || (t + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
    const float* a = static_cast<const float*>(x1);
    const float* b = static_cast<const float*>(x2);
    const float* w = static_cast<const float*>(v);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
    switch (kernel_type) {
        case kRBF: rc = dispatch_d<kRBF>(a, b, w, o, n, m, d, t, s); break;
        case kMatern05: rc = dispatch_d<kMatern05>(a, b, w, o, n, m, d, t, s); break;
        case kMatern15: rc = dispatch_d<kMatern15>(a, b, w, o, n, m, d, t, s); break;
        case kMatern25: rc = dispatch_d<kMatern25>(a, b, w, o, n, m, d, t, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    return (int)cudaGetLastError();
}
