// Asymmetric backward of the stationary-kernel product on Hopper: the cotangent of x1 in
// sum(g * (K(x1, x2) v)), with K_ij = k(|x1_i - x2_j|^2):
//   dx1[i, :] = 2 sum_j k'(d2_ij) (g_i . v_j) (x1_i - x2_j)
// The same kernel gives the cotangent of x2 with the roles swapped: dx2 = grad_x(x2, x1, v, g).
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_grad_x_pallas, which _fkm_bwd and _fskm_bwd
// run twice (dx1 and dx2) whenever x1 and x2 differ under gradients: in exact-GP
// prediction that is the gradient of the posterior mean and LOVE variance with respect to
// the test inputs, through K(test, train) v for v = the mean cache (t = 1) and the LOVE
// root (t = 100).  Only what it computes is carried over.  The TPU kernel forms the moment
// as 2 (rowsum(W) x1_i - W x2) with W = k'(d2) (g v^T), two MXU products at default
// precision; here each pair adds W_ij (x1_i - x2_j) from its own differences, which are in
// registers already for the distance.  That avoids the cancellation between two large
// sums, and a coincident pair adds exactly 0: for Matern-1/2, k'(0) = -0.5 / sqrt(1e-30)
// would otherwise multiply the round-off of rowsum(W) x1_i - W_ii x2_i.
//
// What bounds it on the H100: per (i, j) pair and chunk of 32 columns, 32 FMAs for g_i . v_j,
// one exp, 2d for the distance, d FMAs for the moment and a few more for k' and the weight;
// the bytes are negligible.  At n = 2048 test rows, m = 100k training rows, d = 3, t = 100
// that is about 4.5e10 FP32 operations, or about 0.67 ms at 67 TFLOP/s; at t = 1 the exps
// bound it (2e8, about 0.05 ms at 16 SFU results per SM per clock).
//
// Design: one thread owns one row i of x1, keeps x1_i, g_i (one chunk of TC columns) and
// its dx accumulators in registers, and walks over rows j of x2 in tiles of kTJ staged in
// shared memory with v.  A block of 128 threads owns 128 rows, one column chunk
// (blockIdx.y) and one slab of the j range (blockIdx.z).  The path's shape is a strip:
// 2,048 test rows make only 16 blocks of 128, so the wrapper splits the j range into
// slabs until the grid fills the card (ops/fused_kernels.py::grad_x_slabs).  Each
// (slab, chunk) writes its own dx partial (slabs * chunks, n, d), which the wrapper folds
// with torch.sum: no atomics, so the result is deterministic.  Within a thread dx is summed
// per staged tile and then added to the running sum, which keeps the float32 summation
// error of 100k terms near that of 3k.  Ragged n, m and t are masked by staging zeros (a
// zero v row adds k' * 0 * diff = 0) and by not storing rows out of range.  Columns are
// chunked at 32 (t = 100 runs four chunks, each recomputing the exp); any d other than 3
// runs padded to 64 dims, as in the sibling kernels.  wgmma and TMA are later work.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_d.cuh"

namespace {

constexpr int kRows = 128;  // threads per block = rows i per block
constexpr int kTJ = 32;     // rows j staged per shared-memory tile
constexpr int kTC = 32;     // columns per chunk when t > 1

enum KernelType { kRBF = 0, kMatern05 = 1, kMatern15 = 2, kMatern25 = 3 };

// dk/d(d2) (gpytorch_tpu/ops/pallas_kernels.py::_kernel_prime)
template <int KT>
__device__ __forceinline__ float kernel_prime(float d2) {
    if constexpr (KT == kRBF) {
        return -0.5f * __expf(-0.5f * d2);
    }
    const float r = sqrtf(fmaxf(d2, 1e-30f));
    if constexpr (KT == kMatern05) {
        return -__expf(-r) * (0.5f / r);
    } else if constexpr (KT == kMatern15) {
        return -1.5f * __expf(-1.7320508075688772f * r);
    } else {
        const float s = 2.23606797749979f * r;
        return -(5.0f / 6.0f) * (1.0f + s) * __expf(-s);
    }
}

// DP: distance dims held in registers (3, or 64 for any other d, the extra dims zero on
// both sides).  DS: row stride of the staged x2 tile, DP rounded up to a multiple of 4.
template <int KT, int DP, int TC>
__global__ void __launch_bounds__(kRows)
kernel_grad_x_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ g,
                  const float* __restrict__ v, float* __restrict__ dx_part, int n, int m, int d, int t,
                  int slab_len) {
    constexpr int DS = (DP + 3) / 4 * 4;
    __shared__ __align__(16) float xs[kTJ * DS];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;
    const int j_begin = blockIdx.z * slab_len;
    const int j_end = min(m, j_begin + slab_len);

    float xi[DP], dxa[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        xi[k] = (row < n && k < d) ? x1[(int64_t)row * d + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        gi[c] = (row < n && c0 + c < t) ? g[(int64_t)row * t + c0 + c] : 0.0f;
    }

    for (int j0 = j_begin; j0 < j_end; j0 += kTJ) {
        for (int idx = threadIdx.x; idx < kTJ * DS; idx += kRows) {
            const int jj = idx / DS, k = idx % DS;
            const int j = j0 + jj;
            xs[idx] = (j < j_end && k < d) ? x2[(int64_t)j * d + k] : 0.0f;
        }
        for (int idx = threadIdx.x; idx < kTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            vs[idx] = (j < j_end && c0 + c < t) ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_dx[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) tile_dx[k] = 0.0f;

#pragma unroll 2
        for (int jj = 0; jj < kTJ; ++jj) {
            float diff[DP];
            float d2 = 0.0f;
#pragma unroll
            for (int k4 = 0; k4 < DS; k4 += 4) {
                const float4 b = *reinterpret_cast<const float4*>(&xs[jj * DS + k4]);
                const float bk[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (k4 + q < DP) {
                        diff[k4 + q] = xi[k4 + q] - bk[q];
                        d2 = fmaf(diff[k4 + q], diff[k4 + q], d2);
                    }
                }
            }
            float gv = 0.0f;
            if constexpr (TC % 4 == 0) {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 vj = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    gv = fmaf(gi[c], vj.x, gv);
                    gv = fmaf(gi[c + 1], vj.y, gv);
                    gv = fmaf(gi[c + 2], vj.z, gv);
                    gv = fmaf(gi[c + 3], vj.w, gv);
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; ++c) gv = fmaf(gi[c], vs[jj * TC + c], gv);
            }
            const float w = kernel_prime<KT>(d2) * gv;
#pragma unroll
            for (int k = 0; k < DP; ++k) tile_dx[k] = fmaf(w, diff[k], tile_dx[k]);
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) dxa[k] += tile_dx[k];
        __syncthreads();
    }

    if (row < n) {
        const int64_t part = (int64_t)blockIdx.z * gridDim.y + chunk;
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            if (k < d) dx_part[(part * n + row) * d + k] = 2.0f * dxa[k];
        }
    }
}

// The wide-d tier (d > 64; csrc/wide_d.cuh).  Each block owns one slab of kOutSlab output
// dims o0.. (folded into blockIdx.x with the row block) besides its rows, column chunk and
// slab of j: the distances of each staged tile of kWideTJ rows are summed over slabs of all
// the input dims, and the moment is taken over the block's output dims alone, from x1_i's
// output dims in registers and the tile's staged in shared memory.
constexpr int kWideTJ = 16;

template <int KT, int TC>
__global__ void __launch_bounds__(kRows)
kernel_grad_x_wide_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ g,
                       const float* __restrict__ v, float* __restrict__ dx_part, int n, int m, int d, int t,
                       int slab_len) {
    constexpr int kO = wide::kOutSlab;
    __shared__ float x1s[kRows * wide::kRowStride];
    __shared__ float x2s[kWideTJ * wide::kSlab];
    __shared__ float x2o[kWideTJ * kO];
    __shared__ __align__(16) float vs[kWideTJ * TC];

    const int row_blocks = (n + kRows - 1) / kRows;
    const int row0 = (blockIdx.x % row_blocks) * kRows;
    const int o0 = (blockIdx.x / row_blocks) * kO;
    const int row = row0 + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;
    const int j_begin = blockIdx.z * slab_len;
    const int j_end = min(m, j_begin + slab_len);

    float xo[kO], dxa[kO];
#pragma unroll
    for (int k = 0; k < kO; ++k) {
        xo[k] = (row < n && o0 + k < d) ? x1[(int64_t)row * d + o0 + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        gi[c] = (row < n && c0 + c < t) ? g[(int64_t)row * t + c0 + c] : 0.0f;
    }

    for (int j0 = j_begin; j0 < j_end; j0 += kWideTJ) {
        float d2[kWideTJ];
        wide::sq_dist_tile<kRows, kWideTJ>(x1, x2, n, j_end, d, row0, j0, x1s, x2s, d2);
        wide::stage_slab<kO>(x2, j0, j_end, d, o0, kWideTJ, kO, x2o);
        for (int idx = threadIdx.x; idx < kWideTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            vs[idx] = (j < j_end && c0 + c < t) ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_dx[kO];
#pragma unroll
        for (int k = 0; k < kO; ++k) tile_dx[k] = 0.0f;
#pragma unroll
        for (int jj = 0; jj < kWideTJ; ++jj) {
            float gv = 0.0f;
#pragma unroll
            for (int c = 0; c < TC; ++c) gv = fmaf(gi[c], vs[jj * TC + c], gv);
            const float w = kernel_prime<KT>(d2[jj]) * gv;
#pragma unroll
            for (int k = 0; k < kO; ++k) tile_dx[k] = fmaf(w, xo[k] - x2o[jj * kO + k], tile_dx[k]);
        }
#pragma unroll
        for (int k = 0; k < kO; ++k) dxa[k] += tile_dx[k];
    }

    if (row < n) {
        const int64_t part = (int64_t)blockIdx.z * gridDim.y + chunk;
#pragma unroll
        for (int k = 0; k < kO; ++k) {
            if (o0 + k < d) dx_part[(part * n + row) * d + o0 + k] = 2.0f * dxa[k];
        }
    }
}

struct Args {
    const float *x1, *x2, *g, *v;
    float* dx_part;
    int n, m, d, t, num_chunks, num_slabs, slab_len;
    cudaStream_t stream;
};

template <int KT, int DP, int TC>
void launch(const Args& a) {
    const dim3 grid((a.n + kRows - 1) / kRows, a.num_chunks, a.num_slabs);
    kernel_grad_x_f32<KT, DP, TC>
        <<<grid, kRows, 0, a.stream>>>(a.x1, a.x2, a.g, a.v, a.dx_part, a.n, a.m, a.d, a.t, a.slab_len);
}

template <int KT, int DP>
void dispatch_tc(const Args& a) {
    if (a.t == 1) launch<KT, DP, 1>(a);
    else launch<KT, DP, kTC>(a);
}

template <int KT, int TC>
void launch_wide(const Args& a) {
    const int out_slabs = (a.d + wide::kOutSlab - 1) / wide::kOutSlab;
    const dim3 grid((a.n + kRows - 1) / kRows * out_slabs, a.num_chunks, a.num_slabs);
    kernel_grad_x_wide_f32<KT, TC>
        <<<grid, kRows, 0, a.stream>>>(a.x1, a.x2, a.g, a.v, a.dx_part, a.n, a.m, a.d, a.t, a.slab_len);
}

template <int KT>
int dispatch_d(const Args& a) {
    if (a.d == 3) dispatch_tc<KT, 3>(a);
    else if (a.d <= 64) dispatch_tc<KT, 64>(a);
    else if (a.t == 1) launch_wide<KT, 1>(a);
    else launch_wide<KT, kTC>(a);
    return 0;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), g (n, t), v (m, t): float32, row-major, contiguous, on one device.
// dx_part (num_slabs * num_chunks, n, d), where num_chunks = 1 for t = 1 and ceil(t / 32)
// otherwise; slab s covers rows j of x2 in [s * L, (s + 1) * L) with L = ceil(m / num_slabs)
// rounded up to a multiple of 32 (a slab past m writes zeros).  The caller sums dx_part
// over its first axis.  Sizes that disagree are refused.
extern "C" int gp_kernel_grad_x_f32(const void* x1, const void* x2, const void* g, const void* v, void* dx_part,
                                    int n, int m, int d, int t, int kernel_type, int num_chunks, int num_slabs,
                                    void* stream) {
    if (n <= 0 || m <= 0 || t <= 0 || d <= 0 || dx_part == nullptr) return (int)cudaErrorInvalidValue;
    const int want_chunks = t == 1 ? 1 : (t + kTC - 1) / kTC;
    if (num_chunks != want_chunks || num_chunks > 65535 || num_slabs < 1 || num_slabs > 65535 || num_slabs > m) {
        return (int)cudaErrorInvalidValue;
    }
    const int per_slab = (m + num_slabs - 1) / num_slabs;
    const int slab_len = (per_slab + kTJ - 1) / kTJ * kTJ;
    const Args a{static_cast<const float*>(x1), static_cast<const float*>(x2), static_cast<const float*>(g),
                 static_cast<const float*>(v), static_cast<float*>(dx_part), n, m, d, t, num_chunks, num_slabs,
                 slab_len, static_cast<cudaStream_t>(stream)};
    int rc;
    switch (kernel_type) {
        case kRBF: rc = dispatch_d<kRBF>(a); break;
        case kMatern05: rc = dispatch_d<kMatern05>(a); break;
        case kMatern15: rc = dispatch_d<kMatern15>(a); break;
        case kMatern25: rc = dispatch_d<kMatern25>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    return (int)cudaGetLastError();
}
