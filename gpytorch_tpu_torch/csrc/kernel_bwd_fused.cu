// Fused symmetric backward of the stationary-kernel product on Hopper.
//
// For out = K(x, x) v with K_ij = k(|x_i - x_j|^2) and an output cotangent g, one pass over
// the (i, j) pairs gives
//   dv[i, :] = sum_j k(d2_ij) g[j, :]                                   (if NEED_DV)
//   dx[i, :] = 2 sum_j k'(d2_ij) (g_i . v_j + v_i . g_j) (x_i - x_j)    (k' = 0 at i == j)
//   dos      = sum_ij k(d2_ij) (g_i . v_j)                              (if NEED_DOS)
// dx is the cotangent of x (both operand slots, since x1 and x2 are one tensor) and dos the
// cotangent of an outputscale that multiplies K.  k and k' share one exp per pair.  The
// diagonal's dx term is zero exactly; k' is zeroed there because for Matern kernels
// k'(0) ~ 1/sqrt(eps) would otherwise turn it into a cancellation.
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_bwd_fused_pallas (the backward of every
// mBCG training step, called with need_dv = false and need_dos = true).  Only what it
// computes is carried over: the TPU kernel's (1024, 2048) tiles, lane padding, MXU
// dot_generals for g v^T and v g^T and its (8, 128) dos block are not.  Here every FMA is
// FP32 on the CUDA cores.
//
// Design: one thread owns one row i and keeps x_i, g_i, v_i and its dx_i (and dv_i)
// accumulators in registers.  A block of 128 threads owns 128 rows and one chunk of TC
// columns (blockIdx.y), and walks over all rows j in tiles of kTJ staged in shared memory.
// Columns are chunked at 32 (t = 64 runs two chunks, each recomputing the exp): dv
// columns of different chunks are disjoint, while dx and dos add across chunks, so each
// chunk writes its own dx partial (chunks, n, d) and each block its own dos partial
// (chunks, blocks); the wrapper sums both with torch.sum.  No atomics: the result is
// deterministic.  dx and dos are summed per staged tile and then added to the running
// sum, which keeps the float32 summation error of 100k terms near that of 3k.  Ragged n
// and t are masked by staging zeros (a zero g and v row adds nothing) and by not storing
// rows and columns out of range.
//
// What bounds it on the H100: per pair and chunk of 32 columns, 64 FMAs for g_i . v_j and
// v_i . g_j, one exp, and about 20 more FP32 / shared-memory instructions; the bytes are
// negligible.  At n = 100k, d = 3, t = 64 that is about 2.8e12 FP32 operations, or about
// 41 ms at 67 TFLOP/s.  The two t-long dot products per pair are a natural wgmma target
// (g_blk v_blk^T and v_blk g_blk^T are small matrix products), left to later work.
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

// k(d2) and dk/d(d2), sharing one exp (gpytorch_tpu/ops/pallas_kernels.py::_kernel_fn_and_prime)
template <int KT>
__device__ __forceinline__ void kernel_fn_and_prime(float d2, float& k, float& kp) {
    if constexpr (KT == kRBF) {
        k = __expf(-0.5f * d2);
        kp = -0.5f * k;
        return;
    }
    const float r = sqrtf(fmaxf(d2, 1e-30f));
    if constexpr (KT == kMatern05) {
        k = __expf(-r);
        kp = -k * (0.5f / r);
    } else if constexpr (KT == kMatern15) {
        const float s = 1.7320508075688772f * r;
        const float e = __expf(-s);
        k = (1.0f + s) * e;
        kp = -1.5f * e;
    } else {
        const float s = 2.23606797749979f * r;
        const float e = __expf(-s);
        k = (1.0f + s + s * s * (1.0f / 3.0f)) * e;
        kp = -(5.0f / 6.0f) * (1.0f + s) * e;
    }
}

// DP: distance dims held in registers (3, or 64 for any other d, the extra dims zero).
// DS: row stride of the staged x tile, DP rounded up to a multiple of 4.
template <int KT, int DP, int TC, bool NEED_DV, bool NEED_DOS>
__global__ void __launch_bounds__(kRows)
kernel_bwd_fused_f32(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
                     float* __restrict__ dv, float* __restrict__ dx_part, float* __restrict__ dos_part, int n,
                     int d, int t) {
    constexpr int DS = (DP + 3) / 4 * 4;
    __shared__ __align__(16) float xs[kTJ * DS];
    __shared__ __align__(16) float gs[kTJ * TC];
    __shared__ __align__(16) float vs[kTJ * TC];
    __shared__ float warp_sums[kRows / 32];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;

    float xi[DP], dxa[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        xi[k] = (row < n && k < d) ? x[(int64_t)row * d + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC], vi[TC], dva[NEED_DV ? TC : 1];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
        if constexpr (NEED_DV) dva[c] = 0.0f;
    }
    float dos = 0.0f;

    for (int j0 = 0; j0 < n; j0 += kTJ) {
        for (int idx = threadIdx.x; idx < kTJ * DS; idx += kRows) {
            const int jj = idx / DS, k = idx % DS;
            const int j = j0 + jj;
            xs[idx] = (j < n && k < d) ? x[(int64_t)j * d + k] : 0.0f;
        }
        for (int idx = threadIdx.x; idx < kTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            const bool in = j < n && c0 + c < t;
            gs[idx] = in ? g[(int64_t)j * t + c0 + c] : 0.0f;
            vs[idx] = in ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_dx[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) tile_dx[k] = 0.0f;
        float tile_dos = 0.0f;

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
            float kv, kp;
            kernel_fn_and_prime<KT>(d2, kv, kp);
            if (j0 + jj == row) kp = 0.0f;

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
                    if constexpr (NEED_DV) {
                        dva[c] = fmaf(kv, gj.x, dva[c]);
                        dva[c + 1] = fmaf(kv, gj.y, dva[c + 1]);
                        dva[c + 2] = fmaf(kv, gj.z, dva[c + 2]);
                        dva[c + 3] = fmaf(kv, gj.w, dva[c + 3]);
                    }
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; ++c) {
                    const float vj = vs[jj * TC + c], gj = gs[jj * TC + c];
                    gv = fmaf(gi[c], vj, gv);
                    vg = fmaf(vi[c], gj, vg);
                    if constexpr (NEED_DV) dva[c] = fmaf(kv, gj, dva[c]);
                }
            }
            const float w = kp * (gv + vg);
#pragma unroll
            for (int k = 0; k < DP; ++k) tile_dx[k] = fmaf(w, diff[k], tile_dx[k]);
            if constexpr (NEED_DOS) tile_dos = fmaf(kv, gv, tile_dos);
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) dxa[k] += tile_dx[k];
        if constexpr (NEED_DOS) dos += tile_dos;
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            if (k < d) dx_part[((int64_t)chunk * n + row) * d + k] = 2.0f * dxa[k];
        }
        if constexpr (NEED_DV) {
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                if (c0 + c < t) dv[(int64_t)row * t + c0 + c] = dva[c];
            }
        }
    }
    if constexpr (NEED_DOS) {
        // rows out of range hold g_i = 0 and add nothing; the fold order is fixed
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dos += __shfl_down_sync(0xffffffffu, dos, off);
        if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = dos;
        __syncthreads();
        if (threadIdx.x == 0) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < kRows / 32; ++w) s += warp_sums[w];
            dos_part[(int64_t)chunk * gridDim.x + blockIdx.x] = s;
        }
    }
}

// The wide-d tier (d > 64; csrc/wide_d.cuh).  Each block owns one slab of kOutSlab dx
// dims o0.. (folded into blockIdx.x with the row block) besides its rows and column chunk:
// the distances of each staged tile of kWideTJ rows are summed over slabs of all the input
// dims, and dx is taken over the block's output dims alone.  dv and dos do not depend on
// the output slab, so only the blocks of the first slab (o0 = 0) accumulate and write them.
// need_dv and need_dos are arguments here, not template flags as in the tiers above: four
// flag instantiations of this tier took nvcc over a minute more.
constexpr int kWideTJ = 16;

template <int KT, int TC>
__global__ void __launch_bounds__(kRows)
kernel_bwd_fused_wide_f32(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
                          float* __restrict__ dv, float* __restrict__ dx_part, float* __restrict__ dos_part,
                          int n, int d, int t, bool need_dv, bool need_dos) {
    constexpr int kO = wide::kOutSlab;
    __shared__ float x1s[kRows * wide::kRowStride];
    __shared__ float x2s[kWideTJ * wide::kSlab];
    __shared__ float x2o[kWideTJ * kO];
    __shared__ __align__(16) float gs[kWideTJ * TC];
    __shared__ __align__(16) float vs[kWideTJ * TC];
    __shared__ float warp_sums[kRows / 32];

    const int row_blocks = (n + kRows - 1) / kRows;
    const int block = blockIdx.x % row_blocks;
    const int row0 = block * kRows;
    const int o0 = (blockIdx.x / row_blocks) * kO;
    const bool lead = o0 == 0;  // the output slab that also carries dv and dos
    const bool do_dv = need_dv && lead, do_dos = need_dos && lead;  // uniform over the block
    const int row = row0 + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;

    float xo[kO], dxa[kO];
#pragma unroll
    for (int k = 0; k < kO; ++k) {
        xo[k] = (row < n && o0 + k < d) ? x[(int64_t)row * d + o0 + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC], vi[TC], dva[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
        dva[c] = 0.0f;
    }
    float dos = 0.0f;

    for (int j0 = 0; j0 < n; j0 += kWideTJ) {
        float d2[kWideTJ];
        wide::sq_dist_tile<kRows, kWideTJ>(x, x, n, n, d, row0, j0, x1s, x2s, d2);
        wide::stage_slab<kO>(x, j0, n, d, o0, kWideTJ, kO, x2o);
        for (int idx = threadIdx.x; idx < kWideTJ * TC; idx += kRows) {
            const int jj = idx / TC, c = idx % TC;
            const int j = j0 + jj;
            const bool in = j < n && c0 + c < t;
            gs[idx] = in ? g[(int64_t)j * t + c0 + c] : 0.0f;
            vs[idx] = in ? v[(int64_t)j * t + c0 + c] : 0.0f;
        }
        __syncthreads();

        float tile_dx[kO];
#pragma unroll
        for (int k = 0; k < kO; ++k) tile_dx[k] = 0.0f;
        float tile_dos = 0.0f;
#pragma unroll
        for (int jj = 0; jj < kWideTJ; ++jj) {
            float kv, kp;
            kernel_fn_and_prime<KT>(d2[jj], kv, kp);
            if (j0 + jj == row) kp = 0.0f;
            float gv = 0.0f, vg = 0.0f;
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                gv = fmaf(gi[c], vs[jj * TC + c], gv);
                vg = fmaf(vi[c], gs[jj * TC + c], vg);
            }
            if (do_dv) {
#pragma unroll
                for (int c = 0; c < TC; ++c) dva[c] = fmaf(kv, gs[jj * TC + c], dva[c]);
            }
            const float w = kp * (gv + vg);
#pragma unroll
            for (int k = 0; k < kO; ++k) tile_dx[k] = fmaf(w, xo[k] - x2o[jj * kO + k], tile_dx[k]);
            tile_dos = fmaf(kv, gv, tile_dos);
        }
#pragma unroll
        for (int k = 0; k < kO; ++k) dxa[k] += tile_dx[k];
        dos += tile_dos;
    }

    if (row < n) {
#pragma unroll
        for (int k = 0; k < kO; ++k) {
            if (o0 + k < d) dx_part[((int64_t)chunk * n + row) * d + o0 + k] = 2.0f * dxa[k];
        }
        if (do_dv) {
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                if (c0 + c < t) dv[(int64_t)row * t + c0 + c] = dva[c];
            }
        }
    }
    if (do_dos) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dos += __shfl_down_sync(0xffffffffu, dos, off);
        if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = dos;
        __syncthreads();
        if (threadIdx.x == 0) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < kRows / 32; ++w) s += warp_sums[w];
            dos_part[(int64_t)chunk * row_blocks + block] = s;
        }
    }
}

struct Args {
    const float *x, *g, *v;
    float *dv, *dx_part, *dos_part;
    int n, d, t, num_chunks, num_blocks;
    cudaStream_t stream;
};

template <int KT, int DP, int TC, bool DV, bool DOS>
void launch(const Args& a) {
    const dim3 grid(a.num_blocks, a.num_chunks);
    kernel_bwd_fused_f32<KT, DP, TC, DV, DOS>
        <<<grid, kRows, 0, a.stream>>>(a.x, a.g, a.v, a.dv, a.dx_part, a.dos_part, a.n, a.d, a.t);
}

template <int KT, int DP, int TC>
void dispatch_flags(const Args& a, bool need_dv, bool need_dos) {
    if (need_dv && need_dos) launch<KT, DP, TC, true, true>(a);
    else if (need_dv) launch<KT, DP, TC, true, false>(a);
    else if (need_dos) launch<KT, DP, TC, false, true>(a);
    else launch<KT, DP, TC, false, false>(a);
}

template <int KT, int DP>
void dispatch_tc(const Args& a, bool need_dv, bool need_dos) {
    if (a.t == 1) dispatch_flags<KT, DP, 1>(a, need_dv, need_dos);
    else dispatch_flags<KT, DP, kTC>(a, need_dv, need_dos);
}

template <int KT, int TC>
void launch_wide(const Args& a, bool need_dv, bool need_dos) {
    const int out_slabs = (a.d + wide::kOutSlab - 1) / wide::kOutSlab;
    const dim3 grid(a.num_blocks * out_slabs, a.num_chunks);
    kernel_bwd_fused_wide_f32<KT, TC><<<grid, kRows, 0, a.stream>>>(a.x, a.g, a.v, a.dv, a.dx_part, a.dos_part, a.n,
                                                                    a.d, a.t, need_dv, need_dos);
}

template <int KT>
int dispatch_d(const Args& a, bool need_dv, bool need_dos) {
    if (a.d == 3) dispatch_tc<KT, 3>(a, need_dv, need_dos);
    else if (a.d <= 64) dispatch_tc<KT, 64>(a, need_dv, need_dos);
    else if (a.t == 1) launch_wide<KT, 1>(a, need_dv, need_dos);
    else launch_wide<KT, kTC>(a, need_dv, need_dos);
    return 0;
}

}  // namespace

// Launches the fused backward on `stream` and returns cudaGetLastError() (0 on success).
// x (n, d), g (n, t), v (n, t): float32, row-major, contiguous, on one device.
// Outputs: dv (n, t) if need_dv (else may be null); dx_part (num_chunks, n, d); dos_part
// (num_chunks, num_blocks) if need_dos (else may be null), where num_chunks = 1 for t = 1
// and ceil(t / 32) otherwise, and num_blocks = ceil(n / 128).  The caller sums dx_part
// over chunks and dos_part over everything.  Sizes that disagree are refused.
extern "C" int gp_kernel_bwd_fused_f32(const void* x, const void* g, const void* v, void* dv, void* dx_part,
                                       void* dos_part, int n, int d, int t, int kernel_type, int need_dv,
                                       int need_dos, int num_chunks, int num_blocks, void* stream) {
    if (n <= 0 || t <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const int want_chunks = t == 1 ? 1 : (t + kTC - 1) / kTC;
    const int want_blocks = (n + kRows - 1) / kRows;
    if (num_chunks != want_chunks || num_blocks != want_blocks || want_chunks > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    if ((need_dv && dv == nullptr) || (need_dos && dos_part == nullptr) || dx_part == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    const Args a{static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(v),
                 static_cast<float*>(dv), static_cast<float*>(dx_part), static_cast<float*>(dos_part),
                 n, d, t, num_chunks, num_blocks, static_cast<cudaStream_t>(stream)};
    const bool ndv = need_dv != 0, ndos = need_dos != 0;
    int rc;
    switch (kernel_type) {
        case kRBF: rc = dispatch_d<kRBF>(a, ndv, ndos); break;
        case kMatern05: rc = dispatch_d<kMatern05>(a, ndv, ndos); break;
        case kMatern15: rc = dispatch_d<kMatern15>(a, ndv, ndos); break;
        case kMatern25: rc = dispatch_d<kMatern25>(a, ndv, ndos); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    return (int)cudaGetLastError();
}
