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
// The K.V product is FP32 FMA on the CUDA cores for t <= 32 and t > 64, and 3xTF32 on the
// tensor cores for t in (32, 64] (periodic_matvec_tc, below; tc_common.cuh).
//
// Design of the FMA tiers (as csrc/kernel_matvec.cu): each thread owns one output row and
// TC output columns accumulated in registers.  A block of 128 threads owns 128 rows and one
// tile of TC columns (blockIdx.y) and walks over its slab of x2 and v in tiles of kTJ rows: the
// tile's half-angle tables are formed once per block as it is staged into shared memory
// (O(m d) sincospif per 128 rows, against O(128 m d) pair terms).  Sums: t = 1 and t > 64
// in two levels, each staged tile's kTJ terms summed apart and then added to the running
// sum, as the JAX kernel sums per block of rows j (o_ref += pv per _BM-row block); t <= 32
// (t = 20, a Lanczos block) in one, as kernel_matvec.cu chose (a second set of TC sums
// made that tier 40-60 % slower).  t > 64 (t = 100, the LOVE root) runs tiles of 32
// columns: one running float32 sum over 100k terms per column is what made the RBF
// kernel's smallest LOVE variances 90 % off float64.  Every output element is written
// once by one thread, without atomics: the result is deterministic.  Ragged n, m and t are
// masked: out-of-range x2 rows stage zero tables (K = 1) against zero v rows, so they add
// nothing.
//
// What bounds the FMA tiers on the H100: per (i, j) pair about 5 FP32 instructions per
// input dim, one MUFU exp, and TC FMAs with their shared-memory loads, so the FP32
// instruction rate, not memory.
//
// Strips, as in kernel_matvec.cu: the forecast's 2048-row cross-covariance products would
// fill 16-64 of the 132 SMs, so every tier takes a slab of the j range per blockIdx.z (rows
// j in [z L, min(m, (z + 1) L)), L a multiple of kSlabTile) and writes its own partial
// out[z, i, c], which the wrapper folds with torch.sum; the slab count comes from the grid
// and occupancy that gp_periodic_matvec_plan reports (ops/fused_kernels.py::product_slabs).
// Within a slab each tier keeps its sums, the tensor-core tier its three levels.  A
// 100k-row product takes one slab and runs each kernel's SLABS = false instance, the
// kernel without the split.  Known gap: each column tile recomputes K.  Tiers: DP
// input dims (periodic::dispatch_dp); column tiles of 1 and 32, and 64 on the tensor cores.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_common.cuh"
#include "tc_common.cuh"

namespace {

using periodic::half_angle;
using periodic::sin_diff;

constexpr int kRows = 128;  // threads per block = output rows per block
constexpr int kTJ = 64;     // x2 / v rows staged per shared-memory tile
// a slab of the j range is a multiple of this, and so of every tier's staged tile
constexpr int kSlabTile = kTJ;
static_assert(kSlabTile % tc::kTJ == 0, "slabs of whole tensor-core tiles");

// TILED: sum each staged tile's kTJ terms apart before adding them to the running sums
// (always so for TC = 1)
template <int DP, int TC, bool TILED, bool SLABS>
__global__ void __launch_bounds__(kRows)
periodic_matvec_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ w,
                    const float* __restrict__ v, float* __restrict__ out, int n, int m, int d, int t, int slab_len) {
    __shared__ float ss[kTJ * DP];
    __shared__ float cs[kTJ * DP];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int c0 = blockIdx.y * TC;
    if constexpr (SLABS) {  // this block's slab of the j range (blockIdx.z) as operands of
        // their own: rows of x2 and v from z L on, m of them at most L, its partial out[z]
        const int64_t j_slab = (int64_t)blockIdx.z * slab_len;
        x2 += j_slab * d;
        v += j_slab * t;
        out += (int64_t)blockIdx.z * n * t;
        m = min(m - (int)j_slab, slab_len);
    }

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

        float tile_sum = 0.0f;
        float tile[TILED ? TC : 1];
        if constexpr (TILED) {
#pragma unroll
            for (int c = 0; c < TC; ++c) tile[c] = 0.0f;
        }
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
            } else if constexpr (TILED) {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 b = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    tile[c] = fmaf(kv, b.x, tile[c]);
                    tile[c + 1] = fmaf(kv, b.y, tile[c + 1]);
                    tile[c + 2] = fmaf(kv, b.z, tile[c + 2]);
                    tile[c + 3] = fmaf(kv, b.w, tile[c + 3]);
                }
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
        if constexpr (TILED) {
#pragma unroll
            for (int c = 0; c < TC; ++c) acc[c] += tile[c];
        }
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int c = 0; c < TC; ++c) {
            if (c0 + c < t) out[(int64_t)row * t + c0 + c] = acc[c];
        }
    }
}

// The tensor-core tier's shared memory (dynamic): the V fragments; each thread's running
// sums (its 32 accumulator entries, thread-minor, so that a warp touches 32 consecutive
// words); the staged tile's half-angle tables (tc::kTJ rows of kRowStride floats); for
// DP > 4 the block's rows' tables (16 WARPS rows) and the DP weights.  A row's tables take
// 2 DP floats in 16-byte rows; past DP = 4 padded by 4 floats, so that the rows a
// quarter-warp reads fall in different banks.
template <int DP, int WARPS>
struct TcLayout {
    static constexpr int kRowStride = DP <= 4 ? (2 * DP + 3) / 4 * 4 : 2 * DP + 4;
    static constexpr int kAccFloats = tc::kNTiles * 4 * WARPS * 32;
    static constexpr int kFloats =
        kAccFloats + tc::kTJ * kRowStride + (DP <= 4 ? 0 : WARPS * 16 * kRowStride + DP);
    static constexpr size_t kBytes = sizeof(tc::VFrags) + sizeof(float) * kFloats;
};

// ---------------------------------------------------------------------------------------
// The tensor-core tier, t in (32, 64]: every training CG iteration of the periodic model
// (t = 1 + 63 probes).
//
// The layout of kernel_matvec.cu's kernel_matvec_tc, with other K elements: K_tile .
// V_tile per staged tile of tc::kTJ rows j in 3xTF32 on mma.sync.m16n8k8.  Each warp owns
// one m-tile of 16 rows and all 64 columns (8 n-tiles); for every 8-wide k-step over j, a
// lane forms the four K elements of its own A fragment (rows g and g + 8 with g = lane / 4,
// columns lane % 4 and lane % 4 + 4) as exp(-2 sum_k w_k sin_diff^2) from the half-angle
// tables of its two rows and of the staged rows j, splits each into hi and lo and runs
// three mma per n-tile.  K is thus formed once per block and never stored, and each K
// element is the FMA tiers' own (the same tables, sums and exp).  The half-angle tables of
// a row are interleaved (s_0, c_0, s_1, c_1, ...), so that one 16-byte shared load gives
// two input dims; the staged tile's tables are formed with sincospif as the tile is stored
// (O(m d) per block against O(16 WARPS m d) pair terms).  V is staged in
// B-fragment order, split into hi and lo once (tc::VStage); the next tile's x2 values and
// V entries are loaded into registers before the current tile's mma, so that the loads'
// latency hides behind the tensor cores (without it kernel_matvec_tc took twice as long).
// Sums in three levels: each staged tile's terms go into a fresh accumulator fragment,
// the tiles' sums into a block sum over kTcBlockTiles tiles (2048 rows j, the JAX kernel's
// _BM), and the block sums into the running one.  Rows of the periodic K hold thousands of
// entries near 1, so a running sum grows large and rounds at each step: with two levels,
// as kernel_matvec_tc sums, this kernel read 2.979e-06 of max |out| against float64 at
// 100k x 100k, t = 64 (H100 80GB HBM3, 700 W), more than twice the plain float32 version's
// 1.364e-06; with three, 6.308e-07.  The block sum cannot live in the mma's accumulators:
// summed there over a block's 768 mma, the error read 1.050e-05.  No atomics and a fixed
// order: deterministic.  Ragged n, m and t are masked as in the FMA tiers (zero tables and
// zero V entries).
//
// Occupancy: two blocks an SM (at most 128 registers a thread at 8 warps).  The running
// sums live in shared memory, each thread's own 32 entries touched once per block of
// tiles, so that the third level takes no registers: with them in registers the kernel
// took 178 registers, one block an SM and 43.2 ms at 100k x 100k, t = 64; forced to 128 it
// spilled and took 35.0 ms; two levels in 128 registers took 32.2 ms.
//
// Tiers: for DP <= 4 (the path's d = 2) each lane holds its two rows' tables and the
// weights in registers, with 8 warps (128 rows) a block.  For DP = 16 and 64 the block's
// rows' tables and the weights are staged in shared memory, with 4 warps (64 rows), and the
// dims are walked to d (rounded up to 2), not to DP.  Shared memory (TcLayout): 16 KB of V
// fragments, the running sums (32 KB at 8 warps), and the tables: 82 KB at DP = 64, past
// the 48 KB of static shared memory, so every tier takes it as dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize set where it passes 48 KB).
//
// What bounds it on the H100: 3 passes of 2t operations per pair on the tensor cores (7.8
// ms at 100k x 100k, t = 64, at the dense TF32 peak of 495 TFLOP/s), against about 6d + 2
// FP32 operations and one exp per pair on the CUDA cores (2.1 ms at d = 2 at 67 TFLOP/s).
constexpr int kTcBlockTiles = 64;  // staged tiles per block sum: 2048 rows j

template <int DP, int WARPS, bool SLABS>
__global__ void __launch_bounds__(WARPS * 32, 2)
periodic_matvec_tc(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ w,
                   const float* __restrict__ v, float* __restrict__ out, int n, int m, int d, int t, int slab_len) {
    constexpr int kThreads = WARPS * 32;
    constexpr int kBRows = WARPS * 16;
    constexpr bool kRegX1 = DP <= 4;
    constexpr int TS = TcLayout<DP, WARPS>::kRowStride;
    constexpr int kXsPer = (tc::kTJ * DP + kThreads - 1) / kThreads;  // x2 values per thread per tile
    extern __shared__ __align__(16) unsigned char smem[];
    tc::VFrags& vf = *reinterpret_cast<tc::VFrags*>(smem);
    float* accs = reinterpret_cast<float*>(smem + sizeof(tc::VFrags));  // the running sums
    float* xs = accs + TcLayout<DP, WARPS>::kAccFloats;                 // the staged rows j' tables
    float* x1s = xs + tc::kTJ * TS;                                     // the block's rows' (DP > 4)
    float* ws = x1s + (kRegX1 ? 0 : kBRows * TS);                       // the weights (DP > 4)

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int lrow = (threadIdx.x >> 5) * 16 + g;  // this lane's first row within the block
    const int row0 = blockIdx.x * kBRows;
    const int c0 = blockIdx.y * tc::kCols;
    if constexpr (SLABS) {  // this block's slab of the j range (blockIdx.z) as operands of
        // their own: rows of x2 and v from z L on, m of them at most L, its partial out[z]
        const int64_t j_slab = (int64_t)blockIdx.z * slab_len;
        x2 += j_slab * d;
        v += j_slab * t;
        out += (int64_t)blockIdx.z * n * t;
        m = min(m - (int)j_slab, slab_len);
    }

    // this lane's rows row0 + lrow + 8 h (h = 0, 1): their tables (s, c) and the weights
    float sr[2][kRegX1 ? DP : 1], cr[2][kRegX1 ? DP : 1], wk[kRegX1 ? DP : 1];
    if constexpr (kRegX1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                sr[h][k] = 0.0f;
                cr[h][k] = 0.0f;
                if (r < n && k < d) half_angle(x1[(int64_t)r * d + k], sr[h][k], cr[h][k]);
            }
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) wk[k] = k < d ? w[k] : 0.0f;
    } else {
        for (int idx = threadIdx.x; idx < kBRows * DP; idx += kThreads) {
            const int r = idx / DP, k = idx % DP;
            float s = 0.0f, c = 0.0f;
            if (row0 + r < n && k < d) half_angle(x1[(int64_t)(row0 + r) * d + k], s, c);
            x1s[r * TS + 2 * k] = s;
            x1s[r * TS + 2 * k + 1] = c;
        }
        for (int k = threadIdx.x; k < DP; k += kThreads) ws[k] = k < d ? w[k] : 0.0f;
    }
    // the sums of the current block of kTcBlockTiles staged tiles, in registers; the
    // running sums in shared memory (each thread's own entries: no barrier needed), where
    // they take no registers from the 128 that two blocks an SM leave a thread
    float blk[tc::kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            blk[nt][r] = 0.0f;
            accs[(4 * nt + r) * kThreads + threadIdx.x] = 0.0f;
        }
    }

    // the next tile's V entries and x2 values, in registers until the tile is stored; the
    // x2 values become half-angle tables as they are stored (zero tables past m and d)
    tc::VStage<kThreads> vstage;
    float px[kXsPer];
    auto fetch = [&](int j0) {
        vstage.fetch(v, m, t, j0, c0);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / DP, k = idx % DP;
            px[i] = (idx < tc::kTJ * DP && j0 + jj < m && k < d) ? x2[(int64_t)(j0 + jj) * d + k] : 0.0f;
        }
    };
    auto store = [&](int j0) {
        vstage.store(vf);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / DP, k = idx % DP;
            if (idx < tc::kTJ * DP) {
                float s = 0.0f, c = 0.0f;
                if (j0 + jj < m && k < d) half_angle(px[i], s, c);
                xs[jj * TS + 2 * k] = s;
                xs[jj * TS + 2 * k + 1] = c;
            }
        }
    };
    fetch(0);
    for (int j0 = 0, tiles = 1; j0 < m; j0 += tc::kTJ, ++tiles) {
        store(j0);
        __syncthreads();
        if (j0 + tc::kTJ < m) fetch(j0 + tc::kTJ);

        float tile[tc::kNTiles][4];
#pragma unroll
        for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) tile[nt][r] = 0.0f;
        }
#pragma unroll
        for (int s = 0; s < tc::kSteps; ++s) {
            // A fragment: a[h + 2 c] = K(row g + 8 h, column q + 4 c) of the k-step, from
            // qs[h + 2 c] = sum_k w_k sin_diff^2, summed over k in order as the FMA tiers do
            const int jrow[2] = {8 * s + q, 8 * s + q + 4};
            float qs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if constexpr (kRegX1) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
#pragma unroll
                    for (int k4 = 0; k4 < 2 * DP; k4 += 4) {
                        const float4 b = *reinterpret_cast<const float4*>(&xs[jrow[c] * TS + k4]);
                        const float bk[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
#pragma unroll
                            for (int kk = 0; kk < 2; ++kk) {
                                const int k = k4 / 2 + kk;
                                if (k < DP) {
                                    const float sd = sin_diff(sr[h][k], cr[h][k], bk[2 * kk], bk[2 * kk + 1]);
                                    qs[h + 2 * c] = fmaf(wk[k] * sd, sd, qs[h + 2 * c]);
                                }
                            }
                        }
                    }
                }
            } else {
                // the dims to d rounded up to 2 (a 16-byte load holds two dims), not to DP
                const float* ar[2] = {&x1s[lrow * TS], &x1s[(lrow + 8) * TS]};
#pragma unroll 2
                for (int k4 = 0; k4 < 2 * (d + (d & 1)); k4 += 4) {
                    const float2 w2 = *reinterpret_cast<const float2*>(&ws[k4 / 2]);
                    const float wv[2] = {w2.x, w2.y};
                    float4 a4[2], b4[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) a4[h] = *reinterpret_cast<const float4*>(ar[h] + k4);
#pragma unroll
                    for (int c = 0; c < 2; ++c) b4[c] = *reinterpret_cast<const float4*>(&xs[jrow[c] * TS + k4]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const float ak[4] = {a4[h].x, a4[h].y, a4[h].z, a4[h].w};
                            const float bk[4] = {b4[c].x, b4[c].y, b4[c].z, b4[c].w};
#pragma unroll
                            for (int kk = 0; kk < 2; ++kk) {
                                const float sd = sin_diff(ak[2 * kk], ak[2 * kk + 1], bk[2 * kk], bk[2 * kk + 1]);
                                qs[h + 2 * c] = fmaf(wv[kk] * sd, sd, qs[h + 2 * c]);
                            }
                        }
                    }
                }
            }
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) tc::split_tf32(__expf(-2.0f * qs[e]), ahi[e], alo[e]);
#pragma unroll
            for (int nt = 0; nt < tc::kNTiles; ++nt) {
                const uint4 b = *reinterpret_cast<const uint4*>(vf[s][nt][lane]);
                tc::mma_tf32(tile[nt], alo, b.x, b.y);  // A_lo B_hi
                tc::mma_tf32(tile[nt], ahi, b.z, b.w);  // A_hi B_lo
                tc::mma_tf32(tile[nt], ahi, b.x, b.y);  // A_hi B_hi
            }
        }
        const bool block_end = tiles % kTcBlockTiles == 0 || j0 + tc::kTJ >= m;
#pragma unroll
        for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                blk[nt][r] += tile[nt][r];
                if (block_end) {
                    accs[(4 * nt + r) * kThreads + threadIdx.x] += blk[nt][r];
                    blk[nt][r] = 0.0f;
                }
            }
        }
        __syncthreads();
    }

    // C fragment: c[2 h + e] = out(row g + 8 h, column 2 q + e) of the n-tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row0 + lrow + 8 * h;
        if (r >= n) continue;
#pragma unroll
        for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = c0 + 8 * nt + 2 * q + e;
                if (c < t) out[(int64_t)r * t + c] = accs[(4 * nt + 2 * h + e) * kThreads + threadIdx.x];
            }
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
static_assert(kSlabTile % kWideTJ == 0, "slabs of whole wide-tier tiles");

template <int TC, bool SLABS>
__global__ void __launch_bounds__(kRows)
periodic_matvec_wide_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ w,
                         const float* __restrict__ v, float* __restrict__ out, int n, int m, int d, int t,
                         int slab_len) {
    __shared__ float s1[kRows * kWideStride];
    __shared__ float c1[kRows * kWideStride];
    __shared__ float s2[kWideTJ * kWideSlab];
    __shared__ float c2[kWideTJ * kWideSlab];
    __shared__ float ws[kWideSlab];
    __shared__ __align__(16) float vs[kWideTJ * TC];

    const int row0 = blockIdx.x * kRows;
    const int row = row0 + threadIdx.x;
    const int c0 = blockIdx.y * TC;
    if constexpr (SLABS) {  // this block's slab of the j range (blockIdx.z) as operands of
        // their own: rows of x2 and v from z L on, m of them at most L, its partial out[z]
        const int64_t j_slab = (int64_t)blockIdx.z * slab_len;
        x2 += j_slab * d;
        v += j_slab * t;
        out += (int64_t)blockIdx.z * n * t;
        m = min(m - (int)j_slab, slab_len);
    }
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

// A launch's operands: out is (num_slabs, n, t), one partial per slab of slab_len rows j.
// With `plan` set, the dispatch below launches nothing and reports the grid of the tier it
// would launch instead (Plan), from which the wrapper chooses the slab count.
struct Plan {
    int row_blocks, chunks;
    int blocks_per_sm;  // of this tier's kernel, by its registers and shared memory
    int slab_tile;      // rows j: a slab is a multiple of it
};

struct Args {
    const float *x1, *x2, *w, *v;
    float* out;
    int n, m, d, t, num_slabs, slab_len;
    cudaStream_t stream;
    Plan* plan;
};

using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, int, int, int, int, int);

// launches a tier on blocks of `rows` rows and `cols` columns by the slabs (`slabbed`, its
// SLABS = true instance, or `whole` for one slab), or plans it
cudaError_t run(const Args& a, Kernel slabbed, Kernel whole, int rows, int cols, int threads, size_t smem) {
    const dim3 grid((a.n + rows - 1) / rows, (a.t + cols - 1) / cols, a.num_slabs);
    if (a.plan) {
        *a.plan = Plan{(int)grid.x, (int)grid.y, 0, kSlabTile};
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.plan->blocks_per_sm, slabbed, threads, smem);
    }
    const Kernel kernel = a.num_slabs > 1 ? slabbed : whole;
    kernel<<<grid, threads, smem, a.stream>>>(a.x1, a.x2, a.w, a.v, a.out, a.n, a.m, a.d, a.t, a.slab_len);
    return cudaSuccess;
}

template <int TC>
cudaError_t launch_wide(const Args& a) {
    return run(a, periodic_matvec_wide_f32<TC, true>, periodic_matvec_wide_f32<TC, false>, kRows, TC, kRows, 0);
}

template <int DP, int TC, bool TILED = false>
cudaError_t launch(const Args& a) {
    return run(a, periodic_matvec_f32<DP, TC, TILED, true>, periodic_matvec_f32<DP, TC, TILED, false>, kRows, TC,
               kRows, 0);
}

// the tensor-core tier's blocks: 8 warps (128 rows) with the rows' tables in registers
// (DP <= 4), 4 warps (64 rows) with them staged (DP = 16, 64), as kernel_matvec.cu's launch_tc
template <int DP>
cudaError_t launch_tc(const Args& a) {
    constexpr int kWarps = DP <= 4 ? 8 : 4;
    constexpr size_t kBytes = TcLayout<DP, kWarps>::kBytes;
    const Kernel slabbed = periodic_matvec_tc<DP, kWarps, true>, whole = periodic_matvec_tc<DP, kWarps, false>;
    if constexpr (kBytes > 48 * 1024) {
        cudaError_t rc = cudaFuncSetAttribute(slabbed, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
        if (rc == cudaSuccess) rc = cudaFuncSetAttribute(whole, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
        if (rc != cudaSuccess) return rc;
    }
    return run(a, slabbed, whole, kWarps * 16, tc::kCols, kWarps * 32, kBytes);
}

template <int DP>
cudaError_t dispatch_tc(const Args& a) {
    if (a.t == 1) return launch<DP, 1>(a);
    if (a.t <= 32) return launch<DP, 32>(a);
    if (a.t <= 64) return launch_tc<DP>(a);
    return launch<DP, 32, true>(a);
}

cudaError_t dispatch(const Args& a) {
    if (a.d > periodic::kMaxDP) return a.t == 1 ? launch_wide<1>(a) : launch_wide<32>(a);
    cudaError_t rc = cudaSuccess;
    periodic::dispatch_dp(a.d, [&](auto dp) { rc = dispatch_tc<decltype(dp)::value>(a); });
    return rc;
}

bool valid_sizes(int n, int m, int d, int t) { return n > 0 && t > 0 && m >= 0 && d > 0 && (t + 31) / 32 <= 65535; }

}  // namespace

// Launches the periodic matvec on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), w (d,), v (m, t): float32, row-major, contiguous, on one device;
// any d >= 1.  out (num_slabs, n, t): slab s covers rows j of x2 in [s L, (s + 1) L) with
// L = ceil(m / num_slabs) rounded up to a multiple of 64 (a slab past m writes zeros); the
// caller sums out over its first axis (num_slabs = 1: out is the product itself).  Sizes
// that the grid cannot hold are refused.
extern "C" int gp_periodic_matvec_f32(const void* x1, const void* x2, const void* w, const void* v, void* out,
                                      int n, int m, int d, int t, int num_slabs, void* stream) {
    if (!valid_sizes(n, m, d, t)) return (int)cudaErrorInvalidValue;
    if (num_slabs < 1 || num_slabs > 65535 || num_slabs > (m > 0 ? m : 1)) return (int)cudaErrorInvalidValue;
    const int per_slab = (m + num_slabs - 1) / num_slabs;
    const Args a{static_cast<const float*>(x1), static_cast<const float*>(x2), static_cast<const float*>(w),
                 static_cast<const float*>(v), static_cast<float*>(out), n, m, d, t, num_slabs,
                 (per_slab + kSlabTile - 1) / kSlabTile * kSlabTile, static_cast<cudaStream_t>(stream), nullptr};
    const cudaError_t rc = dispatch(a);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// The grid of the tier that gp_periodic_matvec_f32 launches at these sizes, on the current
// device: plan[0..3] = row blocks, column chunks, the tier's blocks that fit on an SM at
// once, and the staged tile of rows j that a slab is a multiple of.  Returns 0 on success.
extern "C" int gp_periodic_matvec_plan(int n, int d, int t, int* plan) {
    if (!valid_sizes(n, 0, d, t)) return (int)cudaErrorInvalidValue;
    Plan p{};
    const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, n, 0, d, t, 1, 0, nullptr, &p};
    const cudaError_t rc = dispatch(a);
    if (rc != cudaSuccess) return (int)rc;
    plan[0] = p.row_blocks;
    plan[1] = p.chunks;
    plan[2] = p.blocks_per_sm;
    plan[3] = p.slab_tile;
    return 0;
}
