// Fused symmetric backward of the periodic-kernel product on Hopper.
//
// For out = K(a, a) v with K_ij = exp(-2 sum_k w_k sin^2(pi (a_ik - a_jk))) and an output
// cotangent g, one pass over the (i, j) pairs gives, with the score
// GG_ij = g_i . v_j + v_i . g_j, S_ijk = sin(pi (a_ik - a_jk)) and C_ijk = cos(pi (a_ik - a_jk)),
//   dx_raw[i, k]  = sum_j K_ij GG_ij S_ijk C_ijk
//   dw_raw[i, k]  = sum_j K_ij GG_ij S_ijk^2
//   dos_raw[i]    = sum_j K_ij GG_ij                    (if need_dos)
// and the wrapper applies the constant factors: dx = -4 pi w_k dx_raw (the cotangent of a,
// both operand slots, since x1 and x2 are one tensor; 2 S C = sin(2 pi (a_i - a_j))),
// dw_k = -sum_i dw_raw[i, k] (the cotangent of w) and dos = sum_i dos_raw[i] / 2 (the
// cotangent of an outputscale that multiplies K).  K and S^2 are symmetric in (i, j), so
// sum_ij K (g_i . v_j) S^2, the TPU kernel's dw / -2, is half of sum_ij K GG S^2, and
// sum_ij K (g_i . v_j) half of sum_ij K GG: every output is a sum of one score a pair.
// The cotangent of v, K g, is not formed here: where it is asked for, the wrapper launches
// the product kernel (kernel_periodic_matvec.cu) on g.
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_periodic_bwd_fused_pallas (the backward of
// every mBCG training step of a periodic exact GP, which asks for dx, dw and dos, not dv:
// the outputscale is an operand of its own, ops/periodic_kernels.py).  The TPU kernel forms
// per-pair sines for K and reduces dx and dw through full-angle tables and the identity
// sin^2 = (1 - c_i c_j - s_i s_j) / 2, which cancels near the diagonal.  Here S and C come
// from per-point half-angle tables, S = s_i c_j - c_i s_j and C = c_i c_j + s_i s_j with
// s, c = sin, cos(pi (a - rint(a))) (see periodic_common.cuh): no cancellation of O(1)
// terms, no large-argument rounding, and S = 0 exactly for equal points.  The TPU kernel's
// (BN, bm) tiles, sub-blocks, lane padding and its 128-lane aux output are not carried over.
//
// Every output is a per-row partial, (chunks, n, d) for dx_raw and dw_raw and (chunks, n)
// for dos_raw, which the wrapper folds with torch.sum.  No atomics: the result is
// deterministic.  Ragged n and t are masked by staging zeros (a zero g and v row adds
// nothing) and by not storing rows and columns out of range.  Tiers: DP input dims
// (periodic::dispatch_dp), d <= 64 as in the JAX package; t in (32, 64] on the tensor
// cores (periodic_bwd_tc), every other t on the FMA tier (periodic_bwd_fma).
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_common.cuh"
#include "tc_common.cuh"

namespace {

using periodic::half_angle;
using periodic::sin_diff;

constexpr int kRows = 128;  // FMA tiers: threads per block = rows i per block
constexpr int kTJ = 32;     // FMA tiers: rows j staged per shared-memory tile
constexpr int kTC = 32;     // FMA tiers: columns per chunk when t > 1

// ---------------------------------------------------------------------------------------
// The FMA tiers: t = 1, t <= 32 and t > 64.
//
// One thread owns one row i and keeps its tables, g_i, v_i and its dx, dw and dos
// accumulators in registers.  A block of 128 threads owns 128 rows and one chunk of TC
// columns (blockIdx.y), and walks over all rows j in tiles of kTJ staged in shared memory
// (the tile's tables formed once per block as it is staged).  Columns are chunked at 32:
// dx, dw and dos add across chunks, so each chunk writes its own partials.  dx, dw and dos
// are summed per staged tile and then added to the running sums.  Per pair and chunk of 32
// columns: 64 FMAs for g_i . v_j and v_i . g_j, one exp, and about 15 FP32 instructions
// per input dim.
template <int DP, int TC>
__global__ void __launch_bounds__(kRows)
periodic_bwd_fma(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ g,
                 const float* __restrict__ v, float* __restrict__ dx_part, float* __restrict__ dw_part,
                 float* __restrict__ dos_part, int n, int d, int t) {
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
    float dosa = 0.0f;
    float gi[TC], vi[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
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

        float tile_dx[DP], tile_dw[DP], tile_dos = 0.0f;
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
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; ++c) {
                    const float vj = vs[jj * TC + c], gj = gs[jj * TC + c];
                    gv = fmaf(gi[c], vj, gv);
                    vg = fmaf(vi[c], gj, vg);
                }
            }
            const float gg = kv * gv + kv * vg;  // K GG
            tile_dos += gg;
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                const float cd = fmaf(ci[k], cs[jj * DP + k], si[k] * ss[jj * DP + k]);
                tile_dx[k] = fmaf(gg, sd[k] * cd, tile_dx[k]);
                tile_dw[k] = fmaf(gg, sd[k] * sd[k], tile_dw[k]);
            }
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            dxa[k] += tile_dx[k];
            dwa[k] += tile_dw[k];
        }
        dosa += tile_dos;
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
        if (dos_part != nullptr) dos_part[(int64_t)chunk * n + row] = dosa;
    }
}

// ---------------------------------------------------------------------------------------
// The tensor-core tier, t in (32, 64]: every training step of the periodic model (t = 1 +
// 63 probes; dx, dw and dos).
//
// The score tile.  Each warp owns one m-tile of 16 rows i; for every staged tile of tc::kTJ
// rows j it forms GG for its 16 x 32 pairs as one product of depth 128,
// [g_i | v_i] . [v_j | g_j], in 3xTF32 on mma.sync.m16n8k8 (16 k-steps x 4 n-tiles x 3
// passes): the block's rows' operand staged once in shared memory as floats in A-fragment
// order and split per k-step, the tile's operand split into hi and lo once as it is staged,
// in B-fragment order (tc_common.cuh).  Each k-step's three mma go into a fresh fragment
// that is added to the scores in FP32: the tensor cores' accumulation is not IEEE-rounded,
// and one chain of 48 mma through the accumulators read 2.0-2.3 times the plain float32
// version's error in dx against float64 at 100k x 100k (chains of 4 k-steps: 2.2 times in
// dos), one k-step a chain 0.79-1.20 times in dx, dw and dos (H100 80GB HBM3, 700 W;
// PERF.md).  The scores land in
// the accumulator fragments:
// c[nt][2 h + e] pairs row g + 8 h of the m-tile (g = lane / 4) with staged row
// 8 nt + 2 q + e (q = lane % 4).  K is never an mma operand (forming dv = K g on the tensor
// cores would need K in A-fragment order, built a second time), so each K element is
// formed once per pair, at the accumulator's own position, on the CUDA cores, with the FMA
// tier's arithmetic (the tables, sin_diff, the k sum in order, __expf).  Then each lane
// sums K GG, K GG S C and K GG S^2 over its 8 pairs of each of its two rows, the quad (the
// four lanes of a row) adds its sums with two shuffles, and its first lane adds them to the
// row's sums in shared memory.  The next tile's rows are loaded into registers before the
// current tile's mma, as in kernel_periodic_matvec.cu's periodic_matvec_tc.
//
// Sums in three levels, as periodic_matvec_tc's: each staged tile's (32 rows j), a block
// sum over kTcBlockTiles tiles (2048 rows j, the JAX kernel's _BM), and the running sum.
// Rows of the periodic K hold thousands of entries near 1, and with two levels the forward
// read twice the plain float32 version's error from float64 (PERF.md).  The block
// and running sums live in shared memory, each row's slots written by one lane only, so no
// barrier orders them and they take no registers.
//
// Tiers: for DP <= 4 (the path's d = 2) each lane holds its two rows' tables and the
// weights in registers, with 8 warps (128 rows) a block and two blocks an SM (at most 128
// registers a thread; 102 KB of shared memory a block).  For DP = 16 and 64 the block's rows'
// tables and the weights are staged in shared memory and the dims are walked to d, with 4
// warps (64 rows) a block.  Every tier takes dynamic shared memory (BwdTcLayout).
//
// What bounds it on the H100: 3 passes of 2 x 2t operations per pair on the tensor cores
// (15.5 ms at 100k x 100k, t = 64, at the dense TF32 peak of 495 TFLOP/s), against about
// 15d + 4 FP32 operations and one exp per pair on the CUDA cores (5.1 ms at d = 2 at 67
// TFLOP/s); the FP32 bound of the same work is 43.3 ms.  It took 72.6 ms there (the FMA
// kernel it replaces, which also formed dv, 127 ms; H100 80GB HBM3, 700 W): the score's
// mma run at about 106 TFLOP/s, under the products' 140 with their 8 n-tiles a warp
// against these 4.
constexpr int kTcBlockTiles = 64;  // staged tiles per block sum: 2048 rows j

// The tensor-core tier's shared memory: the tile's B fragments; each warp's A fragments;
// the rows' block and running sums (dx_raw, dw_raw, dos_raw: 2 DP + 1 floats a row); the
// staged rows' half-angle tables (tc::kTJ rows of kRowStride floats); for DP > 4 the
// block's rows' tables and the DP weights.  A row's tables are interleaved (s_0, c_0, s_1,
// c_1, ...) in 16-byte rows, past DP = 4 padded by 4 floats, as in periodic_matvec_tc.
template <int DP, int WARPS>
struct BwdTcLayout {
    static constexpr int kRowStride = DP <= 4 ? (2 * DP + 3) / 4 * 4 : 2 * DP + 4;
    static constexpr int kSumStride = 2 * DP + 1;
    static constexpr int kRowsB = WARPS * 16;
    static constexpr int kFloats =
        2 * kRowsB * kSumStride + tc::kTJ * kRowStride + (DP <= 4 ? 0 : kRowsB * kRowStride + DP);
    static constexpr size_t kBytes = sizeof(tc::ScoreBFrags) + WARPS * sizeof(tc::ScoreAFrags) + sizeof(float) * kFloats;
};

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 2)
periodic_bwd_tc(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ g,
                const float* __restrict__ v, float* __restrict__ dx_part, float* __restrict__ dw_part,
                float* __restrict__ dos_part, int n, int d, int t, bool vec) {
    using Layout = BwdTcLayout<DP, WARPS>;
    constexpr int kThreads = WARPS * 32;
    constexpr int kBRows = Layout::kRowsB;
    constexpr bool kRegX = DP <= 4;
    constexpr int TS = Layout::kRowStride, SS = Layout::kSumStride;
    constexpr int kXsPer = (tc::kTJ * DP + kThreads - 1) / kThreads;  // x values per thread per tile
    extern __shared__ __align__(16) unsigned char smem[];
    tc::ScoreBFrags& bf = *reinterpret_cast<tc::ScoreBFrags*>(smem);
    tc::ScoreAFrags* af = reinterpret_cast<tc::ScoreAFrags*>(smem + sizeof(tc::ScoreBFrags));
    float* blk = reinterpret_cast<float*>(smem + sizeof(tc::ScoreBFrags) + WARPS * sizeof(tc::ScoreAFrags));
    float* run = blk + kBRows * SS;     // the running sums
    float* xs = run + kBRows * SS;      // the staged rows j's tables
    float* xis = xs + tc::kTJ * TS;     // the block's rows' (DP > 4)
    float* ws = xis + (kRegX ? 0 : kBRows * TS);  // the weights (DP > 4)

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int lrow = warp * 16 + (lane >> 2);  // this lane's first row within the block
    const int row0 = blockIdx.x * kBRows;

    // this lane's rows row0 + lrow + 8 h (h = 0, 1): their tables (s, c) and the weights
    float sr[2][kRegX ? DP : 1], cr[2][kRegX ? DP : 1], wk[kRegX ? DP : 1];
    if constexpr (kRegX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                sr[h][k] = 0.0f;
                cr[h][k] = 0.0f;
                if (r < n && k < d) half_angle(x[(int64_t)r * d + k], sr[h][k], cr[h][k]);
            }
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) wk[k] = k < d ? w[k] : 0.0f;
    } else {
        for (int idx = threadIdx.x; idx < kBRows * DP; idx += kThreads) {
            const int r = idx / DP, k = idx % DP;
            float s = 0.0f, c = 0.0f;
            if (row0 + r < n && k < d) half_angle(x[(int64_t)(row0 + r) * d + k], s, c);
            xis[r * TS + 2 * k] = s;
            xis[r * TS + 2 * k + 1] = c;
        }
        for (int k = threadIdx.x; k < DP; k += kThreads) ws[k] = k < d ? w[k] : 0.0f;
    }
    tc::stage_score_a<WARPS, kThreads>(af, g, v, n, t, row0);
    for (int idx = threadIdx.x; idx < 2 * kBRows * SS; idx += kThreads) blk[idx] = 0.0f;  // blk and run

    // (s, c) of dim k of this lane's row h, and of staged row jj
    auto itab = [&](int h, int k) -> float2 {
        if constexpr (kRegX) return make_float2(sr[h][k], cr[h][k]);
        else return *reinterpret_cast<const float2*>(&xis[(lrow + 8 * h) * TS + 2 * k]);
    };
    auto jtab = [&](int jj, int k) -> float2 { return *reinterpret_cast<const float2*>(&xs[jj * TS + 2 * k]); };
    auto weight = [&](int k) -> float {
        if constexpr (kRegX) return wk[k];
        else return ws[k];
    };
    // f(k) for every input dim: to DP (unrolled, zero tables past d) or to d
    auto for_dims = [&](auto&& f) {
        if constexpr (kRegX) {
#pragma unroll
            for (int k = 0; k < DP; ++k) f(k);
        } else {
            for (int k = 0; k < d; ++k) f(k);
        }
    };

    // the next tile's [v_j | g_j] and x values, in registers until the tile is stored; the
    // x values become half-angle tables as they are stored (zero tables past n and d)
    tc::ScoreBStage<kThreads> bstage;
    float px[kXsPer];
    auto fetch = [&](int j0) {
        bstage.fetch(g, v, n, t, j0, vec);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / DP, k = idx % DP;
            px[i] = (idx < tc::kTJ * DP && j0 + jj < n && k < d) ? x[(int64_t)(j0 + jj) * d + k] : 0.0f;
        }
    };
    auto store = [&](int j0) {
        bstage.store(bf);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / DP, k = idx % DP;
            if (idx < tc::kTJ * DP) {
                float s = 0.0f, c = 0.0f;
                if (j0 + jj < n && k < d) half_angle(px[i], s, c);
                xs[jj * TS + 2 * k] = s;
                xs[jj * TS + 2 * k + 1] = c;
            }
        }
    };
    // the quad's first lane adds a tile sum of its row h to the row's block sum in slot k
    auto add_tile = [&](int h, int slot, float tile_sum) {
        tile_sum = quad_sum(tile_sum);
        if (q == 0) blk[(lrow + 8 * h) * SS + slot] += tile_sum;
    };

    fetch(0);
    for (int j0 = 0, tiles = 1; j0 < n; j0 += tc::kTJ, ++tiles) {
        store(j0);
        __syncthreads();
        if (j0 + tc::kTJ < n) fetch(j0 + tc::kTJ);

        // the scores GG of the warp's 16 rows against the tile's 32 rows j: each k-step's
        // three mma go into a fresh fragment, which is added to the scores in FP32
        float acc[tc::kJTiles][4];
#pragma unroll
        for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
        }
#pragma unroll 1
        for (int s = 0; s < tc::kScoreSteps; ++s) {
            uint32_t ahi[4], alo[4];
            tc::split_a(af[warp][s][lane], ahi, alo);
            float part[tc::kJTiles][4];
#pragma unroll
            for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
                for (int r = 0; r < 4; ++r) part[nt][r] = 0.0f;
            }
#pragma unroll
            for (int nt = 0; nt < tc::kJTiles; ++nt) {
                const uint4 b = *reinterpret_cast<const uint4*>(bf[s][nt][lane]);
                tc::mma_tf32(part[nt], alo, b.x, b.y);  // A_lo B_hi
                tc::mma_tf32(part[nt], ahi, b.z, b.w);  // A_hi B_lo
                tc::mma_tf32(part[nt], ahi, b.x, b.y);  // A_hi B_hi
            }
#pragma unroll
            for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[nt][r] += part[nt][r];
            }
        }

        // K GG at each accumulator's pair, from q = sum_k w_k sin_diff^2 summed over k in
        // order, as the FMA tier does
#pragma unroll
        for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int jj = 8 * nt + 2 * q + e;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float qs = 0.0f;
                    for_dims([&](int k) {
                        const float2 a = itab(h, k), b = jtab(jj, k);
                        const float sd = sin_diff(a.x, a.y, b.x, b.y);
                        qs = fmaf(weight(k) * sd, sd, qs);
                    });
                    acc[nt][2 * h + e] *= __expf(-2.0f * qs);
                }
            }
        }
        // the tile's sums of each row: dos_raw in slot 2 DP, then dx_raw and dw_raw per dim
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float sum = 0.0f;
#pragma unroll
            for (int nt = 0; nt < tc::kJTiles; ++nt) sum += acc[nt][2 * h] + acc[nt][2 * h + 1];
            add_tile(h, 2 * DP, sum);
        }
        for_dims([&](int k) {
            float tdx[2] = {0.0f, 0.0f}, tdw[2] = {0.0f, 0.0f};
#pragma unroll
            for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float2 b = jtab(8 * nt + 2 * q + e, k);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float2 a = itab(h, k);
                        const float sd = sin_diff(a.x, a.y, b.x, b.y);
                        const float cd = fmaf(a.y, b.y, a.x * b.x);
                        const float kg = acc[nt][2 * h + e];
                        tdx[h] = fmaf(kg, sd * cd, tdx[h]);
                        tdw[h] = fmaf(kg, sd * sd, tdw[h]);
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                add_tile(h, k, tdx[h]);
                add_tile(h, DP + k, tdw[h]);
            }
        });
        // the block sums into the running ones, by the lane that owns them
        if ((tiles % kTcBlockTiles == 0 || j0 + tc::kTJ >= n) && q == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = (lrow + 8 * h) * SS;
                for (int slot = 0; slot < SS; ++slot) {
                    run[r + slot] += blk[r + slot];
                    blk[r + slot] = 0.0f;
                }
            }
        }
        __syncthreads();
    }

    if (q == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
            if (r >= n) continue;
            const float* sums = &run[(lrow + 8 * h) * SS];
            for (int k = 0; k < d; ++k) {
                dx_part[(int64_t)r * d + k] = sums[k];
                dw_part[(int64_t)r * d + k] = sums[DP + k];
            }
            if (dos_part != nullptr) dos_part[r] = sums[2 * DP];
        }
    }
}

struct Args {
    const float *x, *w, *g, *v;
    float *dx_part, *dw_part, *dos_part;
    int n, d, t;
    cudaStream_t stream;
};

// the tier of t, and the column chunks of its partials
constexpr bool tc_tier(int t) { return t > 32 && t <= 64; }
constexpr int num_chunks(int t) { return t == 1 || tc_tier(t) ? 1 : (t + kTC - 1) / kTC; }

template <int DP, int TC>
void launch_fma(const Args& a) {
    const dim3 grid((a.n + kRows - 1) / kRows, num_chunks(a.t));
    periodic_bwd_fma<DP, TC><<<grid, kRows, 0, a.stream>>>(a.x, a.w, a.g, a.v, a.dx_part, a.dw_part, a.dos_part,
                                                            a.n, a.d, a.t);
}

// the tensor-core tier's blocks: 8 warps (128 rows) with the rows' tables in registers
// (DP <= 4), 4 warps (64 rows) with them staged (DP = 16, 64), as periodic_matvec_tc's
template <int DP>
cudaError_t launch_tc(const Args& a) {
    constexpr int kWarps = DP <= 4 ? 8 : 4;
    constexpr size_t kBytes = BwdTcLayout<DP, kWarps>::kBytes;
    const cudaError_t rc = cudaFuncSetAttribute(periodic_bwd_tc<DP, kWarps>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (rc != cudaSuccess) return rc;
    // 16-byte loads of g and v rows where every row starts 16-byte aligned
    const bool vec = a.t % 4 == 0 && ((reinterpret_cast<uintptr_t>(a.g) | reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
    const dim3 grid((a.n + kWarps * 16 - 1) / (kWarps * 16));
    periodic_bwd_tc<DP, kWarps><<<grid, kWarps * 32, kBytes, a.stream>>>(a.x, a.w, a.g, a.v, a.dx_part, a.dw_part,
                                                                          a.dos_part, a.n, a.d, a.t, vec);
    return cudaSuccess;
}

template <int DP>
cudaError_t dispatch_t(const Args& a) {
    if (tc_tier(a.t)) return launch_tc<DP>(a);
    if (a.t == 1) launch_fma<DP, 1>(a);
    else launch_fma<DP, kTC>(a);
    return cudaSuccess;
}

}  // namespace

// The number of column chunks of the partials for t columns: 1 for t = 1 and for the
// tensor-core tier (t in (32, 64]), ceil(t / 32) otherwise.
extern "C" int gp_periodic_bwd_fused_chunks(int t) { return t > 0 ? num_chunks(t) : 0; }

// Launches the fused periodic backward on `stream` and returns cudaGetLastError() (0 on
// success).  x (n, d), w (d,), g (n, t), v (n, t): float32, row-major, contiguous, on one
// device; 1 <= d <= 64.  Outputs: dx_part and dw_part (num_chunks, n, d) and, if need_dos
// (else may be null), dos_part (num_chunks, n) of raw per-row sums, with num_chunks =
// gp_periodic_bwd_fused_chunks(t).  The caller sums the partials and applies
// dx = -4 pi w dx_raw, dw = -sum_i dw_raw and dos = sum_i dos_raw / 2.  Sizes that disagree
// are refused.
extern "C" int gp_periodic_bwd_fused_f32(const void* x, const void* w, const void* g, const void* v, void* dx_part,
                                         void* dw_part, void* dos_part, int n, int d, int t, int need_dos,
                                         void* stream) {
    if (n <= 0 || t <= 0 || d <= 0 || d > periodic::kMaxDP || num_chunks(t) > 65535) return (int)cudaErrorInvalidValue;
    if ((need_dos && dos_part == nullptr) || dx_part == nullptr || dw_part == nullptr) return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(g),
                 static_cast<const float*>(v), static_cast<float*>(dx_part), static_cast<float*>(dw_part),
                 need_dos ? static_cast<float*>(dos_part) : nullptr, n, d, t, static_cast<cudaStream_t>(stream)};
    cudaError_t rc = cudaSuccess;
    periodic::dispatch_dp(d, [&](auto dp) { rc = dispatch_t<decltype(dp)::value>(a); });
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}
