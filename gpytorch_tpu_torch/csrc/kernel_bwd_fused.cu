// Fused symmetric backward of the stationary-kernel product on Hopper.
//
// For out = K(x, x) v with K_ij = k(|x_i - x_j|^2) and an output cotangent g, one pass over
// the (i, j) pairs gives, with the score GG_ij = g_i . v_j + v_i . g_j,
//   dx[i, :] = 2 sum_j k'(d2_ij) GG_ij (x_i - x_j)    (k' = 0 at i == j)
//   dos      = sum_ij k(d2_ij) (g_i . v_j)            (if need_dos)
// dx is the cotangent of x (both operand slots, since x1 and x2 are one tensor) and dos the
// cotangent of an outputscale that multiplies K.  k and k' share one exp per pair.  The
// diagonal's dx term is zero exactly; k' is zeroed there because for Matern kernels
// k'(0) ~ 1/sqrt(eps) would otherwise turn it into a cancellation.  The cotangent of v,
// K g, is not formed here: where it is asked for, the wrapper launches the product kernel
// (kernel_matvec.cu) on g, since K is symmetric.
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_bwd_fused_pallas (the backward of every
// mBCG training step, called with need_dv = false and need_dos = true).  Only what it
// computes is carried over: the TPU kernel's (1024, 2048) tiles, lane padding, MXU
// dot_generals for g v^T and v g^T, its rowsum(W) x - W x moment and its (8, 128) dos block
// are not.  Here every pair keeps its own difference x_i - x_j: exact zeros, no cancellation.
//
// Every output is a per-row partial, (chunks, n, d) for dx and (chunks, n) for dos, which
// the wrapper folds with torch.sum.  No atomics: the result is deterministic.  Ragged n and
// t are masked by staging zeros (a zero g and v row adds nothing) and by not storing rows
// and columns out of range.  Tiers: t in (32, 64] and d <= 64 on the tensor cores
// (kernel_bwd_tc, the training call, with dos in float64 by kernel_bwd_dos64); other t
// on the FP32 FMA tier (kernel_bwd_fused_f32); d > 64 on the wide-d tier
// (kernel_bwd_fused_wide_f32, csrc/wide_d.cuh).  Input dims: d = 3 exact, any other d <= 64
// padded to 64.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"
#include "wide_d.cuh"

namespace {

constexpr int kRows = 128;  // FMA tiers: threads per block = rows i per block
constexpr int kTJ = 32;     // FMA tier: rows j staged per shared-memory tile
constexpr int kTC = 32;     // FMA tiers: columns per chunk when t > 1

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

// ---------------------------------------------------------------------------------------
// The FMA tier: t <= 32 and t > 64.
//
// One thread owns one row i and keeps x_i, g_i, v_i and its dx_i accumulators in
// registers.  A block of 128 threads owns 128 rows and one chunk of TC columns
// (blockIdx.y), and walks over all rows j in tiles of kTJ staged in shared memory.
// Columns are chunked at 32: dx and dos add across chunks, so each chunk writes its own
// partials.  dx and dos are summed per staged tile and then added to the running sum,
// which keeps the float32 summation error of 100k terms near that of 3k; dos's running
// sum is compensated besides (Kahan): dos = Σ_ij k_ij g_i·v_j cancels, and at N=100k, t=1
// the uncompensated sum read 4.6 times the plain float32 version's error against float64
// on an H100, with the trained flagship's inputs.  Per pair and
// chunk of 32 columns: 64 FMAs for g_i . v_j and v_i . g_j, one exp, and about 20 more
// FP32 / shared-memory instructions.
//
// DP: distance dims held in registers (3, or 64 for any other d, the extra dims zero).
// DS: row stride of the staged x tile, DP rounded up to a multiple of 4.
template <int KT, int DP, int TC, bool NEED_DOS>
__global__ void __launch_bounds__(kRows)
kernel_bwd_fused_f32(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
                     float* __restrict__ dx_part, float* __restrict__ dos_part, int n, int d, int t) {
    constexpr int DS = (DP + 3) / 4 * 4;
    __shared__ __align__(16) float xs[kTJ * DS];
    __shared__ __align__(16) float gs[kTJ * TC];
    __shared__ __align__(16) float vs[kTJ * TC];

    const int row = blockIdx.x * kRows + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;

    float xi[DP], dxa[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) {
        xi[k] = (row < n && k < d) ? x[(int64_t)row * d + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC], vi[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
    }
    float dos = 0.0f, dos_lost = 0.0f;  // the running sum and its compensation

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
                }
            } else {
#pragma unroll
                for (int c = 0; c < TC; ++c) {
                    gv = fmaf(gi[c], vs[jj * TC + c], gv);
                    vg = fmaf(vi[c], gs[jj * TC + c], vg);
                }
            }
            const float w = kp * (gv + vg);
#pragma unroll
            for (int k = 0; k < DP; ++k) tile_dx[k] = fmaf(w, diff[k], tile_dx[k]);
            if constexpr (NEED_DOS) tile_dos = fmaf(kv, gv, tile_dos);
        }
#pragma unroll
        for (int k = 0; k < DP; ++k) dxa[k] += tile_dx[k];
        if constexpr (NEED_DOS) {
            const float y = tile_dos - dos_lost;
            const float sum = dos + y;
            dos_lost = (sum - dos) - y;
            dos = sum;
        }
        __syncthreads();
    }

    if (row < n) {
#pragma unroll
        for (int k = 0; k < DP; ++k) {
            if (k < d) dx_part[((int64_t)chunk * n + row) * d + k] = 2.0f * dxa[k];
        }
        if constexpr (NEED_DOS) dos_part[(int64_t)chunk * n + row] = dos;
    }
}

// ---------------------------------------------------------------------------------------
// The tensor-core tier, t in (32, 64] and d <= 64: every training step of the flagship
// (t = 1 + 63 probes).  It forms dx; dos, where asked for, is kernel_bwd_dos64's (below).
//
// The score tile.  Each warp owns one m-tile of 16 rows i; for every staged tile of tc::kTJ
// rows j it forms GG for its 16 x 32 pairs as one product of depth 128,
// [g_i | v_i] . [v_j | g_j], in 3xTF32 on mma.sync.m16n8k8 (16 k-steps x 4 n-tiles x 3
// passes): the block's rows' operand staged once in shared memory as floats in A-fragment
// order and split per k-step, the tile's operand split into hi and lo once as it is staged,
// in B-fragment order (tc_common.cuh).  Each k-step's three mma go into a fresh fragment
// that is added to the scores in FP32 (one chain of 48 mma through the accumulators read
// twice the plain float32 version's error in kernel_periodic_bwd_fused.cu's score).  The
// scores land in the accumulator fragments: c[nt][2 h + e] pairs row g + 8 h of the m-tile
// (g = lane / 4) with staged row 8 nt + 2 q + e (q = lane % 4).
//
// K and k' are never mma operands (dv = K g on the tensor cores would need K in A-fragment
// order, built a second time), so each pair's k' is formed once, at the
// accumulator's own position, on the CUDA cores, with the FMA tier's arithmetic (the
// differences, d2 summed over the dims in order, one __expf), and k' is zeroed where the
// global j is i.  dx_i = 2 sum_j k' GG (x_i - x_j), since K is symmetric: a sum of one
// score a pair.  Each lane sums k' GG (x_i - x_j) per dim over its 8 pairs of each of its
// two rows, the quad (the four lanes of a row) adds its sums with two shuffles, and its
// first lane adds them to the row's sums in shared memory.  The next tile's rows are
// loaded into registers before the current tile's mma, as in kernel_matvec.cu's
// kernel_matvec_tc.
//
// Sums in three levels, as kernel_periodic_bwd_fused.cu's periodic_bwd_tc: each staged
// tile's (32 rows j), a block sum over kTcBlockTiles tiles (2048 rows j), and the running
// sum.  The block and running sums live in shared memory, each row's slots written by one
// lane only, so no barrier orders them and they take no registers.
//
// Tiers: for DP = 3 each lane holds its two rows of x in registers, with 8 warps (128
// rows) a block and two blocks an SM (at most 128 registers a thread; about 100 KB of
// shared memory a block).  For the padded DP = 64 the block's rows of x are staged in
// shared memory, the dims are walked to d, and the per-dim dx sums are taken in a second
// walk over the tile's pairs from k' GG kept in the accumulators, with 4 warps (64 rows) a
// block.  Every tier takes dynamic shared memory (BwdTcLayout).
//
// What bounds it on the H100: 3 passes of 2 x 2t operations per pair on the tensor cores
// (15.5 ms at 100k x 100k, t = 64, at the dense TF32 peak of 495 TFLOP/s), against about
// 5d + 9 FP32 operations and one exp per pair on the CUDA cores (3.6 ms at d = 3 at 67
// TFLOP/s); the FP32 bound of the same work is 41.8 ms.  It took 65.2 ms there (the FMA
// tier it replaces, which formed K once per chunk of 32 columns, 102.2-103.2 ms; H100 80GB
// HBM3, 700 W): the score's mma at about 118 TFLOP/s.
constexpr int kTcBlockTiles = 64;  // staged tiles per block sum: 2048 rows j

// The tensor-core tier's shared memory: the tile's B fragments; each warp's A fragments;
// the rows' block and running sums (dx per dim, DP + 1 floats a row, the last unused); the
// staged rows j of x (tc::kTJ rows of kXStride floats); for DP > 4 the block's rows of x.  Rows of
// x are 16-byte rows, past 4 dims padded by 4 floats, as in kernel_matvec_tc.
template <int DP, int WARPS>
struct BwdTcLayout {
    static constexpr int kXStride = DP <= 4 ? 4 : DP + 4;
    static constexpr int kSumStride = DP + 1;
    static constexpr int kRowsB = WARPS * 16;
    static constexpr int kFloats = 2 * kRowsB * kSumStride + tc::kTJ * kXStride + (DP <= 4 ? 0 : kRowsB * kXStride);
    static constexpr size_t kBytes = sizeof(tc::ScoreBFrags) + WARPS * sizeof(tc::ScoreAFrags) + sizeof(float) * kFloats;
};

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int KT, int DP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 2)
kernel_bwd_tc(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
              float* __restrict__ dx_part, int n, int d, int t, bool vec) {
    using Layout = BwdTcLayout<DP, WARPS>;
    constexpr int kThreads = WARPS * 32;
    constexpr int kBRows = Layout::kRowsB;
    constexpr bool kRegX = DP <= 4;
    constexpr int XS = Layout::kXStride, SS = Layout::kSumStride;
    constexpr int kXsPer = (tc::kTJ * XS + kThreads - 1) / kThreads;  // x values per thread per tile
    extern __shared__ __align__(16) unsigned char smem[];
    tc::ScoreBFrags& bf = *reinterpret_cast<tc::ScoreBFrags*>(smem);
    tc::ScoreAFrags* af = reinterpret_cast<tc::ScoreAFrags*>(smem + sizeof(tc::ScoreBFrags));
    float* blk = reinterpret_cast<float*>(smem + sizeof(tc::ScoreBFrags) + WARPS * sizeof(tc::ScoreAFrags));
    float* run = blk + kBRows * SS;  // the running sums
    float* xs = run + kBRows * SS;   // the staged rows j
    float* xis = xs + tc::kTJ * XS;  // the block's rows (DP > 4)

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int lrow = warp * 16 + (lane >> 2);  // this lane's first row within the block
    const int row0 = blockIdx.x * kBRows;

    // this lane's rows row0 + lrow + 8 h (h = 0, 1)
    float xr[2][kRegX ? DP : 1];
    if constexpr (kRegX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
#pragma unroll
            for (int k = 0; k < DP; ++k) xr[h][k] = (r < n && k < d) ? x[(int64_t)r * d + k] : 0.0f;
        }
    } else {
        for (int idx = threadIdx.x; idx < kBRows * XS; idx += kThreads) {
            const int r = idx / XS, k = idx % XS;
            xis[idx] = (row0 + r < n && k < d) ? x[(int64_t)(row0 + r) * d + k] : 0.0f;
        }
    }
    tc::stage_score_a<WARPS, kThreads>(af, g, v, n, t, row0);
    for (int idx = threadIdx.x; idx < 2 * kBRows * SS; idx += kThreads) blk[idx] = 0.0f;  // blk and run

    // the next tile's [v_j | g_j] and rows of x, in registers until the tile is stored
    tc::ScoreBStage<kThreads> bstage;
    float px[kXsPer];
    auto fetch = [&](int j0) {
        bstage.fetch(g, v, n, t, j0, vec);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / XS, k = idx % XS;
            px[i] = (idx < tc::kTJ * XS && j0 + jj < n && k < d) ? x[(int64_t)(j0 + jj) * d + k] : 0.0f;
        }
    };
    auto store = [&]() {
        bstage.store(bf);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            if (idx < tc::kTJ * XS) xs[idx] = px[i];
        }
    };
    // the quad's first lane adds a tile sum of its row h to the row's block sum in slot k
    auto add_tile = [&](int h, int slot, float tile_sum) {
        tile_sum = quad_sum(tile_sum);
        if (q == 0) blk[(lrow + 8 * h) * SS + slot] += tile_sum;
    };

    fetch(0);
    for (int j0 = 0, tiles = 1; j0 < n; j0 += tc::kTJ, ++tiles) {
        store();
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

        // k' at each accumulator's pair, from d2 summed over the dims in order, as the FMA
        // tier does; the tile's sums of each row, dx per dim
        float tdx[2][kRegX ? DP : 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int k = 0; k < (kRegX ? DP : 1); ++k) tdx[h][k] = 0.0f;
        }
#pragma unroll
        for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int jj = 8 * nt + 2 * q + e;
                float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (kRegX) b = *reinterpret_cast<const float4*>(&xs[jj * XS]);
                const float bk[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float diff[kRegX ? DP : 1];
                    float d2 = 0.0f;
                    if constexpr (kRegX) {
#pragma unroll
                        for (int k = 0; k < DP; ++k) {
                            diff[k] = xr[h][k] - bk[k];
                            d2 = fmaf(diff[k], diff[k], d2);
                        }
                    } else {
                        for (int k = 0; k < d; ++k) {
                            const float df = xis[(lrow + 8 * h) * XS + k] - xs[jj * XS + k];
                            d2 = fmaf(df, df, d2);
                        }
                    }
                    float kv, kp;
                    kernel_fn_and_prime<KT>(d2, kv, kp);
                    if (j0 + jj == row0 + lrow + 8 * h) kp = 0.0f;
                    const float gg = acc[nt][2 * h + e];
                    if constexpr (kRegX) {
                        const float w = kp * gg;
#pragma unroll
                        for (int k = 0; k < DP; ++k) tdx[h][k] = fmaf(w, diff[k], tdx[h][k]);
                    } else {
                        acc[nt][2 * h + e] = kp * gg;  // the weight of the dims' walk below
                    }
                }
            }
        }
        if constexpr (kRegX) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int k = 0; k < DP; ++k) add_tile(h, k, tdx[h][k]);
            }
        } else {
            for (int k = 0; k < d; ++k) {
                float sk[2] = {0.0f, 0.0f};
#pragma unroll
                for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float xj = xs[(8 * nt + 2 * q + e) * XS + k];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            sk[h] = fmaf(acc[nt][2 * h + e], xis[(lrow + 8 * h) * XS + k] - xj, sk[h]);
                        }
                    }
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) add_tile(h, k, sk[h]);
            }
        }
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
            for (int k = 0; k < d; ++k) dx_part[(int64_t)r * d + k] = 2.0f * sums[k];
        }
    }
}

// ---------------------------------------------------------------------------------------
// dos of the tensor-core tier, in float64 (kernel_bwd_dos64).
//
// dos = sum_ij k(d2_ij) g_i . v_j is one number, and in the training call it cancels: the
// rhs's column and the probes' columns pull against each other, and at the first step of
// a Matern-5/2 model at N = 100k it is about 2e-4 of its diagonal's share.  Every float32
// evaluation of its 1e10 pairs, the plain version's too, carries rounding noise there of
// up to about 1e-7 of that share, from each pair's g_i . v_j and k; which evaluation lands
// nearer float64 is chance (chip_smoke.dos_noise_witness reads them on the card).  So dos
// is formed in float64 here: g_i . v_j on the FP64 tensor cores (mma.sync m16n8k4: exact
// products, float64 sums), d2 from the float32 inputs' differences and k(d2) in float64,
// and each row's sum in float64, rounded to float32 once (the wrapper folds the rows in
// float64).  kernel_bwd_tc forms dx alone.
//
// Each warp owns one m-tile of 16 rows i and keeps their g as A fragments in registers over
// the whole depth (t <= 64, padded with zeros to kDosSteps k-steps of 4).  A block walks
// over all rows j in tiles of kDosTJ (four n-tiles of 8), staged in shared memory as
// float64 rows of v (kDosStride doubles, so that a fragment's eight rows take two
// wavefronts) and rows of x (float64 for d = 3); the next tile is loaded into registers
// while the current one is multiplied.  The accumulators acc[h][nt][e] of a lane pair row
// 8 h + lane / 4 of the m-tile with row 8 nt + 2 (lane % 4) + e of the tile.  Each lane
// sums k S over its pairs, and the quad (the four lanes of a row) adds its sums at the end:
// no atomics.  k takes its exp as 2^y from a table of 2^(j/64) and a degree-5 polynomial,
// and Matern's r its square root from rsqrtf and one Newton step.  What bounds it on the
// H100: 2t operations a pair on the FP64 tensor cores (19.1 ms at 100k x 100k, t = 64, at
// their 67 TFLOP/s), besides about 25 float64 operations a pair for d2, k and the sum on
// the FP64 cores.
constexpr int kDosTJ = 32;                     // rows j a staged tile
constexpr int kDosSteps = 16;                  // k-steps of 4: the depth t <= 64 padded to 64
constexpr int kDosStride = 4 * kDosSteps + 4;  // doubles a staged row of v

// 2^y for y <= 0 in float64, from tab[j] = 2^(j/64): y = m + j/64 + f with |f| <= 1/128,
// 2^f by Taylor to degree 5 (|f ln 2| <= 0.0055).  Below 2^-1020 it returns 0.
__device__ __forceinline__ double exp2_neg(double y, const double* tab) {
    constexpr double kRound = 6755399441055744.0;  // 1.5 * 2^52: adding it rounds to an integer
    if (y < -1020.0) return 0.0;
    const double big = fma(y, 64.0, kRound);
    const int zi = __double2loint(big);            // rint(64 y), from the low bits
    const double u = (y - (big - kRound) * (1.0 / 64.0)) * 0.6931471805599453;
    const double p = fma(u, fma(u, fma(u, fma(u, fma(u, 1.0 / 120, 1.0 / 24), 1.0 / 6), 0.5), 1.0), 1.0);
    const double scale = __longlong_as_double((long long)((zi >> 6) + 1023) << 52);  // 2^floor(z / 64)
    return tab[zi & 63] * p * scale;
}

// sqrt(d2) in float64 to about 1e-14: rsqrtf's estimate and one Newton step (sqrt below 1e-30)
__device__ __forceinline__ double sqrt64(double d2) {
    if (d2 < 1e-30) return sqrt(d2);
    const double y = rsqrtf((float)d2);
    return d2 * y * fma(-0.5 * d2 * y, y, 1.5);
}

// k(d2) in float64 (kernel_fn_and_prime's kernels)
template <int KT>
__device__ __forceinline__ double kernel_fn64(double d2, const double* tab) {
    constexpr double kLog2e = 1.4426950408889634;
    if constexpr (KT == kRBF) return exp2_neg(-0.5 * kLog2e * d2, tab);
    const double r = sqrt64(d2);
    if constexpr (KT == kMatern05) return exp2_neg(-kLog2e * r, tab);
    if constexpr (KT == kMatern15) {
        const double s = 1.7320508075688772 * r;
        return (1.0 + s) * exp2_neg(-kLog2e * s, tab);
    }
    const double s = 2.23606797749979 * r;
    return fma(s, fma(s, 1.0 / 3.0, 1.0), 1.0) * exp2_neg(-kLog2e * s, tab);
}

// c0 += a0 b and c1 += a1 b for the m-tile's rows lane / 4 (a0, c0) and 8 + lane / 4 (a1, c1)
__device__ __forceinline__ void mma_f64(double (&c0)[2], double (&c1)[2], double a0, double a1, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c0[0]), "+d"(c0[1]), "+d"(c1[0]), "+d"(c1[1])
                 : "d"(a0), "d"(a1), "d"(b));
}

template <int KT, int DP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
kernel_bwd_dos64(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
                 float* __restrict__ dos_part, int n, int d, int t) {
    using XT = std::conditional_t<DP <= 4, double, float>;  // the staged rows of x
    constexpr int kThreads = WARPS * 32, kRowsB = WARPS * 16;
    constexpr int kVPer = kDosTJ * 4 * kDosSteps / kThreads;  // values of v a thread stages a tile
    constexpr int kXPer = (kDosTJ * DP + kThreads - 1) / kThreads;
    __shared__ double vs[kDosTJ * kDosStride];
    __shared__ XT xs[kDosTJ * DP];
    __shared__ XT xis[kRowsB * DP];
    __shared__ double tab[64];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int grp = lane >> 2, q = lane & 3;
    const int row0 = blockIdx.x * kRowsB;

    if (threadIdx.x < 64) tab[threadIdx.x] = exp2(threadIdx.x * (1.0 / 64.0));
    for (int idx = threadIdx.x; idx < kRowsB * DP; idx += kThreads) {
        const int r = row0 + idx / DP, k = idx % DP;
        xis[idx] = (r < n && k < d) ? x[(int64_t)r * d + k] : 0.0f;
    }
    // this lane's A fragments: g of row 16 warp + 8 h + lane / 4 of the block, column 4 s + lane % 4
    double a[2][kDosSteps];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * warp + 8 * h + grp;
#pragma unroll
        for (int s = 0; s < kDosSteps; ++s) {
            const int c = 4 * s + q;
            a[h][s] = (r < n && c < t) ? (double)g[(int64_t)r * t + c] : 0.0;
        }
    }
    double sum[2] = {0.0, 0.0};  // this lane's shares of its rows' (8 h + lane / 4) dos

    // the next tile's rows of v and x, in registers until the tile is stored
    float pv[kVPer], px[kXPer];
    auto fetch = [&](int j0) {
#pragma unroll
        for (int i = 0; i < kVPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int j = j0 + idx / (4 * kDosSteps), c = idx % (4 * kDosSteps);
            pv[i] = (j < n && c < t) ? v[(int64_t)j * t + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kXPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int j = j0 + idx / DP, k = idx % DP;
            px[i] = (idx < kDosTJ * DP && j < n && k < d) ? x[(int64_t)j * d + k] : 0.0f;
        }
    };
    fetch(0);
    for (int j0 = 0; j0 < n; j0 += kDosTJ) {
        __syncthreads();  // the previous tile is read
#pragma unroll
        for (int i = 0; i < kVPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            vs[idx / (4 * kDosSteps) * kDosStride + idx % (4 * kDosSteps)] = pv[i];
        }
#pragma unroll
        for (int i = 0; i < kXPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            if (idx < kDosTJ * DP) xs[idx] = px[i];
        }
        __syncthreads();
        if (j0 + kDosTJ < n) fetch(j0 + kDosTJ);

        double acc[2][4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) acc[h][nt][0] = acc[h][nt][1] = 0.0;
        }
#pragma unroll
        for (int s = 0; s < kDosSteps; ++s) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                mma_f64(acc[0][nt], acc[1][nt], a[0][s], a[1][s], vs[(8 * nt + grp) * kDosStride + 4 * s + q]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const XT* xi = &xis[(16 * warp + 8 * h + grp) * DP];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const XT* xj = &xs[(8 * nt + 2 * q + e) * DP];
                    double d2 = 0.0;
                    if constexpr (DP <= 4) {
#pragma unroll
                        for (int k = 0; k < DP; ++k) {
                            const double df = xi[k] - xj[k];
                            d2 = fma(df, df, d2);
                        }
                    } else {
                        for (int k = 0; k < d; ++k) {
                            const double df = (double)xi[k] - (double)xj[k];
                            d2 = fma(df, df, d2);
                        }
                    }
                    sum[h] = fma(kernel_fn64<KT>(d2, tab), acc[h][nt][e], sum[h]);
                }
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        double total = sum[h] + __shfl_xor_sync(0xffffffffu, sum[h], 1);
        total += __shfl_xor_sync(0xffffffffu, total, 2);
        const int r = row0 + 16 * warp + 8 * h + grp;
        if (q == 0 && r < n) dos_part[r] = (float)total;
    }
}

// ---------------------------------------------------------------------------------------
// The wide-d tier (d > 64; csrc/wide_d.cuh).  Each block owns one slab of kOutSlab dx
// dims o0.. (folded into blockIdx.x with the row block) besides its rows and column chunk:
// the distances of each staged tile of kWideTJ rows are summed over slabs of all the input
// dims, and dx is taken over the block's output dims alone.  dos does not depend on the
// output slab, so only the blocks of the first slab (o0 = 0) write it.  need_dos is an
// argument here, not a template flag as in the FMA tier: flag instantiations of this tier
// took nvcc over a minute more.
constexpr int kWideTJ = 16;

template <int KT, int TC>
__global__ void __launch_bounds__(kRows)
kernel_bwd_fused_wide_f32(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ v,
                          float* __restrict__ dx_part, float* __restrict__ dos_part, int n, int d, int t,
                          bool need_dos) {
    constexpr int kO = wide::kOutSlab;
    __shared__ float x1s[kRows * wide::kRowStride];
    __shared__ float x2s[kWideTJ * wide::kSlab];
    __shared__ float x2o[kWideTJ * kO];
    __shared__ __align__(16) float gs[kWideTJ * TC];
    __shared__ __align__(16) float vs[kWideTJ * TC];

    const int row_blocks = (n + kRows - 1) / kRows;
    const int block = blockIdx.x % row_blocks;
    const int row0 = block * kRows;
    const int o0 = (blockIdx.x / row_blocks) * kO;
    const int row = row0 + threadIdx.x;
    const int chunk = blockIdx.y;
    const int c0 = chunk * TC;

    float xo[kO], dxa[kO];
#pragma unroll
    for (int k = 0; k < kO; ++k) {
        xo[k] = (row < n && o0 + k < d) ? x[(int64_t)row * d + o0 + k] : 0.0f;
        dxa[k] = 0.0f;
    }
    float gi[TC], vi[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
        const bool in = row < n && c0 + c < t;
        gi[c] = in ? g[(int64_t)row * t + c0 + c] : 0.0f;
        vi[c] = in ? v[(int64_t)row * t + c0 + c] : 0.0f;
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
        if (need_dos && o0 == 0) dos_part[(int64_t)chunk * n + row] = dos;
    }
}

struct Args {
    const float *x, *g, *v;
    float *dx_part, *dos_part;
    int n, d, t;
    cudaStream_t stream;
};

// the tier of (t, d), and the column chunks of its partials
constexpr bool tc_tier(int t, int d) { return t > 32 && t <= 64 && d <= 64; }
constexpr int num_chunks(int t, int d) { return t == 1 || tc_tier(t, d) ? 1 : (t + kTC - 1) / kTC; }

template <int KT, int DP, int TC>
void launch_fma(const Args& a) {
    const dim3 grid((a.n + kRows - 1) / kRows, num_chunks(a.t, a.d));
    if (a.dos_part != nullptr) {
        kernel_bwd_fused_f32<KT, DP, TC, true><<<grid, kRows, 0, a.stream>>>(a.x, a.g, a.v, a.dx_part, a.dos_part,
                                                                             a.n, a.d, a.t);
    } else {
        kernel_bwd_fused_f32<KT, DP, TC, false><<<grid, kRows, 0, a.stream>>>(a.x, a.g, a.v, a.dx_part, a.dos_part,
                                                                              a.n, a.d, a.t);
    }
}

// the tensor-core tier's blocks: 8 warps (128 rows) with the rows of x in registers (DP =
// 3), 4 warps (64 rows) with them staged (DP = 64), as kernel_matvec_tc's; then, where dos
// is asked for, kernel_bwd_dos64
template <int KT, int DP>
cudaError_t launch_tc(const Args& a) {
    constexpr int kWarps = DP <= 4 ? 8 : 4;
    constexpr size_t kBytes = BwdTcLayout<DP, kWarps>::kBytes;
    const cudaError_t rc = cudaFuncSetAttribute(kernel_bwd_tc<KT, DP, kWarps>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (rc != cudaSuccess) return rc;
    // 16-byte loads of g and v rows where every row starts 16-byte aligned
    const bool vec = a.t % 4 == 0 && ((reinterpret_cast<uintptr_t>(a.g) | reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
    const dim3 grid((a.n + kWarps * 16 - 1) / (kWarps * 16));
    kernel_bwd_tc<KT, DP, kWarps><<<grid, kWarps * 32, kBytes, a.stream>>>(a.x, a.g, a.v, a.dx_part, a.n, a.d,
                                                                            a.t, vec);
    if (a.dos_part != nullptr) {  // dos in float64, on the same blocks of rows
        kernel_bwd_dos64<KT, DP, kWarps><<<grid, kWarps * 32, 0, a.stream>>>(a.x, a.g, a.v, a.dos_part, a.n, a.d, a.t);
    }
    return cudaSuccess;
}

template <int KT, int TC>
void launch_wide(const Args& a) {
    const int out_slabs = (a.d + wide::kOutSlab - 1) / wide::kOutSlab;
    const dim3 grid((a.n + kRows - 1) / kRows * out_slabs, num_chunks(a.t, a.d));
    kernel_bwd_fused_wide_f32<KT, TC><<<grid, kRows, 0, a.stream>>>(a.x, a.g, a.v, a.dx_part, a.dos_part, a.n, a.d,
                                                                    a.t, a.dos_part != nullptr);
}

template <int KT, int DP>
cudaError_t dispatch_t(const Args& a) {
    if (tc_tier(a.t, a.d)) return launch_tc<KT, DP>(a);
    if (a.t == 1) launch_fma<KT, DP, 1>(a);
    else launch_fma<KT, DP, kTC>(a);
    return cudaSuccess;
}

template <int KT>
cudaError_t dispatch_d(const Args& a) {
    if (a.d == 3) return dispatch_t<KT, 3>(a);
    if (a.d <= 64) return dispatch_t<KT, 64>(a);
    if (a.t == 1) launch_wide<KT, 1>(a);
    else launch_wide<KT, kTC>(a);
    return cudaSuccess;
}

}  // namespace

// The number of column chunks of the partials for t columns and d input dims: 1 for t = 1
// and for the tensor-core tier (t in (32, 64], d <= 64), ceil(t / 32) otherwise.
extern "C" int gp_kernel_bwd_fused_chunks(int t, int d) { return t > 0 && d > 0 ? num_chunks(t, d) : 0; }

// Launches the fused backward on `stream` and returns cudaGetLastError() (0 on success).
// x (n, d), g (n, t), v (n, t): float32, row-major, contiguous, on one device.  Outputs:
// dx_part (num_chunks, n, d) and, if need_dos (else may be null), dos_part (num_chunks, n)
// of per-row partials, with num_chunks = gp_kernel_bwd_fused_chunks(t, d).  The caller
// sums dx_part over chunks and dos_part over everything.  Sizes out of range are refused.
extern "C" int gp_kernel_bwd_fused_f32(const void* x, const void* g, const void* v, void* dx_part, void* dos_part,
                                       int n, int d, int t, int kernel_type, int need_dos, void* stream) {
    if (n <= 0 || t <= 0 || d <= 0 || num_chunks(t, d) > 65535) return (int)cudaErrorInvalidValue;
    if ((need_dos && dos_part == nullptr) || dx_part == nullptr) return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(v),
                 static_cast<float*>(dx_part), need_dos ? static_cast<float*>(dos_part) : nullptr,
                 n, d, t, static_cast<cudaStream_t>(stream)};
    cudaError_t rc;
    switch (kernel_type) {
        case kRBF: rc = dispatch_d<kRBF>(a); break;
        case kMatern05: rc = dispatch_d<kMatern05>(a); break;
        case kMatern15: rc = dispatch_d<kMatern15>(a); break;
        case kMatern25: rc = dispatch_d<kMatern25>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}
