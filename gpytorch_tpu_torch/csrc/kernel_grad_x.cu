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
// Tiers: t in (32, 128] and d <= 64 on the tensor cores (kernel_grad_x_tc, the LOVE root's
// t = 100 both ways); every other t on the FP32 FMA tier (kernel_grad_x_f32: the mean's
// t = 1, t <= 32 and t > 128); d > 64 on the wide-d tier (kernel_grad_x_wide_f32,
// csrc/wide_d.cuh).  Input dims: d = 3 exact, any other d <= 64 padded to 64.
//
// Strips: the path's shape is a strip, 2,048 test rows against 100k training rows (and the
// other way round for dx2).  Every tier takes a slab of the j range per blockIdx.z: block z
// walks the rows j in [z L, min(m, (z + 1) L)), L a multiple of kSlabTile, and writes its
// own partial dx_part[z (chunks) + chunk, i, :], which the wrapper folds with torch.sum: no
// atomics, so a rerun repeats bit for bit.  The wrapper takes the slab count from the grid
// and occupancy of the tier that gp_kernel_grad_x_plan reports
// (ops/fused_kernels.py::grad_x_slabs): a grid below the SM count splits as far as one wave,
// and a 100k-row side keeps one slab.  Ragged n, m and t are masked by staging zeros (a zero
// v row adds k' * 0 * diff = 0) and by not storing rows out of range.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"
#include "wide_d.cuh"

namespace {

constexpr int kRows = 128;     // FMA tiers: threads per block = rows i per block
constexpr int kTJ = 32;        // FMA tier: rows j staged per shared-memory tile
constexpr int kTC = 32;        // FMA tiers: columns per chunk when t > 1
constexpr int kSlabTile = 32;  // rows j: a slab is a multiple of every tier's staged tile
static_assert(kSlabTile % kTJ == 0 && kSlabTile % tc::kTJ == 0, "slabs of whole staged tiles");

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

// ---------------------------------------------------------------------------------------
// The FMA tier: t <= 32 and t > 128.
//
// One thread owns one row i of x1, keeps x1_i, g_i (one chunk of TC columns) and its dx
// accumulators in registers, and walks over its slab of rows j of x2 in tiles of kTJ
// staged in shared memory with v.  A block of 128 threads owns 128 rows, one column chunk
// (blockIdx.y) and one slab (blockIdx.z).  Within a thread dx is summed per staged tile and
// then added to the running sum, which keeps the float32 summation error of 100k terms
// near that of 3k.  Columns are chunked at 32, each chunk recomputing the exp.
//
// What bounds it on the H100: per (i, j) pair and chunk of 32 columns, 32 FMAs for
// g_i . v_j, one exp, 2d for the distance, d FMAs for the moment and a few more for k' and
// the weight; the bytes are negligible.  At t = 1 the exps bind (2e8 at 2048 x 100k, about
// 0.05 ms at 16 special-function results per SM per clock).
//
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

// ---------------------------------------------------------------------------------------
// The tensor-core tier, t in (32, 128] and d <= 64: the LOVE root's t = 100 of an
// acquisition gradient, dx1 over the 2,048 candidates and, with the parameters live, dx2
// over the 100k training rows.
//
// The score tile.  Each warp owns one m-tile of 16 rows i; for every staged tile of tc::kTJ
// rows j it forms S_ij = g_i . v_j for its 16 x 32 pairs in 3xTF32 on mma.sync.m16n8k8
// (ceil(t / 8) k-steps of the depth-128 operands, x 4 n-tiles x 3 passes): the block's rows
// of g staged once in shared memory as floats in A-fragment order and split per k-step, the
// tile's rows of v split into hi and lo once as they are staged, in B-fragment order
// (tc_common.cuh, layout kSingle), the next tile's loads issued before the current tile's
// mma.  Each k-step's three mma go into a fresh fragment that is added to S in FP32 (one
// chain of 48 mma through the accumulators read twice the plain float32 version's error in
// kernel_periodic_bwd_fused.cu's score).  The scores land in the accumulator fragments:
// c[nt][2 h + e] pairs row g + 8 h of the m-tile (g = lane / 4) with staged row
// 8 nt + 2 q + e (q = lane % 4).  t = 100 runs 13 of the 16 k-steps: the rest are zero.
//
// The epilogue, at each accumulator's own pair, on the CUDA cores, with the FMA tier's
// arithmetic: the differences x1_i - x2_j, d2 summed over the dims in order, k' (one
// __expf), w = k' S, and each pair adds w (x1_i - x2_j) per dim, so a coincident pair adds
// exactly 0.  No diagonal is zeroed: i and j index different point sets.  Each lane sums
// its 8 pairs of each of its two rows, the quad (the four lanes of a row) adds its sums
// with two shuffles, and its first lane adds them to the row's sums in shared memory.
//
// Sums in three levels, as kernel_bwd_fused.cu's kernel_bwd_tc: each staged tile's (32 rows
// j), a block sum over kTcBlockTiles tiles (2048 rows j), and the running sum.  The block
// and running sums live in shared memory, each row's slots written by one lane only, so no
// barrier orders them and they take no registers.
//
// Rows of x1: for DP = 3 each lane holds its two rows in registers, with 8 warps (128 rows)
// a block; for the padded DP = 64 the block's rows are staged in shared memory, the dims
// are walked to d, and the per-dim sums are taken in a second walk over the tile's pairs
// from k' S kept in the accumulators, with 4 warps (64 rows) a block.  Every tier takes
// dynamic shared memory (GxTcLayout).
//
// What bounds it on the H100: 3 passes of 2t operations per pair on the tensor cores (0.25
// ms at 2048 x 100k, t = 100, at the dense TF32 peak of 495 TFLOP/s), against about 5d + 4
// FP32 operations and one exp per pair on the CUDA cores (0.058 ms at d = 3); the FP32
// bound of the same work on the CUDA cores is 0.67 ms.
constexpr int kTcBlockTiles = 64;  // staged tiles per block sum: 2048 rows j

// The tensor-core tier's shared memory: the tile's B fragments; each warp's A fragments;
// the rows' block and running sums (SS floats a row, padded past 4 dims so that the quads'
// first lanes hit different banks); the staged rows j of x2 (tc::kTJ rows of kXStride
// floats); for DP > 4 the block's rows of x1.  Rows of x are 16-byte rows, past 4 dims
// padded by 4 floats, as in kernel_matvec_tc.
template <int DP, int WARPS>
struct GxTcLayout {
    static constexpr int kXStride = DP <= 4 ? 4 : DP + 4;
    static constexpr int kSumStride = DP <= 4 ? DP : DP + 1;
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
kernel_grad_x_tc(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ g,
                 const float* __restrict__ v, float* __restrict__ dx_part, int n, int m, int d, int t, int slab_len,
                 bool vec) {
    using Layout = GxTcLayout<DP, WARPS>;
    constexpr int kThreads = WARPS * 32;
    constexpr int kBRows = Layout::kRowsB;
    constexpr bool kRegX = DP <= 4;
    constexpr int XS = Layout::kXStride, SS = Layout::kSumStride;
    constexpr int kXsPer = (tc::kTJ * XS + kThreads - 1) / kThreads;  // x2 values per thread per tile
    extern __shared__ __align__(16) unsigned char smem[];
    tc::ScoreBFrags& bf = *reinterpret_cast<tc::ScoreBFrags*>(smem);
    tc::ScoreAFrags* af = reinterpret_cast<tc::ScoreAFrags*>(smem + sizeof(tc::ScoreBFrags));
    float* blk = reinterpret_cast<float*>(smem + sizeof(tc::ScoreBFrags) + WARPS * sizeof(tc::ScoreAFrags));
    float* run = blk + kBRows * SS;  // the running sums
    float* xs = run + kBRows * SS;   // the staged rows j of x2
    float* xis = xs + tc::kTJ * XS;  // the block's rows of x1 (DP > 4)

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int lrow = warp * 16 + (lane >> 2);  // this lane's first row within the block
    const int row0 = blockIdx.x * kBRows;
    const int ksteps = (t + 7) / 8;  // k-steps that reach a column of g and v
    // this block's slab of the j range (blockIdx.z) as operands of its own: rows of x2 and v
    // from z L on, m of them at most L, and its partial dx_part[z]
    const int64_t j_slab = (int64_t)blockIdx.z * slab_len;
    x2 += j_slab * d;
    v += j_slab * t;
    dx_part += (int64_t)blockIdx.z * n * d;
    m = min(m - (int)j_slab, slab_len);

    // this lane's rows row0 + lrow + 8 h (h = 0, 1)
    float xr[2][kRegX ? DP : 1];
    if constexpr (kRegX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
#pragma unroll
            for (int k = 0; k < DP; ++k) xr[h][k] = (r < n && k < d) ? x1[(int64_t)r * d + k] : 0.0f;
        }
    } else {
        for (int idx = threadIdx.x; idx < kBRows * XS; idx += kThreads) {
            const int r = idx / XS, k = idx % XS;
            xis[idx] = (row0 + r < n && k < d) ? x1[(int64_t)(row0 + r) * d + k] : 0.0f;
        }
    }
    tc::stage_score_a<WARPS, kThreads, tc::kSingle>(af, g, nullptr, n, t, row0);
    for (int idx = threadIdx.x; idx < 2 * kBRows * SS; idx += kThreads) blk[idx] = 0.0f;  // blk and run

    // the next tile's rows of v and x2, in registers until the tile is stored
    tc::ScoreBStage<kThreads, tc::kSingle> bstage;
    float px[kXsPer];
    auto fetch = [&](int j0) {
        bstage.fetch(nullptr, v, m, t, j0, vec);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / XS, k = idx % XS;
            px[i] = (idx < tc::kTJ * XS && j0 + jj < m && k < d) ? x2[(int64_t)(j0 + jj) * d + k] : 0.0f;
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
    for (int j0 = 0, tiles = 1; j0 < m; j0 += tc::kTJ, ++tiles) {
        store();
        __syncthreads();
        if (j0 + tc::kTJ < m) fetch(j0 + tc::kTJ);

        // the scores S of the warp's 16 rows against the tile's 32 rows j: each k-step's
        // three mma go into a fresh fragment, which is added to the scores in FP32
        float acc[tc::kJTiles][4];
#pragma unroll
        for (int nt = 0; nt < tc::kJTiles; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
        }
#pragma unroll 1
        for (int s = 0; s < ksteps; ++s) {
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
        // tier does; the tile's sums of each row, per dim
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
                    const float w = kernel_prime<KT>(d2) * acc[nt][2 * h + e];
                    if constexpr (kRegX) {
#pragma unroll
                        for (int k = 0; k < DP; ++k) tdx[h][k] = fmaf(w, diff[k], tdx[h][k]);
                    } else {
                        acc[nt][2 * h + e] = w;  // the weight of the dims' walk below
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
        if ((tiles % kTcBlockTiles == 0 || j0 + tc::kTJ >= m) && q == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = (lrow + 8 * h) * SS;
                for (int slot = 0; slot < d; ++slot) {
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

// A launch's operands: dx_part is (num_slabs * chunks, n, d), one partial per slab of
// slab_len rows j and column chunk.  With `plan` set, the dispatch below launches nothing
// and reports the grid of the tier it would launch instead (Plan), from which the wrapper
// chooses the slab count.
struct Plan {
    int row_blocks, chunks;
    int blocks_per_sm;  // of this tier's kernel, by its registers and shared memory
    int slab_tile;      // rows j: a slab is a multiple of it
};

struct Args {
    const float *x1, *x2, *g, *v;
    float* dx_part;
    int n, m, d, t, num_slabs, slab_len;
    cudaStream_t stream;
    Plan* plan;
};

// the tier of (t, d), and the column chunks of its partials
constexpr bool tc_tier(int t, int d) { return t > 32 && t <= 128 && d <= 64; }
constexpr int num_chunks(int t, int d) { return t == 1 || tc_tier(t, d) ? 1 : (t + kTC - 1) / kTC; }

using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, int, int, int, int, int);

// launches an FMA tier on blocks of kRows threads, `row_blocks` of them a column chunk and
// slab, or plans it
cudaError_t run(const Args& a, Kernel kernel, int row_blocks) {
    const dim3 grid(row_blocks, num_chunks(a.t, a.d), a.num_slabs);
    if (a.plan) {
        *a.plan = Plan{(int)grid.x, (int)grid.y, 0, kSlabTile};
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.plan->blocks_per_sm, kernel, kRows, 0);
    }
    kernel<<<grid, kRows, 0, a.stream>>>(a.x1, a.x2, a.g, a.v, a.dx_part, a.n, a.m, a.d, a.t, a.slab_len);
    return cudaSuccess;
}

template <int KT, int DP, int TC>
cudaError_t launch_fma(const Args& a) {
    return run(a, kernel_grad_x_f32<KT, DP, TC>, (a.n + kRows - 1) / kRows);
}

// the tensor-core tier's blocks: 8 warps (128 rows) with the rows of x1 in registers (DP =
// 3), 4 warps (64 rows) with them staged (DP = 64), as kernel_bwd_tc's
template <int KT, int DP>
cudaError_t launch_tc(const Args& a) {
    constexpr int kWarps = DP <= 4 ? 8 : 4;
    constexpr size_t kBytes = GxTcLayout<DP, kWarps>::kBytes;
    const auto kernel = kernel_grad_x_tc<KT, DP, kWarps>;
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (rc != cudaSuccess) return rc;
    const dim3 grid((a.n + kWarps * 16 - 1) / (kWarps * 16), 1, a.num_slabs);
    if (a.plan) {
        *a.plan = Plan{(int)grid.x, 1, 0, kSlabTile};
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.plan->blocks_per_sm, kernel, kWarps * 32, kBytes);
    }
    // 16-byte loads of v's rows where every row starts 16-byte aligned
    const bool vec = a.t % 4 == 0 && (reinterpret_cast<uintptr_t>(a.v) & 15) == 0;
    kernel<<<grid, kWarps * 32, kBytes, a.stream>>>(a.x1, a.x2, a.g, a.v, a.dx_part, a.n, a.m, a.d, a.t, a.slab_len,
                                                   vec);
    return cudaSuccess;
}

template <int KT, int TC>
cudaError_t launch_wide(const Args& a) {
    const int out_slabs = (a.d + wide::kOutSlab - 1) / wide::kOutSlab;
    return run(a, kernel_grad_x_wide_f32<KT, TC>, (a.n + kRows - 1) / kRows * out_slabs);
}

template <int KT, int DP>
cudaError_t dispatch_t(const Args& a) {
    if (tc_tier(a.t, a.d)) return launch_tc<KT, DP>(a);
    if (a.t == 1) return launch_fma<KT, DP, 1>(a);
    return launch_fma<KT, DP, kTC>(a);
}

template <int KT>
cudaError_t dispatch_d(const Args& a) {
    if (a.d == 3) return dispatch_t<KT, 3>(a);
    if (a.d <= 64) return dispatch_t<KT, 64>(a);
    if (a.t == 1) return launch_wide<KT, 1>(a);
    return launch_wide<KT, kTC>(a);
}

cudaError_t dispatch(int kernel_type, const Args& a) {
    switch (kernel_type) {
        case kRBF: return dispatch_d<kRBF>(a);
        case kMatern05: return dispatch_d<kMatern05>(a);
        case kMatern15: return dispatch_d<kMatern15>(a);
        case kMatern25: return dispatch_d<kMatern25>(a);
        default: return cudaErrorInvalidValue;
    }
}

bool valid_sizes(int n, int d, int t) { return n > 0 && t > 0 && d > 0 && num_chunks(t, d) <= 65535; }

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), g (n, t), v (m, t): float32, row-major, contiguous, on one device.
// dx_part (num_slabs * chunks, n, d), with chunks as gp_kernel_grad_x_plan reports them
// (1 on the tensor cores and at t = 1, ceil(t / 32) otherwise); slab s covers rows j of x2
// in [s L, (s + 1) L) with L = ceil(m / num_slabs) rounded up to a multiple of 32 (a slab
// past m writes zeros), and writes partials s chunks .. (s + 1) chunks - 1.  The caller sums
// dx_part over its first axis.  Sizes that the grid cannot hold are refused.
extern "C" int gp_kernel_grad_x_f32(const void* x1, const void* x2, const void* g, const void* v, void* dx_part,
                                    int n, int m, int d, int t, int kernel_type, int num_slabs, void* stream) {
    if (!valid_sizes(n, d, t) || m <= 0 || dx_part == nullptr) return (int)cudaErrorInvalidValue;
    if (num_slabs < 1 || num_slabs > 65535 || num_slabs > m) return (int)cudaErrorInvalidValue;
    const int per_slab = (m + num_slabs - 1) / num_slabs;
    const Args a{static_cast<const float*>(x1), static_cast<const float*>(x2), static_cast<const float*>(g),
                 static_cast<const float*>(v), static_cast<float*>(dx_part), n, m, d, t, num_slabs,
                 (per_slab + kSlabTile - 1) / kSlabTile * kSlabTile, static_cast<cudaStream_t>(stream), nullptr};
    const cudaError_t rc = dispatch(kernel_type, a);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// The grid of the tier that gp_kernel_grad_x_f32 launches at these sizes, on the current
// device: plan[0..3] = row blocks, column chunks, the tier's blocks that fit on an SM at
// once, and the staged tile of rows j that a slab is a multiple of.  Returns 0 on success.
extern "C" int gp_kernel_grad_x_plan(int n, int d, int t, int kernel_type, int* plan) {
    if (!valid_sizes(n, d, t)) return (int)cudaErrorInvalidValue;
    Plan p{};
    const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, n, 0, d, t, 1, 0, nullptr, &p};
    const cudaError_t rc = dispatch(kernel_type, a);
    if (rc != cudaSuccess) return (int)rc;
    plan[0] = p.row_blocks;
    plan[1] = p.chunks;
    plan[2] = p.blocks_per_sm;
    plan[3] = p.slab_tile;
    return 0;
}
