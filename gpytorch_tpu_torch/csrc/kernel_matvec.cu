// Streaming stationary-kernel matvec on Hopper: out[i, :] = sum_j k(|x1_i - x2_j|^2) v[j, :].
//
// Replaces gpytorch_tpu/ops/pallas_kernels.py::_matvec_pallas (the TPU kernel behind every
// CG iteration, every Lanczos block and every cross-covariance product of exact-GP serving).
// Only what it computes is carried over.  The TPU kernel's (1024, 2048) tiles, lane padding,
// column chunking, sub-blocking, bf16 / hi-lo MXU emulations and quadratic-expansion
// distances are not: here the distance is a direct difference for every d.  The K.V
// product is FP32 FMA on the CUDA cores for t <= 32 and t > 64, and 3xTF32 on the tensor
// cores for t in (32, 64] (below).  One-pass TF32 or BF16 would reintroduce the CG stalls
// the JAX package measured; 3xTF32 keeps about 21 mantissa bits.
//
// Design of the FMA tiers: each thread owns one output row and TC output columns,
// accumulated in registers in two levels, one sum per staged tile (CG's residual stays
// honest, and so do the LOVE variances K** - |K*x R|^2, which cancel to 1e-5 of K**).  A block of 128 threads owns 128 rows and one tile of TC columns
// (blockIdx.y), and walks over its slab of x2 and v (blockIdx.z, below) in tiles of TJ rows
// staged in shared memory.
// Every output element is written once, by one thread, with no atomics, so the result is
// deterministic.  Ragged n, m and t are masked: out-of-range x2 rows and v entries are
// staged as zeros, so the inner loop needs no branch; out-of-range output rows and columns
// are never stored.  K is never stored anywhere.
//
// What bounds it on the H100: for d = 3 and t = 1 each kernel element costs one MUFU exp
// (plus a sqrt for the Matern kernels) and about ten FP32 / shared-memory instructions, so
// the kernel is bound by instruction issue and the SFU, not by memory (x2 and v stream
// through shared memory once per 128 rows).  For t = 20 and 100 the TC accumulating FMAs
// dominate; at t = 64 the product moves to the tensor cores, where three TF32 passes of
// 2t operations per pair and the B fragments' shared-memory reads bound it (see the tier's
// note).
//
// Strips: a cross-covariance product of 2048 test rows makes 16 row blocks (2 for a request
// of 256), which would leave most of the 132 SMs idle while each block walked all 100k rows
// j alone.  Every tier therefore takes a slab of the j range per blockIdx.z: block z walks
// the rows j in [z L, min(m, (z + 1) L)), L a multiple of kSlabTile, as if they were all of
// x2, and writes its own partial out[z, i, c]; the wrapper folds the partials with
// torch.sum (no atomics, so a rerun repeats bit for bit) and chooses the slab count from
// the card's SM count and the grid and occupancy of the tier that gp_kernel_matvec_plan
// reports (ops/fused_kernels.py::product_slabs).  Within a slab each tier keeps its sums.
// A grid that fills the card alone (n = 100k: 782 row blocks) takes one slab, and a launch
// of one slab runs each kernel's SLABS = false instance, the kernel without the split, so
// that the training and refresh products run the code they ran before it (narrowing the
// operands in registers cost the t = 64 tier 3 % on an H100).  Known gaps, left to later
// work: column tiles are 1, 16, 20, 32 or 64 wide (t = 100 runs four tiles of 32 summed per
// staged tile), and each column tile recomputes k.
// Input dims: d = 3 exact, any other d <= 64 padded to 64 dims, and d > 64 through the
// wide-d tier (csrc/wide_d.cuh), which walks the dims in slabs.  The template tiers are
// the ones the paths use (d = 3; t = 1, 20, 64, 100); a finer tier waits for a measured
// shape that needs it.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"
#include "wide_d.cuh"

namespace {

constexpr int kRows = 128;  // threads per block = output rows per block
constexpr int kTJ = 64;     // x2 / v rows staged per shared-memory tile
// a slab of the j range is a multiple of this, and so of every tier's staged tile
constexpr int kSlabTile = kTJ;
static_assert(kSlabTile % tc::kTJ == 0, "slabs of whole tensor-core tiles");

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
// Each staged tile's kTJ terms are summed apart before they are added to the running sum.
template <int KT, int DP, int TC, bool SLABS>
__global__ void __launch_bounds__(kRows)
kernel_matvec_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ v,
                  float* __restrict__ out, int n, int m, int d, int t, int slab_len) {
    constexpr int DS = (DP + 3) / 4 * 4;
    __shared__ __align__(16) float xs[kTJ * DS];
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
        // on an H100 and ended with its true residual 2.4 times over the tolerance.  Every
        // other FMA tier sums per staged tile too (t in (32, 64] runs the tensor-core tier,
        // in two levels).  t in (1, 16] (the 16 solves of a fantasy update) runs tiles of 16
        // columns: with one running sum the t = 16 product at N=100k read 2.2e-5 of max |.|
        // from float64 on an H100, 4 times the plain float32 version's error.  t in (16, 20]
        // (a Lanczos block, t = 20) runs tiles of 20 and t in (20, 32] tiles of 32: with one
        // running sum over 32 columns the t = 20 product at N=100k read 2.5e-7 of max K|v|
        // from the plain float32 version on an H100, ten times the t = 1 and t = 64 products'
        // distance, and the LOVE gradient through it (5 blocks forward, 4 backward) twice the
        // plain float32 path's distance from float64.  t > 64 (the LOVE root, t = 100) runs tiles
        // of 32: with one level over 100k terms the smallest LOVE variances of the trained
        // flagship (N=100k, on an H100) were 90 % off float64 (5 % through cuBLAS), and their input gradients
        // 2.3e-3 of the largest gradient (1.4e-4).
        float tile[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) tile[c] = 0.0f;
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
                tile[0] = fmaf(kv, vs[jj], tile[0]);
            } else {
#pragma unroll
                for (int c = 0; c < TC; c += 4) {
                    const float4 w = *reinterpret_cast<const float4*>(&vs[jj * TC + c]);
                    tile[c] = fmaf(kv, w.x, tile[c]);
                    tile[c + 1] = fmaf(kv, w.y, tile[c + 1]);
                    tile[c + 2] = fmaf(kv, w.z, tile[c + 2]);
                    tile[c + 3] = fmaf(kv, w.w, tile[c + 3]);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[c] += tile[c];
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

// ---------------------------------------------------------------------------------------
// The tensor-core tier, t in (32, 64]: every training CG iteration (t = 1 + 63 probes).
//
// K_tile . V_tile per staged tile of tc::kTJ rows j in 3xTF32 on mma.sync.m16n8k8 (see
// tc_common.cuh).  Each warp owns one m-tile of 16 rows and all 64 columns (8 n-tiles of
// 8).  For every 8-wide k-step over j, each lane computes the four K elements of its own A
// fragment in registers (rows g and g + 8 with g = lane / 4, columns lane % 4 and
// lane % 4 + 4) from its x1 rows and the staged x2 rows, splits them into hi and lo, and
// runs three mma per n-tile.  Every K element is thus computed once per block and never
// stored.  V is staged per tile in B-fragment order, split into hi and lo once
// (tc::VStage).  Sums in two levels, as the t = 1 and t > 64 tiers: each staged tile's
// terms go into a fresh accumulator fragment, which is then added to the running one (one
// running float32 sum over 100k terms is what made the LOVE variances 90 % wrong).  No
// atomics and a fixed order: deterministic.  Ragged n, m and t are masked as in the FMA
// tiers.
//
// What bounds it on the H100: 3 passes of 2t operations per pair on the tensor cores
// (7.7 ms at 100k x 100k, t = 64, at the dense TF32 peak of 495 TFLOP/s), against about
// 3d + 4 FP32 operations and one exp per pair on the CUDA cores (about 2.5 ms each).  It
// reads 27.5 ms there (59.0 ms for the FMA tier it replaced): about 140 TFLOP/s of TF32
// mma.sync, which no tile shape tried moved (see launch_tc).  The rest of the way is
// wgmma (a warpgroup's 64-row tile with B read from shared memory) and TMA, later work.

using tc::mma_tf32;
using tc::split_tf32;

// WARPS warps of one m-tile each: a block owns WARPS * 16 rows and 64 columns, and stages
// tc::kTJ rows j per tile.  For d = 3 (DP <= 4) a lane holds its two rows of x1 in registers;
// for the padded tier (DP = 64) the block's x1 rows are staged in shared memory.  The next
// tile's x2 rows and V entries are loaded into registers while the current tile is
// computed, and split and stored after the tile's barrier, so that the global loads'
// latency hides behind the tensor-core work (without it the tier took twice as long).
template <int KT, int DP, int WARPS, bool SLABS>
__global__ void __launch_bounds__(WARPS * 32)
kernel_matvec_tc(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ v,
                 float* __restrict__ out, int n, int m, int d, int t, int slab_len) {
    constexpr int kThreads = WARPS * 32;
    constexpr int kBRows = WARPS * 16;
    constexpr bool kRegX1 = DP <= 4;
    // row stride of the staged x rows: 16-byte rows; past 4 dims padded by 4 floats, so
    // that the 4 rows a quarter-warp reads fall in different banks
    constexpr int DS = kRegX1 ? 4 : DP + 4;
    constexpr int kXsPer = (tc::kTJ * DS + kThreads - 1) / kThreads;
    __shared__ __align__(16) tc::VFrags vf;
    __shared__ __align__(16) float xs[tc::kTJ * DS];
    __shared__ __align__(16) float x1s[kRegX1 ? 4 : kBRows * DS];

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

    // this lane's rows: row0 + lrow + 8 h, for h = 0, 1
    float xr[2][kRegX1 ? DP : 1];
    if constexpr (kRegX1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + lrow + 8 * h;
#pragma unroll
            for (int k = 0; k < DP; ++k) xr[h][k] = (r < n && k < d) ? x1[(int64_t)r * d + k] : 0.0f;
        }
    } else {
        for (int idx = threadIdx.x; idx < kBRows * DS; idx += kThreads) {
            const int r = idx / DS, k = idx % DS;
            x1s[idx] = (row0 + r < n && k < d) ? x1[(int64_t)(row0 + r) * d + k] : 0.0f;
        }
    }
    float acc[tc::kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
    }

    // the next tile's V entries and x2 rows, in registers until the tile is stored
    tc::VStage<kThreads> vstage;
    float px[kXsPer];
    auto fetch = [&](int j0) {
        vstage.fetch(v, m, t, j0, c0);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            const int jj = idx / DS, k = idx % DS;
            px[i] = (idx < tc::kTJ * DS && j0 + jj < m && k < d) ? x2[(int64_t)(j0 + jj) * d + k] : 0.0f;
        }
    };
    auto store = [&]() {
        vstage.store(vf);
#pragma unroll
        for (int i = 0; i < kXsPer; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            if (idx < tc::kTJ * DS) xs[idx] = px[i];
        }
    };

    fetch(0);
    for (int j0 = 0; j0 < m; j0 += tc::kTJ) {
        store();
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
            // A fragment: a[h + 2 c] = K(row g + 8 h, column q + 4 c) of the k-step
            const int jrow[2] = {8 * s + q, 8 * s + q + 4};
            float d2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if constexpr (kRegX1) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float4 b = *reinterpret_cast<const float4*>(&xs[jrow[c] * DS]);
                    const float bk[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int k = 0; k < DP; ++k) {
                            const float diff = xr[h][k] - bk[k];
                            d2[h + 2 * c] = fmaf(diff, diff, d2[h + 2 * c]);
                        }
                    }
                }
            } else {
                const float* ar[2] = {&x1s[lrow * DS], &x1s[(lrow + 8) * DS]};
#pragma unroll 4
                for (int k4 = 0; k4 < DP; k4 += 4) {
                    float4 a4[2], b4[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) a4[h] = *reinterpret_cast<const float4*>(ar[h] + k4);
#pragma unroll
                    for (int c = 0; c < 2; ++c) b4[c] = *reinterpret_cast<const float4*>(&xs[jrow[c] * DS + k4]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const float ak[4] = {a4[h].x, a4[h].y, a4[h].z, a4[h].w};
                            const float bk[4] = {b4[c].x, b4[c].y, b4[c].z, b4[c].w};
#pragma unroll
                            for (int k = 0; k < 4; ++k) {
                                const float diff = ak[k] - bk[k];
                                d2[h + 2 * c] = fmaf(diff, diff, d2[h + 2 * c]);
                            }
                        }
                    }
                }
            }
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(kernel_fn<KT>(d2[e]), ahi[e], alo[e]);
#pragma unroll
            for (int nt = 0; nt < tc::kNTiles; ++nt) {
                const uint4 b = *reinterpret_cast<const uint4*>(vf[s][nt][lane]);
                mma_tf32(tile[nt], alo, b.x, b.y);  // A_lo B_hi
                mma_tf32(tile[nt], ahi, b.z, b.w);  // A_hi B_lo
                mma_tf32(tile[nt], ahi, b.x, b.y);  // A_hi B_hi
            }
        }
#pragma unroll
        for (int nt = 0; nt < tc::kNTiles; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[nt][r] += tile[nt][r];
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
                if (c < t) out[(int64_t)r * t + c] = acc[nt][2 * h + e];
            }
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
    const float *x1, *x2, *v;
    float* out;
    int n, m, d, t, num_slabs, slab_len;
    cudaStream_t stream;
    Plan* plan;
};

using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int, int);

// launches a tier on blocks of `rows` rows and `cols` columns by the slabs (`slabbed`, its
// SLABS = true instance, or `whole` for one slab), or plans it
cudaError_t run(const Args& a, Kernel slabbed, Kernel whole, int rows, int cols, int threads) {
    const dim3 grid((a.n + rows - 1) / rows, (a.t + cols - 1) / cols, a.num_slabs);
    if (a.plan) {
        *a.plan = Plan{(int)grid.x, (int)grid.y, 0, kSlabTile};
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.plan->blocks_per_sm, slabbed, threads, 0);
    }
    const Kernel kernel = a.num_slabs > 1 ? slabbed : whole;
    kernel<<<grid, threads, 0, a.stream>>>(a.x1, a.x2, a.v, a.out, a.n, a.m, a.d, a.t, a.slab_len);
    return cudaSuccess;
}

// the tensor-core tier's blocks: 8 warps (128 rows) for d = 3; 4 warps (64 rows) for the
// padded tier, whose staged x1 rows take 17 KB.  On an H100 at 100k x 100k, d = 3, t = 64,
// every shape tried read 27.3-28.0 ms (8 warps of one or two m-tiles, tiles of 32 or 64 rows
// j) but fewer warps (4 warps of two m-tiles 30-32 ms, of four 46 ms): the tensor cores'
// mma.sync rate, not the shared-memory reads, sets the time once the loads are prefetched
template <int KT, int DP>
cudaError_t launch_tc(const Args& a) {
    constexpr int kWarps = DP <= 4 ? 8 : 4;
    return run(a, kernel_matvec_tc<KT, DP, kWarps, true>, kernel_matvec_tc<KT, DP, kWarps, false>, kWarps * 16,
               tc::kCols, kWarps * 32);
}

// The wide-d tier (d > 64; csrc/wide_d.cuh): one thread per output row as above, the
// distances of each staged tile of kWideTJ rows summed over slabs of the input dims, and
// TC = 1 or 32 columns per block, summed per staged tile.
constexpr int kWideTJ = 32;
static_assert(kSlabTile % kWideTJ == 0, "slabs of whole wide-tier tiles");

template <int KT, int TC, bool SLABS>
__global__ void __launch_bounds__(kRows)
kernel_matvec_wide_f32(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ v,
                       float* __restrict__ out, int n, int m, int d, int t, int slab_len) {
    __shared__ float x1s[kRows * wide::kRowStride];
    __shared__ float x2s[kWideTJ * wide::kSlab];
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
        float d2[kWideTJ];
        wide::sq_dist_tile<kRows, kWideTJ>(x1, x2, n, m, d, row0, j0, x1s, x2s, d2);
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
            const float kv = kernel_fn<KT>(d2[jj]);
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

template <int KT, int TC>
cudaError_t launch_wide(const Args& a) {
    return run(a, kernel_matvec_wide_f32<KT, TC, true>, kernel_matvec_wide_f32<KT, TC, false>, kRows, TC, kRows);
}

template <int KT, int DP, int TC>
cudaError_t launch(const Args& a) {
    return run(a, kernel_matvec_f32<KT, DP, TC, true>, kernel_matvec_f32<KT, DP, TC, false>, kRows, TC, kRows);
}

template <int KT, int DP>
cudaError_t dispatch_tc(const Args& a) {
    if (a.t == 1) return launch<KT, DP, 1>(a);
    if (a.t <= 16) return launch<KT, DP, 16>(a);
    if (a.t <= 20) return launch<KT, DP, 20>(a);
    if (a.t <= 32) return launch<KT, DP, 32>(a);
    if (a.t <= 64) return launch_tc<KT, DP>(a);
    return launch<KT, DP, 32>(a);
}

template <int KT>
cudaError_t dispatch_d(const Args& a) {
    if (a.d == 3) return dispatch_tc<KT, 3>(a);
    if (a.d <= 64) return dispatch_tc<KT, 64>(a);
    if (a.t == 1) return launch_wide<KT, 1>(a);
    return launch_wide<KT, 32>(a);
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

bool valid_sizes(int n, int m, int d, int t) { return n > 0 && t > 0 && m >= 0 && d > 0 && (t + 31) / 32 <= 65535; }

}  // namespace

// Launches the matvec on `stream` and returns cudaGetLastError() (0 on success).
// x1 (n, d), x2 (m, d), v (m, t): float32, row-major, contiguous, on one device.
// out (num_slabs, n, t): slab s covers rows j of x2 in [s L, (s + 1) L) with
// L = ceil(m / num_slabs) rounded up to a multiple of 64 (a slab past m writes zeros); the
// caller sums out over its first axis (num_slabs = 1: out is the product itself).  Sizes
// that the grid cannot hold are refused.
extern "C" int gp_kernel_matvec_f32(const void* x1, const void* x2, const void* v, void* out, int n, int m,
                                    int d, int t, int kernel_type, int num_slabs, void* stream) {
    if (!valid_sizes(n, m, d, t)) return (int)cudaErrorInvalidValue;
    if (num_slabs < 1 || num_slabs > 65535 || num_slabs > (m > 0 ? m : 1)) return (int)cudaErrorInvalidValue;
    const int per_slab = (m + num_slabs - 1) / num_slabs;
    const Args a{static_cast<const float*>(x1), static_cast<const float*>(x2), static_cast<const float*>(v),
                 static_cast<float*>(out), n, m, d, t, num_slabs, (per_slab + kSlabTile - 1) / kSlabTile * kSlabTile,
                 static_cast<cudaStream_t>(stream), nullptr};
    const cudaError_t rc = dispatch(kernel_type, a);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// The grid of the tier that gp_kernel_matvec_f32 launches at these sizes, on the current
// device: plan[0..3] = row blocks, column chunks, the tier's blocks that fit on an SM at
// once, and the staged tile of rows j that a slab is a multiple of.  Returns 0 on success.
extern "C" int gp_kernel_matvec_plan(int n, int d, int t, int kernel_type, int* plan) {
    if (!valid_sizes(n, 0, d, t)) return (int)cudaErrorInvalidValue;
    Plan p{};
    const Args a{nullptr, nullptr, nullptr, nullptr, n, 0, d, t, 1, 0, nullptr, &p};
    const cudaError_t rc = dispatch(kernel_type, a);
    if (rc != cudaSuccess) return (int)rc;
    plan[0] = p.row_blocks;
    plan[1] = p.chunks;
    plan[2] = p.blocks_per_sm;
    plan[3] = p.slab_tile;
    return 0;
}
