// What the tensor-core tiers of kernel_matvec.cu, kernel_periodic_matvec.cu,
// kernel_bwd_fused.cu, kernel_periodic_bwd_fused.cu and kernel_grad_x.cu share: the 3xTF32
// split and the m16n8k8 product, the staged tile's shape, V's B fragments, and the operands
// of a score tile (a fused backward's, and grad_x's).
//
// A block's K.V over one staged tile of kTJ rows j is a small matrix product, K_tile
// (rows x kTJ) times V_tile (kTJ x 64), the shape of mma.sync.m16n8k8 on TF32 operands.
// One TF32 pass keeps 10 mantissa bits, which stalls float32 CG (the JAX package measured
// that for one-pass bf16), so the product runs in 3xTF32: with hi = rna(x) and
// lo = rna(x - hi), A B ~ A_hi B_hi + A_hi B_lo + A_lo B_hi, which keeps about 21 bits.
// The kernels form A (the K elements) in each lane's own fragment registers; V is staged
// per tile, split into hi and lo once as it is staged, and laid out in B-fragment order,
// so that a lane reads its (b0, b1) hi and lo of one n-tile with one 16-byte shared load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kTJ = 32;             // rows j per staged tile: 4 k-steps of 8
constexpr int kSteps = kTJ / 8;
constexpr int kCols = 64;           // output columns per block: 8 n-tiles of 8
constexpr int kNTiles = kCols / 8;

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x ~ hi + lo, both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b: one m16n8k8 product on the tensor cores, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V's B fragments of one staged tile in shared memory: [k-step][n-tile][lane] holds
// (b0, b1) hi and (b0, b1) lo
using VFrags = uint32_t[kSteps][kNTiles][32][4];

// A block of THREADS threads stages V: one thread per B fragment (k-step s, n-tile nt,
// lane L), b0 = V(8 s + L % 4, 8 nt + L / 4) and b1 four rows on.  fetch loads the next
// tile's entries into registers (so that the loads' latency hides behind the current
// tile's mma); store splits them into hi and lo and writes each fragment as one 16-byte
// word, consecutive threads on consecutive words.  Out-of-range rows and columns are 0.
template <int THREADS>
struct VStage {
    static constexpr int kFrags = kSteps * kNTiles * 32;
    static_assert(kFrags % THREADS == 0, "whole B fragments per thread");
    static constexpr int kPer = kFrags / THREADS;
    float pv[kPer][2];

    __device__ __forceinline__ void fetch(const float* __restrict__ v, int m, int t, int j0, int c0) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int f = threadIdx.x + i * THREADS;
            const int L = f & 31, nt = (f >> 5) % kNTiles, s = f / (32 * kNTiles);
            const int c = c0 + 8 * nt + (L >> 2);
            const int ja = j0 + 8 * s + (L & 3), jb = ja + 4;
            pv[i][0] = (ja < m && c < t) ? v[(int64_t)ja * t + c] : 0.0f;
            pv[i][1] = (jb < m && c < t) ? v[(int64_t)jb * t + c] : 0.0f;
        }
    }

    __device__ __forceinline__ void store(VFrags& vf) const {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int f = threadIdx.x + i * THREADS;
            uint4 frag;
            split_tf32(pv[i][0], frag.x, frag.z);
            split_tf32(pv[i][1], frag.y, frag.w);
            *reinterpret_cast<uint4*>(vf[f / (32 * kNTiles)][(f >> 5) % kNTiles][f & 31]) = frag;
        }
    }
};

// ---------------------------------------------------------------------------------------
// Score tiles: S_ij = a_i . b_j for a warp's 16 rows i against a staged tile of kTJ rows j,
// an m16 x n32 product of depth 8 kScoreSteps = 128 on mma.sync.m16n8k8: the block's own
// rows are the A operand and the staged rows the B operand.  Two operand layouts:
//   kPair (a fused symmetric backward): GG_ij = g_i . v_j + v_i . g_j is one dot product,
//     [g_i | v_i] . [v_j | g_j], with t <= kScoreHalf columns of g and v zero-padded to
//     kScoreHalf on each side;
//   kSingle (grad_x): g_i . v_j, with t <= 128 columns zero-padded to the depth (a kernel
//     may stop its k-steps at ceil(t / 8): the steps past t are zero).
// The block's rows (g, or [g | v]) are staged once, as floats in A-fragment order (hi and lo
// of 128 rows would take 128 KB), and a lane splits its fragment as it reads it, once per
// k-step for kJTiles n-tiles.  The tile's rows (v, or [v | g]) are staged per tile, split
// into hi and lo once as they are stored, in B-fragment order, so that a lane reads one
// (b0, b1) hi and lo with one 16-byte load.
constexpr int kScoreHalf = 64;                   // kPair: columns of g and of v on each side
constexpr int kScoreSteps = 2 * kScoreHalf / 8;  // k-steps of 8 over the depth: 16
constexpr int kJTiles = kTJ / 8;                 // n-tiles of 8 rows j in a staged tile

enum ScoreLayout { kPair, kSingle };

// A warp's A fragments: [k-step][lane] holds (a0, a1, a2, a3) = A(r, f), A(r + 8, f),
// A(r, f + 4), A(r + 8, f + 4) with r = lane / 4 and f = 8 s + lane % 4, as floats
using ScoreAFrags = float4[kScoreSteps][32];

// A(r, f): kPair [g_r | v_r][f], g[r, f] for f < kScoreHalf and v[r, f - kScoreHalf] above;
// kSingle g[r, f].  0 past n and t
template <ScoreLayout LAYOUT = kPair>
__device__ __forceinline__ float score_a(const float* __restrict__ g, const float* __restrict__ v, int n, int t,
                                         int r, int f) {
    const float* src = LAYOUT == kPair ? (f < kScoreHalf ? g : v) : g;
    const int c = LAYOUT == kPair ? f % kScoreHalf : f;
    return (r < n && c < t) ? src[(int64_t)r * t + c] : 0.0f;
}

// The block's THREADS threads stage the A fragments of its WARPS warps of 16 rows from row0
template <int WARPS, int THREADS, ScoreLayout LAYOUT = kPair>
__device__ __forceinline__ void stage_score_a(ScoreAFrags* af, const float* __restrict__ g,
                                              const float* __restrict__ v, int n, int t, int row0) {
    for (int idx = threadIdx.x; idx < WARPS * kScoreSteps * 32; idx += THREADS) {
        const int L = idx & 31, s = (idx >> 5) % kScoreSteps, wp = idx / (32 * kScoreSteps);
        const int r = row0 + 16 * wp + (L >> 2), f = 8 * s + (L & 3);
        af[wp][s][L] = make_float4(score_a<LAYOUT>(g, v, n, t, r, f), score_a<LAYOUT>(g, v, n, t, r + 8, f),
                                   score_a<LAYOUT>(g, v, n, t, r, f + 4), score_a<LAYOUT>(g, v, n, t, r + 8, f + 4));
    }
}

// a lane's A fragment, split into hi and lo
__device__ __forceinline__ void split_a(const float4& a, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split_tf32(a.x, hi[0], lo[0]);
    split_tf32(a.y, hi[1], lo[1]);
    split_tf32(a.z, hi[2], lo[2]);
    split_tf32(a.w, hi[3], lo[3]);
}

// The B fragments of one staged tile: [k-step][n-tile][lane] holds (b0, b1) hi and (b0, b1)
// lo, b0 = [v_j | g_j][8 s + L % 4] of row j = j0 + 8 nt + L / 4 and b1 four features on
using ScoreBFrags = uint32_t[kScoreSteps][kJTiles][32][4];

// A block of THREADS threads stages the tile's rows ([v_j | g_j], or v_j: g is not read):
// one item of 8 features (one k-step) of one row j per thread and round, consecutive
// threads on consecutive rows.  fetch loads the next tile's items into registers (two
// 16-byte loads each where `vec`: t % 4 == 0 and the rows read 16-byte aligned; else 8
// masked loads), so that their latency hides behind the current tile's mma; store splits
// each item into the hi and lo of the four lanes' (b0, b1) it holds and writes them as
// 16-byte words, each thread starting at another of its four so that a store instruction
// spreads over more banks.  Out-of-range rows and columns are 0.
template <int THREADS, ScoreLayout LAYOUT = kPair>
struct ScoreBStage {
    static constexpr int kItems = kTJ * kScoreSteps;
    static_assert(kItems % THREADS == 0, "whole items per thread");
    static constexpr int kPer = kItems / THREADS;
    float pv[kPer][8];

    __device__ __forceinline__ void fetch(const float* __restrict__ g, const float* __restrict__ v, int n, int t,
                                          int j0, bool vec) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int item = threadIdx.x + i * THREADS;
            const int j = j0 + item % kTJ, s = item / kTJ;
            const float* src = LAYOUT == kPair ? (s < kScoreSteps / 2 ? v : g) : v;  // [v_j | g_j], or v_j
            const int c0 = 8 * (LAYOUT == kPair ? s % (kScoreSteps / 2) : s);
            const float* row = src + (int64_t)j * t;
            if (vec) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const bool in = j < n && c0 + 4 * h < t;
                    const float4 f4 = in ? *reinterpret_cast<const float4*>(row + c0 + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
                    pv[i][4 * h] = f4.x;
                    pv[i][4 * h + 1] = f4.y;
                    pv[i][4 * h + 2] = f4.z;
                    pv[i][4 * h + 3] = f4.w;
                }
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) pv[i][e] = (j < n && c0 + e < t) ? row[c0 + e] : 0.0f;
            }
        }
    }

    __device__ __forceinline__ void store(ScoreBFrags& bf) const {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int item = threadIdx.x + i * THREADS;
            const int jj = item % kTJ, s = item / kTJ;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                // lane 4 (jj % 8) + cc of n-tile jj / 8 takes features cc and cc + 4 of the item
                const int cc = (c + jj) & 3;
                float b0 = pv[i][0], b1 = pv[i][4];
#pragma unroll
                for (int e = 1; e < 4; ++e) {
                    if (cc == e) {
                        b0 = pv[i][e];
                        b1 = pv[i][e + 4];
                    }
                }
                uint4 frag;
                split_tf32(b0, frag.x, frag.z);
                split_tf32(b1, frag.y, frag.w);
                *reinterpret_cast<uint4*>(bf[s][jj / 8][4 * (jj % 8) + cc]) = frag;
            }
        }
    }
};

}  // namespace tc
