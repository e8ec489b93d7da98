// What the tensor-core tiers of kernel_matvec.cu and kernel_periodic_matvec.cu share: the
// 3xTF32 split and the m16n8k8 product, the staged tile's shape, and V's B fragments.
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

}  // namespace tc
