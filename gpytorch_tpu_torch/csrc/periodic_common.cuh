// What kernel_periodic_matvec.cu and kernel_periodic_bwd_fused.cu share: the per-point
// half-angle tables, the sine of a difference formed from them, and the dispatch of the
// input dimension d onto the register tiers DP.
//
// Large arguments.  a = x / period reaches several hundred for a daily period over a year
// of readings, and the float32 difference a_i - a_j of two far-apart points is rounded by
// up to ulp(a) / 2 (1.5e-5 at a = 355), which would put ~1e-4 of error into sin^2.  Instead
// each point is reduced once to its fractional part f = a - rint(a) (exact in float32,
// |f| <= 1/2), and its half-angle table s = sin(pi f), c = cos(pi f) is formed with
// sincospif.  Then sin(pi (a_i - a_j)) = +-(s_i c_j - c_i s_j): the sign flips with the
// integer parts, sin^2 and S C do not.  Its error is a few ulp of 1 whatever the size of a.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace periodic {

// s = sin(pi f), c = cos(pi f) with f = a - rint(a): the half-angle table of one coordinate
__device__ __forceinline__ void half_angle(float a, float& s, float& c) {
    sincospif(a - rintf(a), &s, &c);
}

// sin(pi (a_i - a_j)) up to sign, from the two half-angle tables; both products are
// rounded before the subtraction, so that equal points give exactly 0
__device__ __forceinline__ float sin_diff(float si, float ci, float sj, float cj) {
    return __fsub_rn(__fmul_rn(si, cj), __fmul_rn(ci, sj));
}

// The widest input the register tiers take; kernel_periodic_matvec.cu runs wider inputs
// through its wide tier, and kernel_periodic_bwd_fused.cu refuses them, as the JAX package
// runs its fused periodic backward only for d <= 64 (gpytorch_tpu/ops/pallas_kernels.py::_fpm_bwd).
constexpr int kMaxDP = 64;

// Calls launch(std::integral_constant<int, DP>{}) with the register tier DP of d input
// dims (1 <= d <= kMaxDP): 1 and 2 exact, 4, 16 and 64 padded with zero tables, which add
// nothing.
template <typename F>
inline void dispatch_dp(int d, F&& launch) {
    if (d == 1) launch(std::integral_constant<int, 1>{});
    else if (d == 2) launch(std::integral_constant<int, 2>{});
    else if (d <= 4) launch(std::integral_constant<int, 4>{});
    else if (d <= 16) launch(std::integral_constant<int, 16>{});
    else launch(std::integral_constant<int, 64>{});
}

}  // namespace periodic
