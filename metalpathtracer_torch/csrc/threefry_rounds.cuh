// The Threefry-2x32 rounds (20 rounds, 5 key injections) and the uniform
// of a word, shared by the kernels that draw the port's random numbers:
// threefry.cu (every draw of a bounce step) and wavefront.cu (a restarted
// lane's jitter). One definition, so both draw the bits of
// metalpathtracer_torch/render/kernels/threefry.py::threefry2x32 and
// bits_to_uniform. Device functions alone, force-inlined: each including
// source compiles them into its own kernels.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry key-schedule parity
constexpr float kTwoTo24 = 1.0f / 16777216.0f;  // 2^-24

// one round, rotating by R, of every chain
template <int R, int K>
__device__ __forceinline__ void one_round(uint32_t (&x0)[K], uint32_t (&x1)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x0[j] += x1[j];
    x1[j] = __funnelshift_l(x1[j], x1[j], R);
    x1[j] ^= x0[j];
  }
}

template <int R0, int R1, int R2, int R3, int K>
__device__ __forceinline__ void rounds(uint32_t (&x0)[K], uint32_t (&x1)[K]) {
  one_round<R0>(x0, x1);
  one_round<R1>(x0, x1);
  one_round<R2>(x0, x1);
  one_round<R3>(x0, x1);
}

template <int K>
__device__ __forceinline__ void inject(uint32_t (&x0)[K], uint32_t (&x1)[K],
                                       uint32_t a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x0[j] += a;
    x1[j] += b;
  }
}

// Threefry-2x32, 20 rounds, of key (k0, k1) on K counters (x0, x1), in place
template <int K>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t (&x0)[K], uint32_t (&x1)[K]) {
  const uint32_t k2 = kParity ^ k0 ^ k1;
  inject(x0, x1, k0, k1);
  rounds<13, 15, 26, 6>(x0, x1);  inject(x0, x1, k1, k2 + 1u);
  rounds<17, 29, 16, 24>(x0, x1); inject(x0, x1, k2, k0 + 2u);
  rounds<13, 15, 26, 6>(x0, x1);  inject(x0, x1, k0, k1 + 3u);
  rounds<17, 29, 16, 24>(x0, x1); inject(x0, x1, k1, k2 + 4u);
  rounds<13, 15, 26, 6>(x0, x1);  inject(x0, x1, k2, k0 + 5u);
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 8), kTwoTo24);
}

}  // namespace
