// Threefry-2x32 draws of the port's counter-based RNG, for Hopper.
//
// Replaces the Pallas kernel `kernel` of the JAX package's Mosaic probe
// (benchmarks/mosaic_probe.py:42, launched by pallas_call :66), whose
// function is the reference's core/rng.py sampler: threefry2x32 (:53),
// bits_to_uniform (:80) and random_unit_vector (:109). For each lane i it
// computes Threefry-2x32, 20 rounds, of
//   key     (k0, k1) = (seed, pixel_id[i])
//   counter (c0, c1) = (sample_id[i], (bounce[i] << 8) | purpose)
// in native uint32 (wrapping adds, rotates as funnel shifts), with the key
// schedule and the injection after each block of 4 rounds of
// metalpathtracer_torch/core/rng.py::threefry2x32, and writes one of:
//   pair (mode 0):        out (2, n): bits_to_uniform of both words;
//   triple (mode 1):      out (3, n): the pair, then the first word of a
//                         second block whose c1 has the bit 0x80000000 set;
//   unit vector (mode 2): out (n, 3): z = 2 u0 - 1, t = 2 pi u1,
//                         r = sqrt(max(0, 1 - z^2)), (r cos t, r sin t, z).
// bits_to_uniform is (float)(w >> 8) * 2^-24, exact. The mapping to the
// sphere rounds every operation on its own (__fmul_rn, __fsub_rn: no FMA
// contraction), uses the float32 rounding of the double 2 pi, and the
// accurate sqrtf, cosf and sinf, as torch does op by op, so that the
// plain version (render/kernels/threefry.py::threefry_reference) on the
// card gives the same bits.
//
// Operands: pixel_id, sample_id and bounce are each a value passed by
// value (layout 0), a per-lane int32 or int64 array (layout 4 or 8), or one
// element read by every lane (layout -4 or -8: a 0-d tensor on the device
// is never read on the host). A value's low 32 bits are its word, which is
// the reduction mod 2^32 of the plain version.
//
// The probe's Mosaic workarounds are not ported: the seed is a kernel
// argument, not an SMEM operand; the uniform is a u32 -> f32 conversion,
// not a cast through int32 (Mosaic has no direct one); lanes are flat, not
// (8, 128) tiles.
//
// What bounds it on an H100 SXM: one block is ~75 integer instructions (20
// rounds of add, funnel shift and xor, 5 injections of 3-input adds), and a
// lane moves 8 to 24 bytes in and 8 or 12 out, so at the int32 issue rate
// (64 a clock on each of 132 SMs) and 3.35 TB/s the two bounds are close:
// 921,600 lanes need ~4 us of either. At the paths' shapes (1,024 to
// 921,600 lanes) a call is a few microseconds, below the host's cost of a
// launch; what the kernel buys is ~160 fewer torch launches per draw. One
// thread per lane, 256 threads a block; nothing is staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry key-schedule parity
constexpr uint32_t kHigh = 0x80000000u;    // c1 bit of uniform3's second block
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kTwoTo24 = 1.0f / 16777216.0f;  // 2^-24

struct Operand {
  const void* ptr;  // null for a value
  int layout;       // 0: value; 4 / 8: per lane; -4 / -8: one element
  uint32_t value;
};

__device__ __forceinline__ uint32_t word(const Operand& a, long long i) {
  if (a.layout == 0) return a.value;
  const long long k = a.layout > 0 ? i : 0;
  if (a.layout == 8 || a.layout == -8) {
    return (uint32_t)static_cast<const long long*>(a.ptr)[k];
  }
  return (uint32_t)static_cast<const int*>(a.ptr)[k];
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// Threefry-2x32, 20 rounds, of key (k0, k1) on the counter (x0, x1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = kParity ^ k0 ^ k1;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 8), kTwoTo24);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(Operand pixel, Operand sample, Operand bounce,
                float* __restrict__ out, long long n, uint32_t seed,
                uint32_t purpose) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k1 = word(pixel, i);
  const uint32_t c0 = word(sample, i);
  const uint32_t c1 = (word(bounce, i) << 8) | purpose;
  uint32_t x0 = c0, x1 = c1;
  threefry2x32(seed, k1, x0, x1);
  const float u0 = to_uniform(x0), u1 = to_uniform(x1);
  if (kMode == 2) {
    const float z = __fsub_rn(__fmul_rn(2.0f, u0), 1.0f);
    const float t = __fmul_rn(kTwoPi, u1);
    const float r = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(z, z)), 0.0f));
    out[3 * i] = __fmul_rn(r, cosf(t));
    out[3 * i + 1] = __fmul_rn(r, sinf(t));
    out[3 * i + 2] = z;
    return;
  }
  out[i] = u0;
  out[n + i] = u1;
  if (kMode == 1) {
    uint32_t y0 = c0, y1 = c1 | kHigh;
    threefry2x32(seed, k1, y0, y1);
    out[2 * n + i] = to_uniform(y0);
  }
}

}  // namespace

extern "C" int threefry_launch(const void* pixel_id, const void* sample_id,
                               const void* bounce, void* out, long long n,
                               int mode, uint32_t seed, uint32_t purpose,
                               int pixel_layout, uint32_t pixel_value,
                               int sample_layout, uint32_t sample_value,
                               int bounce_layout, uint32_t bounce_value,
                               int device, void* stream) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const Operand p{pixel_id, pixel_layout, pixel_value};
  const Operand s{sample_id, sample_layout, sample_value};
  const Operand b{bounce, bounce_layout, bounce_value};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    threefry_kernel<0><<<blocks, kThreads, 0, st>>>(p, s, b, o, n, seed, purpose);
  } else if (mode == 1) {
    threefry_kernel<1><<<blocks, kThreads, 0, st>>>(p, s, b, o, n, seed, purpose);
  } else {
    threefry_kernel<2><<<blocks, kThreads, 0, st>>>(p, s, b, o, n, seed, purpose);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
