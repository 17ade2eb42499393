// Threefry-2x32 draws of the port's counter-based RNG, for Hopper: every
// draw of a bounce step in one launch.
//
// Replaces the Pallas kernel `kernel` of the JAX package's Mosaic probe
// (benchmarks/mosaic_probe.py:42, launched by pallas_call :66), whose
// function is the reference's core/rng.py sampler: threefry2x32 (:53),
// bits_to_uniform (:80) and random_unit_vector (:109). For each lane i and
// each draw of a bundle it computes Threefry-2x32, 20 rounds, of
//   key     (k0, k1) = (seed, pixel_id[i])
//   counter (c0, c1) = (sample_id[i], (bounce[i] << 8) | purpose)
// in native uint32 (wrapping adds, rotates as funnel shifts), with the key
// schedule and the injection after each block of 4 rounds of
// metalpathtracer_torch/core/rng.py::threefry2x32 (the rounds live in
// threefry_rounds.cuh, which wavefront.cu's restart shares for its jitter
// draw), and writes, from output
// element `offset` on, one of:
//   pair (mode 0):        (2, n): bits_to_uniform of both words;
//   triple (mode 1):      (3, n): the pair, then the first word of a second
//                         block whose c1 has the bit 0x80000000 set;
//   unit vector (mode 2): (n, 3): z = 2 u0 - 1, t = 2 pi u1,
//                         r = sqrt(max(0, 1 - z^2)), (r cos t, r sin t, z);
//   single (mode 3):      (n,): the first word's uniform (uniform1).
// bits_to_uniform is (float)(w >> 8) * 2^-24, exact. The mapping to the
// sphere rounds every operation on its own (__fmul_rn, __fsub_rn: no FMA
// contraction), uses the float32 rounding of the double 2 pi, and the
// accurate sqrtf, cosf and sinf, as torch does op by op, so that the
// plain version (render/kernels/threefry.py::threefry_reference) on the
// card gives the same bits.
//
// A launch is a bundle: the lane operands once, and up to kMaxDraws draws
// (purpose, mode, output row), passed by value. The host side expands the
// draws into counter blocks (a triple is a pair and a single on c1 with the
// top bit set), at most kMaxBlocks, and launches the kernel built for that
// many blocks. Operands: pixel_id, sample_id and bounce are each a value
// passed by value (layout 0), a per-lane int32 or int64 array (layout 4 or
// 8), or one element read by every lane (layout -4 or -8: a 0-d tensor on
// the device is never read on the host). A value's low 32 bits are its
// word, which is the reduction mod 2^32 of the plain version.
//
// The probe's Mosaic workarounds are not ported: the seed is a kernel
// argument, not an SMEM operand; the uniform is a u32 -> f32 conversion,
// not a cast through int32 (Mosaic has no direct one); lanes are flat, not
// (8, 128) tiles.
//
// What bounds it on an H100 SXM: one block is ~75 integer instructions (20
// rounds of add, funnel shift and xor, 5 injections), and a lane reads 8 to
// 24 bytes of operands and writes 4 to 12 a draw, so at 921,600 lanes a
// bounce step's two draws need ~6.6 us of bytes and about as long at the
// int32 issue rate (64 a clock on each of 132 SMs). At the paths' other
// shapes (1,024 to 32,768 lanes) a call is the launch, the first load's
// latency and the drain, whatever it draws: the design pays those once a
// bounce step instead of once a draw. Each thread loads its lane's
// operands once and runs the bundle's 20-round chains interleaved round by
// round (unrolled over the blocks), so the chains' add, rotate and xor
// steps hide each other's latency; each result is stored once. One thread
// a lane, THREEFRY_THREADS (256) a block; nothing is staged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry_rounds.cuh"

#ifndef THREEFRY_THREADS
#define THREEFRY_THREADS 256
#endif

namespace {

constexpr int kThreads = THREEFRY_THREADS;
constexpr int kMaxDraws = 8;
constexpr int kMaxBlocks = 8;
constexpr int kPair = 0, kTriple = 1, kUnitVector = 2, kSingle = 3;
constexpr uint32_t kHigh = 0x80000000u;    // c1 bit of uniform3's second block
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

struct Operand {
  const void* ptr;  // null for a value
  int layout;       // 0: value; 4 / 8: per lane; -4 / -8: one element
  uint32_t value;
};

// one counter block of a bundle: the bits ORed into c1 below the bounce
// (purpose, and kHigh for a triple's second block), what is written from
// its words (kPair, kUnitVector or kSingle) and from which output element
struct Block {
  uint32_t c1;
  int mode;
  long long offset;
};

struct Blocks {
  Block b[kMaxBlocks];
};

__device__ __forceinline__ uint32_t word(const Operand& a, long long i) {
  if (a.layout == 0) return a.value;
  const long long k = a.layout > 0 ? i : 0;
  if (a.layout == 8 || a.layout == -8) {
    return (uint32_t)static_cast<const long long*>(a.ptr)[k];
  }
  return (uint32_t)static_cast<const int*>(a.ptr)[k];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(Operand pixel, Operand sample, Operand bounce, Blocks blocks,
                float* __restrict__ out, long long n, uint32_t seed,
                unsigned long long* __restrict__ tally, int draws) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch and its draws, counted on the device: a CUDA graph's replay
  // counts too
  if (tally != nullptr && i == 0) {
    atomicAdd(tally, 1ull);
    atomicAdd(tally + 1, (unsigned long long)draws);
  }
  if (i >= n) return;
  const uint32_t k1 = word(pixel, i);
  const uint32_t c0 = word(sample, i);
  const uint32_t high = word(bounce, i) << 8;
  uint32_t x0[K], x1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x0[j] = c0;
    x1[j] = high | blocks.b[j].c1;
  }
  threefry2x32<K>(seed, k1, x0, x1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float* o = out + blocks.b[j].offset;
    const float u0 = to_uniform(x0[j]);
    if (blocks.b[j].mode == kUnitVector) {
      const float z = __fsub_rn(__fmul_rn(2.0f, u0), 1.0f);
      const float t = __fmul_rn(kTwoPi, to_uniform(x1[j]));
      const float r = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(z, z)), 0.0f));
      o[3 * i] = __fmul_rn(r, cosf(t));
      o[3 * i + 1] = __fmul_rn(r, sinf(t));
      o[3 * i + 2] = z;
    } else {
      o[i] = u0;
      if (blocks.b[j].mode == kPair) o[n + i] = to_uniform(x1[j]);
    }
  }
}

template <int K>
void launch_blocks(const Operand& p, const Operand& s, const Operand& b,
                   const Blocks& blocks, float* out, long long n, uint32_t seed,
                   unsigned long long* tally, int draws, cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  threefry_kernel<K><<<grid, kThreads, 0, st>>>(p, s, b, blocks, out, n, seed,
                                                tally, draws);
}

}  // namespace

// `count` draws d0..d7, each packed as purpose (bits 0-31) | mode << 32 |
// the first output row << 40 (its elements start at row * n of `out`)
extern "C" int threefry_launch(const void* pixel_id, const void* sample_id,
                               const void* bounce, void* out, long long n,
                               uint32_t seed, int count, uint64_t d0, uint64_t d1,
                               uint64_t d2, uint64_t d3, uint64_t d4, uint64_t d5,
                               uint64_t d6, uint64_t d7, int pixel_layout,
                               uint32_t pixel_value, int sample_layout,
                               uint32_t sample_value, int bounce_layout,
                               uint32_t bounce_value, int device, void* stream,
                               void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  if (count < 1 || count > kMaxDraws) return (int)cudaErrorInvalidValue;
  const uint64_t draws[kMaxDraws] = {d0, d1, d2, d3, d4, d5, d6, d7};
  Blocks blocks{};
  int k = 0;
  for (int j = 0; j < count; ++j) {
    const uint32_t purpose = (uint32_t)draws[j];
    const int mode = (int)((draws[j] >> 32) & 0xFF);
    const long long offset = (long long)(draws[j] >> 40) * n;
    if (mode < kPair || mode > kSingle) return (int)cudaErrorInvalidValue;
    if (k + (mode == kTriple ? 2 : 1) > kMaxBlocks) return (int)cudaErrorInvalidValue;
    if (mode == kTriple) {
      blocks.b[k++] = Block{purpose, kPair, offset};
      blocks.b[k++] = Block{purpose | kHigh, kSingle, offset + 2 * n};
    } else {
      blocks.b[k++] = Block{purpose, mode, offset};
    }
  }
  if (n <= 0) return (int)cudaSuccess;
  const Operand p{pixel_id, pixel_layout, pixel_value};
  const Operand s{sample_id, sample_layout, sample_value};
  const Operand b{bounce, bounce_layout, bounce_value};
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* t = static_cast<unsigned long long*>(tally);
  switch (k) {
    case 1: launch_blocks<1>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 2: launch_blocks<2>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 3: launch_blocks<3>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 4: launch_blocks<4>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 5: launch_blocks<5>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 6: launch_blocks<6>(p, s, b, blocks, o, n, seed, t, count, st); break;
    case 7: launch_blocks<7>(p, s, b, blocks, o, n, seed, t, count, st); break;
    default: launch_blocks<8>(p, s, b, blocks, o, n, seed, t, count, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
