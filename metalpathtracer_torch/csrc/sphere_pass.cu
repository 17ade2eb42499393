// The exact ray-sphere pass of the closest hit, for Hopper.
//
// Replaces the plain torch pass `_sphere_hit_exact` of the port
// (metalpathtracer_torch/render/kernels/intersect_mm.py), whose
// counterpart in the JAX package is `_sphere_hit_exact`
// (metalpathtracer_tpu/render/pallas/intersect_mm.py:1279): no Pallas
// body, XLA's fusion of a dense (N, S) quadratic and its masked reduces.
// For every lane i it tests the ray (o[i], d[i]) against each of the S
// spheres (center, radius) with the quadratic of
// render/intersect.py::ray_sphere and keeps the nearest accepted root:
//   oc = o - c; a = d.d; b = oc.d; c' = oc.oc - r*r; disc = b*b - a*c'
//   s = sqrt(max(disc, 0)); t_near = (-b - s) / a; t_far = (-b + s) / a
//   t = disc > 0 && t_near > t_min ? t_near
//     : disc > 0 && t_far > max(3e-5 r, t_min) ? t_far : inf
// and writes t_s[i], slot[i] (the first slot of the smallest t, as
// torch.min picks; 0 where every sphere misses) and idx[i] = ids[slot]
// (-1 where t_s is inf). The sphere's center and material id are read by
// the kernels that need them (hit_epilogue.cu), not gathered as rows.
//
// Arithmetic: f32, each operation rounded on its own in the order of the
// plain version (render/kernels/shade.py::sphere_pass_reference on
// render/intersect.py::ray_sphere and core/vecmath.py::dot, whose adds run
// (x0 + x1) + x2): the library is built with -fmad=false, so no product
// is contracted into an FMA, and '/' and sqrtf are IEEE-rounded (nvcc's
// default -prec-div and -prec-sqrt); clamps propagate NaN as torch.clamp
// does. The constants are the float32 roundings of the double literals
// the plain version writes. So the kernel is bit-equal to its plain
// version run eagerly on the card.
//
// What bounds it on an H100 SXM: the instructions it issues. A lane reads
// o and d (24 B) and writes t, idx and slot (12 B); the S spheres (16 B
// each plus their id) are read by every lane from L1: at 921,600 lanes 33
// MB, ~10 us at 3.35 TB/s. Its ~30 flop a sphere are ~4 us at 67 TFLOP/s
// (8 spheres), but each sphere's two IEEE divisions and square root are
// software sequences of some ten instructions each, so the kernel issues
// ~50 instructions a sphere and runs at ~2.6x its byte bound (PERF.md).
// Sharing one reciprocal of a between the roots would round t otherwise
// than the plain version does. One thread a lane, 256 a block, the spheres
// read through the read-only cache; nothing is staged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__global__ void __launch_bounds__(kThreads)
sphere_pass_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ center,
                   const float* __restrict__ radius,
                   const int* __restrict__ ids, float* __restrict__ t_out,
                   int* __restrict__ idx_out, int* __restrict__ slot_out,
                   long long n, int s, float t_min,
                   unsigned long long* __restrict__ tally) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (tally != nullptr && i == 0) atomicAdd(tally, 1ull);
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float a = (dx * dx + dy * dy) + dz * dz;
  const float inf = INFINITY;
  const float floor_scale = (float)3.0e-5;
  float best = inf;
  int slot = 0;
  for (int j = 0; j < s; ++j) {
    const float cx = __ldg(center + 3 * j), cy = __ldg(center + 3 * j + 1),
                cz = __ldg(center + 3 * j + 2), r = __ldg(radius + j);
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float b = (ocx * dx + ocy * dy) + ocz * dz;
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r;
    const float disc = b * b - a * c;
    const float root = sqrtf(clamp_min(disc, 0.0f));
    const float t_near = (-b - root) / a;
    const float t_far = (-b + root) / a;
    const bool valid = disc > 0.0f;
    const float far_floor = clamp_min(floor_scale * r, t_min);
    const float t = (valid && t_near > t_min) ? t_near
                    : (valid && t_far > far_floor) ? t_far : inf;
    if (t < best) {  // strict: equal t keeps the lowest slot
      best = t;
      slot = j;
    }
  }
  t_out[i] = best;
  idx_out[i] = isinf(best) ? -1 : __ldg(ids + slot);
  slot_out[i] = slot;
}

}  // namespace

extern "C" int sphere_pass_launch(const void* o, const void* d,
                                  const void* center, const void* radius,
                                  const void* ids, void* t_out, void* idx_out,
                                  void* slot_out, long long n, int s,
                                  float t_min, int device, void* stream,
                                  void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  sphere_pass_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(center), static_cast<const float*>(radius),
      static_cast<const int*>(ids), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<int*>(slot_out), n, s, t_min,
      static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* sphere_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
