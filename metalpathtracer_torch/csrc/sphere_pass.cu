// The closest hit's front end, for Hopper: the exact ray-sphere pass and
// every per-lane operand that the tile cull and the closest-hit kernel
// read, in one pass over the rays.
//
// Replaces, in the JAX package, what XLA fuses around its Pallas kernels
// in one jitted bounce step (metalpathtracer_tpu/render/pallas/
// intersect_mm.py): `_sphere_hit_exact` (:1279), `ray_features` (:395) and
// the padding of the rays to whole 128-lane subgroups with the occlusion
// bound (:1340-1356); no Pallas body. In the port these were a kernel and
// some 28 torch kernels a bounce step (render/kernels/intersect_mm.py::
// hit_front_reference). For every lane i < n it tests the ray (o[i], d[i])
// against each of the S spheres (center, radius) with the quadratic of
// render/intersect.py::ray_sphere and keeps the nearest accepted root:
//   oc = o - c; a = d.d; b = oc.d; c' = oc.oc - r*r; disc = b*b - a*c'
//   s = sqrt(max(disc, 0)); t_near = (-b - s) / a; t_far = (-b + s) / a
//   t = disc > 0 && t_near > t_min ? t_near
//     : disc > 0 && t_far > max(3e-5 r, t_min) ? t_far : inf
// and writes t_s[i], slot[i] (the first slot of the smallest t, as
// torch.min picks; 0 where every sphere misses) and idx[i] = ids[slot]
// (-1 where t_s is inf). With the feature pointers (a scene with
// triangles) it also writes, for every lane i < n_pad (n rounded up to
// 128):
//   x[i]   = [d, o x d, o, o.d, |o|^2, 1]  (12 f32, the closest hit's rays)
//   act[i] = active[i] as 1.0 / 0.0, 1.0 without `active`
//   occ[i] = min(t_s[i], occ_t[i]) (NaN-propagating, torch.minimum), t_s[i]
//            without `occ_t`: the lane's occlusion bound for the cull
// and for a padding lane (i >= n) zero features, act 0 and occ +inf.
// Without them (a scene of spheres alone, whose closest hit has no tile
// pass) it writes the sphere winner alone. The sphere's center and
// material id are read by the kernels that need them (hit_epilogue.cu),
// not gathered as rows.
//
// Arithmetic: f32, each operation rounded on its own in the order of the
// plain version (hit_front_reference: render/kernels/shade.py::
// sphere_pass_reference on render/intersect.py::ray_sphere, then
// render/kernels/intersect_mm.py::ray_features, both on core/vecmath.py,
// whose dot products add (x0 + x1) + x2 and whose cross product is three
// differences of two products): the library is built with -fmad=false, so
// no product is contracted into an FMA, and '/' and sqrtf are IEEE-rounded
// (nvcc's default -prec-div and -prec-sqrt); clamps propagate NaN as
// torch.clamp does. The constants are the float32 roundings of the double
// literals the plain version writes. So the kernel is bit-equal to its
// plain version run eagerly on the card.
//
// What bounds it on an H100 SXM. A lane reads o and d (24 B), its active
// flag (1 B) and occlusion bound (4 B), and writes t, idx and slot (12 B),
// x (48 B), act and occ (8 B): ~97 B, 89 MB at 921,600 lanes, ~27 us at
// 3.35 TB/s. The S spheres (16 B each plus their id) are read by every
// lane from L1. Its ~30 flop a sphere are ~4 us at 67 TFLOP/s (8 spheres),
// but each sphere's two IEEE divisions and square root are software
// sequences of some ten instructions each, ~50 instructions a sphere,
// which alone kept the sphere pass at ~2.6x its 12 us of bytes (PERF.md);
// writing the features in the same pass puts the bytes beside that issue
// time instead of in ~28 more launches. Sharing one reciprocal of a
// between the roots would round t otherwise than the plain version does.
// One thread a lane, 256 a block, the spheres read through the read-only
// cache; a feature row is three 16-byte stores; nothing is staged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // a subgroup of the cull and the closest hit

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.minimum: NaN wins
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

struct Args {
  const float *o, *d;
  const bool* active;    // null: every lane is live
  const float* occ_t;    // null: no occlusion bound but the spheres'
  const float *center, *radius;
  const int* ids;
  float* t_out;
  int *idx_out, *slot_out;
  float *x_out, *act_out, *occ_out;  // null: the sphere winner alone
  long long n, n_pad;
  int s;
  float t_min;
};

__global__ void __launch_bounds__(kThreads)
hit_front_kernel(Args a, unsigned long long* __restrict__ tally) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (tally != nullptr && i == 0) atomicAdd(tally, 1ull);
  const bool features = a.x_out != nullptr;
  if (i >= a.n) {
    if (features && i < a.n_pad) {  // a padding lane: enters no tile
      float4* row = reinterpret_cast<float4*>(a.x_out + 12 * i);
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      row[0] = zero;
      row[1] = zero;
      row[2] = zero;
      a.act_out[i] = 0.0f;
      a.occ_out[i] = INFINITY;
    }
    return;
  }
  const float ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  const float aa = (dx * dx + dy * dy) + dz * dz;
  const float inf = INFINITY;
  const float floor_scale = (float)3.0e-5;
  const float t_min = a.t_min;
  float best = inf;
  int slot = 0;
  for (int j = 0; j < a.s; ++j) {
    const float cx = __ldg(a.center + 3 * j), cy = __ldg(a.center + 3 * j + 1),
                cz = __ldg(a.center + 3 * j + 2), r = __ldg(a.radius + j);
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float b = (ocx * dx + ocy * dy) + ocz * dz;
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r;
    const float disc = b * b - aa * c;
    const float root = sqrtf(clamp_min(disc, 0.0f));
    const float t_near = (-b - root) / aa;
    const float t_far = (-b + root) / aa;
    const bool valid = disc > 0.0f;
    const float far_floor = clamp_min(floor_scale * r, t_min);
    const float t = (valid && t_near > t_min) ? t_near
                    : (valid && t_far > far_floor) ? t_far : inf;
    if (t < best) {  // strict: equal t keeps the lowest slot
      best = t;
      slot = j;
    }
  }
  a.t_out[i] = best;
  a.idx_out[i] = isinf(best) ? -1 : __ldg(a.ids + slot);
  a.slot_out[i] = slot;
  if (!features) return;
  // [d, o x d, o, o.d, |o|^2, 1] (ray_features: vm.cross, vm.dot)
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;
  const float od = (ox * dx + oy * dy) + oz * dz;
  const float oo = (ox * ox + oy * oy) + oz * oz;
  float4* row = reinterpret_cast<float4*>(a.x_out + 12 * i);
  row[0] = make_float4(dx, dy, dz, mx);
  row[1] = make_float4(my, mz, ox, oy);
  row[2] = make_float4(oz, od, oo, 1.0f);
  a.act_out[i] = (a.active == nullptr || a.active[i]) ? 1.0f : 0.0f;
  a.occ_out[i] = a.occ_t == nullptr ? best : minimum(best, a.occ_t[i]);
}

}  // namespace

extern "C" int hit_front_launch(const void* o, const void* d, const void* active,
                                const void* occ_t, const void* center,
                                const void* radius, const void* ids, void* t_out,
                                void* idx_out, void* slot_out, void* x_out,
                                void* act_out, void* occ_out, long long n, int s,
                                float t_min, int device, void* stream, void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  const bool features = x_out != nullptr;
  if (features && (act_out == nullptr || occ_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.active = static_cast<const bool*>(active);
  a.occ_t = static_cast<const float*>(occ_t);
  a.center = static_cast<const float*>(center);
  a.radius = static_cast<const float*>(radius);
  a.ids = static_cast<const int*>(ids);
  a.t_out = static_cast<float*>(t_out);
  a.idx_out = static_cast<int*>(idx_out);
  a.slot_out = static_cast<int*>(slot_out);
  a.x_out = static_cast<float*>(x_out);
  a.act_out = static_cast<float*>(act_out);
  a.occ_out = static_cast<float*>(occ_out);
  a.n = n;
  a.n_pad = features ? (n + kLanes - 1) / kLanes * kLanes : n;
  a.s = s;
  a.t_min = t_min;
  if (a.n_pad <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((a.n_pad + kThreads - 1) / kThreads);
  hit_front_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* hit_front_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
