// The bounce step's shading without next-event estimation, for Hopper: one
// launch does what the plain step does after its closest hit.
//
// Replaces the plain torch shading of the port's `_bounce_step`
// (metalpathtracer_torch/render/integrator.py, with render/bsdf.py's
// `sky_color` and `sample_bsdf`), whose counterpart in the JAX package is
// `_bounce_step` (metalpathtracer_tpu/render/integrator.py:315, with
// render/bsdf.py:80) with `nee` off: no Pallas body, XLA's fusion of the
// step's elementwise body. For every lane i, with its hit (t, idx, normal,
// front_face, mat_id: hit_epilogue.cu) and its draws (the unit vector, the
// Fresnel and the Russian roulette uniforms of the threefry bundle:
// threefry.cu):
//   a live lane that missed adds throughput * sky(d) to its light;
//   a live lane that hit reads its material row mat_bank[mat_id]
//   [albedo, type, emission, power, fuzz], adds throughput * emission *
//   power where it emits (power > 0 or type 2), samples the scatter
//   (sample_bsdf: the Lambertian lobe normalize(n + u), the fuzzy mirror
//   normalize(reflect + fuzz u), or the dielectric's Schlick choice
//   between reflection and refraction; the dielectric's transmission
//   offsets the origin below the surface), moves its origin to the hit
//   point offset 1e-4 along the normal (times max(1, max |p|) with
//   `adaptive`), multiplies its throughput by the albedo and, from bounce
//   rr_start on (rr_start > 0), survives Russian roulette with p =
//   clamp(max(throughput), 0.05, 1), its throughput divided by p;
//   o, d, throughput and prev_pdf (0: no light sampling) change on the
//   lanes that stay live, light on every lane (+ 0.0 where nothing is
//   added), and active becomes "hit, and survived";
//   `rays` (one int64, zeroed by the caller) gains the count of live lanes:
//   each block adds its count once (a warp's ballot, then one atomicAdd a
//   block), an integer sum, so exact in any order.
// `bounce` is a value (layout 0), one element every lane reads (layout -4
// or -8: int32 or int64) or one a lane (4 or 8), as the scan's 0-d bounce
// and the wavefront's per-lane bounces are.
//
// A second entry, `shade_bank`, is the wavefront advance's bounce step at
// one bounce an advance (render/integrator.py::_Wavefront.advance, whose
// counterpart in the JAX package's jitted step is integrator.py:702-760):
// the same shading, then in the same thread the advance's bank of the
// lane's finished path. With its int64 bounce (one a lane), its state alive
// (bool), schunk (int64) and acc (3 bank_k floats a lane) it computes
//   bounce' = bounce + 1; survivors = hit_live && bounce' < max_depth;
//   done = alive && !survivors; ps = clamp(light, 0, 1) (or light);
//   acc'[slot schunk / spb] = acc + (done ? ps : 0) (every slot adds, 0.0
//   where it is not the path's, as torch's `acc + where(...)` does);
//   light' = done ? 0 : light; schunk + done < per_item ? more : bank;
//   schunk' = done ? (bank ? 0 : schunk + 1) : schunk
// and writes survivors as the lane's active flag, acc', bounce', schunk',
// more and bank (render/kernels/shade.py::bank_paths).
//
// Arithmetic: f32, each operation rounded on its own in the plain
// version's order (render/kernels/shade.py::shade_reference, on
// render/bsdf.py and core/vecmath.py: a dot product's adds run
// (x0 + x1) + x2; normalize is a * (1 / sqrt(a.a)), 0 where a.a <= 1e-20;
// 1 / x is IEEE-rounded as torch's reciprocal is; a scalar constant is the
// float32 rounding of the plain version's double literal); the library is
// built with -fmad=false, '/' and sqrtf are IEEE-rounded, and clamps
// propagate NaN as torch.clamp does. So the kernel is bit-equal to its
// plain version run eagerly on the card.
//
// What bounds it on an H100 SXM: bytes. A lane reads its state (o, d,
// light, throughput: 48 B; active, prev_pdf: 5 B), its hit (t, idx,
// normal, front_face, mat_id: 25 B), its draws (16-20 B) and a 64 B
// material row from L1 (the bank has a few rows), and writes 53 B: ~150 B,
// 138 MB at 921,600 lanes, ~41 us at 3.35 TB/s; ~300 flop a lane (~4 us at
// 67 TFLOP/s). `shade_bank` adds 18 B of state and 2 x 12 bank_k B of
// accumulator read, and 18 B of state and the accumulator written, which
// the bank's ~33 torch kernels each read and wrote again. One thread a
// lane, 256 a block; the lanes that miss or are dead skip the material and
// the sampling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMatFloats = 16;  // a material-bank row

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* __restrict__ p, long long i) {
  return Vec{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, long long i, Vec v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ Vec add(Vec a, Vec b) { return Vec{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ Vec sub(Vec a, Vec b) { return Vec{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ Vec mul(Vec a, Vec b) { return Vec{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ Vec scale(float k, Vec a) { return Vec{k * a.x, k * a.y, k * a.z}; }
__device__ __forceinline__ Vec neg(Vec a) { return Vec{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ Vec pick(bool c, Vec a, Vec b) { return c ? a : b; }

// (a0 b0 + a1 b1) + a2 b2 (core/vecmath.py::dot)
__device__ __forceinline__ float dot(Vec a, Vec b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// a * (1 / sqrt(a.a)), 0 where a.a <= 1e-20 (core/vecmath.py::normalize)
__device__ __forceinline__ Vec normalize(Vec a) {
  const float n2 = dot(a, a);
  const float inv = n2 > (float)1e-20 ? 1.0f / sqrtf(n2) : 0.0f;
  return Vec{a.x * inv, a.y * inv, a.z * inv};
}

// torch.clamp's: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch's amax over three: NaN wins
__device__ __forceinline__ float amax3(Vec a) {
  if (isnan(a.x) || isnan(a.y) || isnan(a.z)) return NAN;
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

// d - (2 d.n) n (core/vecmath.py::reflect)
__device__ __forceinline__ Vec reflect(Vec d, Vec n) {
  return sub(d, scale(2.0f * dot(d, n), n));
}

// GLSL refract, 0 on total internal reflection (core/vecmath.py::refract)
__device__ __forceinline__ Vec refract(Vec d, Vec n, float eta) {
  const float cos_i = -dot(d, n);
  const float sin2_t = (eta * eta) * clamp_min(1.0f - cos_i * cos_i, 0.0f);
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const Vec refr = add(scale(eta, d), scale(eta * cos_i - cos_t, n));
  return sin2_t > 1.0f ? Vec{0.0f, 0.0f, 0.0f} : refr;
}

// Schlick's reflectance, the fifth power as x * ((x x) (x x))
// (core/vecmath.py::schlick_reflectance)
__device__ __forceinline__ float schlick(float cos_theta, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  const float x = 1.0f - cos_theta;
  const float x2 = x * x;
  return r0 + (1.0f - r0) * (x * (x2 * x2));
}

// render/bsdf.py::sample_bsdf: the scattered direction, and whether the
// ray was transmitted
__device__ __forceinline__ Vec sample_bsdf(Vec d, Vec n, bool front, float mat_type,
                                           float fuzz, Vec u, float u_fresnel,
                                           bool& transmitted) {
  const bool is_dielectric = mat_type > 0.0f && mat_type != 2.0f;
  const bool is_mirror = mat_type < 0.0f;
  Vec lam = normalize(add(n, u));
  lam = dot(lam, lam) > (float)1e-12 ? lam : n;
  const Vec refl = reflect(d, n);
  const Vec refl_n = normalize(refl);
  Vec mirror = normalize(add(refl, scale(fuzz, u)));
  mirror = dot(mirror, n) > 0.0f ? mirror : refl_n;
  const float ior = is_dielectric ? mat_type : (float)1.5;
  const float eta = front ? 1.0f / ior : ior;
  const float cos_theta = clamp(dot(neg(d), n), 0.0f, 1.0f);
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const bool cannot_refract = eta * sin_theta > 1.0f;
  const bool choose_reflect = cannot_refract || schlick(cos_theta, eta) > u_fresnel;
  const Vec diel = choose_reflect ? refl_n : normalize(refract(d, n, eta));
  transmitted = is_dielectric && !choose_reflect;
  return is_dielectric ? diel : (is_mirror ? mirror : lam);
}

__device__ __forceinline__ long long bounce_of(const void* bounce, int layout,
                                               long long value, long long i) {
  if (layout == 0) return value;
  const long long k = layout > 0 ? i : 0;
  if (layout == 8 || layout == -8) return static_cast<const long long*>(bounce)[k];
  return static_cast<const int*>(bounce)[k];
}

struct Args {
  const float *o, *d, *light, *tp;
  const bool* active;
  const float *prev_pdf, *t;
  const int* idx;
  const float* normal;
  const bool* front;
  const int* mat_id;
  const float *unit_vec, *u_fres, *u_rr;
  const void* bounce;
  const float *mat_bank, *sky;
  float *o_out, *d_out, *light_out, *tp_out;
  bool* active_out;
  float* pdf_out;
  unsigned long long* rays;
  long long n, bounce_value;
  int rr_start, adaptive, bounce_layout;
};

// the wavefront advance's bank (`shade_bank`)
struct Bank {
  const bool* alive;
  const long long* schunk;
  const float* acc;
  float* acc_out;
  long long *bounce_out, *schunk_out;
  bool *more_out, *bank_out;
  long long max_depth, spb, per_item;
  int clamp, bank_k;
};

template <bool kBank>
__device__ __forceinline__ void shade_lane(const Args& a, const Bank& bk,
                                           unsigned long long* __restrict__ tally) {
  __shared__ unsigned warp_live[kThreads / 32];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (tally != nullptr && i == 0) atomicAdd(tally, 1ull);
  const bool in = i < a.n;
  const bool live = in && a.active[i];

  // rays_counted: the live lanes, one integer add a block
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned block_live = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) block_live += warp_live[w];
    if (block_live) atomicAdd(a.rays, (unsigned long long)block_live);
  }
  if (!in) return;

  const Vec o = load3(a.o, i), d = load3(a.d, i), tp = load3(a.tp, i);
  Vec light = load3(a.light, i);
  const bool miss = a.idx[i] < 0;

  // sky on a miss: horizon + (zenith - horizon) * 0.5 (d.y + 1)
  const Vec horizon{__ldg(a.sky), __ldg(a.sky + 1), __ldg(a.sky + 2)};
  const Vec zenith{__ldg(a.sky + 3), __ldg(a.sky + 4), __ldg(a.sky + 5)};
  const float up = 0.5f * (d.y + 1.0f);
  const Vec sky = add(horizon, scale(up, sub(zenith, horizon)));
  const bool sky_seen = live && miss;
  light = add(light, sky_seen ? mul(tp, sky) : Vec{0.0f, 0.0f, 0.0f});

  bool hit_live = live && !miss;
  Vec o_new = o, d_new = d, tp_new = tp;
  if (hit_live) {
    const float* row = a.mat_bank + (long long)a.mat_id[i] * kMatFloats;
    const Vec albedo{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
    const float mat_type = __ldg(row + 3);
    const Vec emission{__ldg(row + 4), __ldg(row + 5), __ldg(row + 6)};
    const float power = __ldg(row + 7), fuzz = __ldg(row + 8);
    const bool emissive = power > 0.0f || mat_type == 2.0f;
    light = add(light, emissive ? scale(power, mul(tp, emission)) : Vec{0.0f, 0.0f, 0.0f});

    const float t = a.t[i];
    const Vec point = add(o, scale(t, d));
    const Vec normal = load3(a.normal, i);
    bool transmitted;
    const Vec dir = sample_bsdf(d, normal, a.front[i], mat_type, fuzz,
                                load3(a.unit_vec, i), a.u_fres[i], transmitted);
    const float sign = transmitted ? -1.0f : 1.0f;
    float k = (float)1e-4 * sign;
    if (a.adaptive) {
      const Vec mag{fabsf(point.x), fabsf(point.y), fabsf(point.z)};
      k = k * clamp_min(amax3(mag), 1.0f);
    }
    const Vec origin = add(point, scale(k, normal));
    Vec through = mul(tp, albedo);
    if (a.rr_start > 0) {
      const float p = clamp(amax3(through), (float)0.05, 1.0f);
      const bool roulette = bounce_of(a.bounce, a.bounce_layout, a.bounce_value, i) >=
                            (long long)a.rr_start;
      through = scale(roulette ? 1.0f / p : 1.0f, through);
      hit_live = !roulette || a.u_rr[i] < p;
    }
    if (hit_live) {
      o_new = origin;
      d_new = dir;
      tp_new = through;
    }
  } else {
    light = add(light, Vec{0.0f, 0.0f, 0.0f});
  }
  bool still = hit_live;
  if constexpr (kBank) {  // the advance's bank (render/kernels/shade.py::bank_paths)
    const long long bounce_next = static_cast<const long long*>(a.bounce)[i] + 1;
    still = hit_live && bounce_next < bk.max_depth;
    const bool done = bk.alive[i] && !still;
    const Vec ps = bk.clamp ? Vec{clamp(light.x, 0.0f, 1.0f), clamp(light.y, 0.0f, 1.0f),
                                  clamp(light.z, 0.0f, 1.0f)}
                            : light;
    const long long schunk = bk.schunk[i];
    const long long ka = 3ll * bk.bank_k;
    const float* acc = bk.acc + ka * i;
    float* acc_out = bk.acc_out + ka * i;
    const long long slot = bk.bank_k == 1 ? 0 : schunk / bk.spb;
    for (int k = 0; k < bk.bank_k; ++k) {
      const bool here = done && k == slot;
      acc_out[3 * k] = acc[3 * k] + (here ? ps.x : 0.0f);
      acc_out[3 * k + 1] = acc[3 * k + 1] + (here ? ps.y : 0.0f);
      acc_out[3 * k + 2] = acc[3 * k + 2] + (here ? ps.z : 0.0f);
    }
    if (done) light = Vec{0.0f, 0.0f, 0.0f};
    const long long schunk_next = schunk + (done ? 1 : 0);
    const bool more = done && schunk_next < bk.per_item;
    const bool bank = done && !more;
    bk.schunk_out[i] = done ? (bank ? 0 : schunk_next) : schunk;
    bk.bounce_out[i] = bounce_next;
    bk.more_out[i] = more;
    bk.bank_out[i] = bank;
  }
  store3(a.o_out, i, o_new);
  store3(a.d_out, i, d_new);
  store3(a.light_out, i, light);
  store3(a.tp_out, i, tp_new);
  a.active_out[i] = still;
  a.pdf_out[i] = hit_live ? 0.0f : a.prev_pdf[i];
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(Args a, unsigned long long* __restrict__ tally) {
  shade_lane<false>(a, Bank{}, tally);
}

__global__ void __launch_bounds__(kThreads)
shade_bank_kernel(Args a, Bank bk, unsigned long long* __restrict__ tally) {
  shade_lane<true>(a, bk, tally);
}

int set_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

Args shade_args(const void* o, const void* d, const void* light, const void* tp,
                const void* active, const void* prev_pdf, const void* t,
                const void* idx, const void* normal, const void* front_face,
                const void* mat_id, const void* unit_vec, const void* u_fres,
                const void* u_rr, const void* bounce, const void* mat_bank,
                const void* sky, void* o_out, void* d_out, void* light_out,
                void* tp_out, void* active_out, void* pdf_out, void* rays,
                long long n, int rr_start, int adaptive, int bounce_layout,
                long long bounce_value) {
  Args a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.light = static_cast<const float*>(light);
  a.tp = static_cast<const float*>(tp);
  a.active = static_cast<const bool*>(active);
  a.prev_pdf = static_cast<const float*>(prev_pdf);
  a.t = static_cast<const float*>(t);
  a.idx = static_cast<const int*>(idx);
  a.normal = static_cast<const float*>(normal);
  a.front = static_cast<const bool*>(front_face);
  a.mat_id = static_cast<const int*>(mat_id);
  a.unit_vec = static_cast<const float*>(unit_vec);
  a.u_fres = static_cast<const float*>(u_fres);
  a.u_rr = static_cast<const float*>(u_rr);
  a.bounce = bounce;
  a.mat_bank = static_cast<const float*>(mat_bank);
  a.sky = static_cast<const float*>(sky);
  a.o_out = static_cast<float*>(o_out);
  a.d_out = static_cast<float*>(d_out);
  a.light_out = static_cast<float*>(light_out);
  a.tp_out = static_cast<float*>(tp_out);
  a.active_out = static_cast<bool*>(active_out);
  a.pdf_out = static_cast<float*>(pdf_out);
  a.rays = static_cast<unsigned long long*>(rays);
  a.n = n;
  a.bounce_value = bounce_value;
  a.rr_start = rr_start;
  a.adaptive = adaptive;
  a.bounce_layout = bounce_layout;
  return a;
}

}  // namespace

extern "C" int shade_launch(const void* o, const void* d, const void* light,
                            const void* tp, const void* active, const void* prev_pdf,
                            const void* t, const void* idx, const void* normal,
                            const void* front_face, const void* mat_id,
                            const void* unit_vec, const void* u_fres,
                            const void* u_rr, const void* bounce,
                            const void* mat_bank, const void* sky, void* o_out,
                            void* d_out, void* light_out, void* tp_out,
                            void* active_out, void* pdf_out, void* rays,
                            long long n, int rr_start, int adaptive,
                            int bounce_layout, long long bounce_value, int device,
                            void* stream, void* tally) {
  int e = set_device(device);
  if (e != (int)cudaSuccess) return e;
  if (rr_start > 0 && (u_rr == nullptr || (bounce_layout != 0 && bounce == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const Args a = shade_args(o, d, light, tp, active, prev_pdf, t, idx, normal, front_face,
                            mat_id, unit_vec, u_fres, u_rr, bounce, mat_bank, sky, o_out,
                            d_out, light_out, tp_out, active_out, pdf_out, rays, n,
                            rr_start, adaptive, bounce_layout, bounce_value);
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  shade_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

// the shading and the advance's bank: `bounce` is int64, one a lane
extern "C" int shade_bank_launch(const void* o, const void* d, const void* light,
                                 const void* tp, const void* active,
                                 const void* prev_pdf, const void* t, const void* idx,
                                 const void* normal, const void* front_face,
                                 const void* mat_id, const void* unit_vec,
                                 const void* u_fres, const void* u_rr,
                                 const void* bounce, const void* mat_bank,
                                 const void* sky, const void* alive,
                                 const void* schunk, const void* acc, void* o_out,
                                 void* d_out, void* light_out, void* tp_out,
                                 void* active_out, void* pdf_out, void* rays,
                                 void* acc_out, void* bounce_out, void* schunk_out,
                                 void* more_out, void* bank_out, long long n,
                                 int rr_start, int adaptive, long long max_depth,
                                 int clamp, int bank_k, long long spb,
                                 long long per_item, int device, void* stream,
                                 void* tally) {
  int e = set_device(device);
  if (e != (int)cudaSuccess) return e;
  if (bounce == nullptr || (rr_start > 0 && u_rr == nullptr) || bank_k < 1 || spb < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const Args a = shade_args(o, d, light, tp, active, prev_pdf, t, idx, normal, front_face,
                            mat_id, unit_vec, u_fres, u_rr, bounce, mat_bank, sky, o_out,
                            d_out, light_out, tp_out, active_out, pdf_out, rays, n,
                            rr_start, adaptive, 8, 0);
  Bank bk;
  bk.alive = static_cast<const bool*>(alive);
  bk.schunk = static_cast<const long long*>(schunk);
  bk.acc = static_cast<const float*>(acc);
  bk.acc_out = static_cast<float*>(acc_out);
  bk.bounce_out = static_cast<long long*>(bounce_out);
  bk.schunk_out = static_cast<long long*>(schunk_out);
  bk.more_out = static_cast<bool*>(more_out);
  bk.bank_out = static_cast<bool*>(bank_out);
  bk.max_depth = max_depth;
  bk.spb = spb;
  bk.per_item = per_item;
  bk.clamp = clamp;
  bk.bank_k = bank_k;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  shade_bank_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, bk, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* shade_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
