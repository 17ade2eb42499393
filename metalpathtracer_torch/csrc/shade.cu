// The bounce step's shading without next-event estimation, for Hopper: one
// launch does what the plain step does after its closest hit's winners.
//
// Replaces the plain torch shading of the port's `_bounce_step`
// (metalpathtracer_torch/render/integrator.py, with render/bsdf.py's
// `sky_color` and `sample_bsdf`), whose counterpart in the JAX package is
// `_bounce_step` (metalpathtracer_tpu/render/integrator.py:315, with
// render/bsdf.py:80) with `nee` off: no Pallas body, XLA's fusion of the
// closest hit's epilogue (metalpathtracer_tpu/render/pallas/
// intersect_mm.py:1315-1404) and the step's elementwise body. For every
// lane i, from the closest hit's raw winners (the triangle kernel's t_tri
// and col, the sphere pass's t_s, i_s and slot) and its draws (the unit
// vector, the Fresnel and the Russian roulette uniforms of the threefry
// bundle: threefry.cu):
//   the lane computes the epilogue (hit_epilogue.cu: the winner's plane
//   refine from its refine row, the merge with the sphere, the normal
//   flipped to oppose d) in registers first, on the lanes that are live
//   (a dead lane's hit is read by nothing): its hit t, idx, normal,
//   front_face and mat_id, which are neither written nor read back;
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
// One entry, `shade_hit`, launches one of two kernels of the lane body
// (`shade_lane`):
// - `shade_hit_kernel`: the shading alone (the scan, and the wavefront at
//   more than one bounce an advance);
// - `shade_bank_hit_kernel<K>`: the wavefront advance's bounce step at one
//   bounce an advance (render/integrator.py::_Wavefront.advance, whose
//   counterpart in the JAX package's jitted step is integrator.py:702-760):
//   the shading, then in the same thread the advance's bank of the lane's
//   finished path. With its int64 bounce (one a lane), its state alive
//   (bool), schunk (int64) and acc (3 K floats a lane) it computes
//     bounce' = bounce + 1; survivors = hit_live && bounce' < max_depth;
//     done = alive && !survivors; ps = clamp(light, 0, 1) (or light);
//     acc'[slot schunk / spb] = acc + (done ? ps : 0) (every slot adds, 0.0
//     where it is not the path's, as torch's `acc + where(...)` does);
//     light' = done ? 0 : light; schunk + done < per_item ? more : bank;
//     schunk' = done ? (bank ? 0 : schunk + 1) : schunk
//   and writes survivors as the lane's active flag, acc', bounce', schunk',
//   more and bank (render/kernels/shade.py::bank_paths).
// The entry takes the bank's operands and bank_k K > 0, or null bank
// pointers and bank_k 0. Its tally counts every launch in its first slot
// and the launches of `shade_bank_hit_kernel<K>` in its second.
//
// Arithmetic: f32, each operation rounded on its own in the plain
// version's order (render/kernels/shade.py::shade_hit_reference:
// intersect_mm.py::hit_epilogue_reference's order first, a float id
// converted to int by truncation as torch's .to(int32); then
// shade_reference and bank_paths, on render/bsdf.py and core/vecmath.py: a
// dot product's adds run (x0 + x1) + x2; normalize is a * (1 / sqrt(a.a)),
// 0 where a.a <= 1e-20; 1 / x is IEEE-rounded as torch's reciprocal is; a
// scalar constant is the float32 rounding of the plain version's double
// literal); the library is built with -fmad=false, '/' and sqrtf are
// IEEE-rounded, and clamps propagate NaN as torch.clamp does. So each
// kernel is bit-equal to its plain version run eagerly on the card.
//
// Schedule. A lane issues every load it needs before its first store, in
// three rounds of independent loads: (1) its state, its draws, its
// bounce, its winners, and with the bank its bounce, alive flag, item
// chunk and whole accumulator row (16-byte loads where the row is 16-byte
// aligned and a multiple of 4 floats: bank_k 4, 8, 16); (2) the refine row
// (by col) and the sphere's center and material id (by slot); (3) the
// material row (by mat_id). The pointers are __restrict__, and the bank's
// width is a template parameter (bank_k 1, 2, 4, 8 or 16, the widths a
// wavefront picks; the wrapper rejects any other), so the accumulator row
// lives in registers and no load waits on a store. The slot schunk / spb is an unsigned 32-bit division (schunk <
// per_item < 2^31, checked by the wrapper).
//
// What bounds it on an H100 SXM: bytes. A lane reads its state (o, d,
// light, throughput: 48 B; active, prev_pdf: 5 B), its winners (20 B,
// and a 32 B refine row where a triangle won), its draws (16-20 B) and a 64 B
// material row from L1 (the bank has a few rows), and writes 53 B: ~150 B,
// 138 MB at 921,600 lanes, ~41 us at 3.35 TB/s; ~300 flop a lane (~4 us at
// 67 TFLOP/s). The bank adds 18 B of state and 2 x 12 bank_k B of
// accumulator read, and 18 B of state and the accumulator written. One
// thread a lane, 256 a block; the lanes that miss or are dead skip the
// material and the sampling.

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

__device__ __forceinline__ long long bounce_of(const void* __restrict__ bounce,
                                               int layout, long long value,
                                               long long i) {
  if (layout == 0) return value;
  const long long k = layout > 0 ? i : 0;
  if (layout == 8 || layout == -8) return static_cast<const long long*>(bounce)[k];
  return static_cast<const int*>(bounce)[k];
}

struct Args {
  const float *o, *d, *light, *tp;
  const bool* active;
  const float* prev_pdf;
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

// the wavefront advance's bank (`shade_bank_hit_kernel`)
struct Bank {
  const bool* alive;
  const long long* schunk;
  const float* acc;
  float* acc_out;
  long long *bounce_out, *schunk_out;
  bool *more_out, *bank_out;
  long long max_depth, per_item;
  unsigned spb;
  int clamp, bank_k, vec;
};

// the closest hit's raw winners: the triangle kernel's (null without triangles), the sphere pass's, and the
// tables the epilogue reads
struct Winners {
  const float* t_tri;
  const int* col;
  const float* t_s;
  const int *i_s, *slot;
  const float4* refine;
  const float* sph_center;
  const int* sph_mat_id;
  int has_tris, s;
  float t_min;
};

// a lane's hit: t, prim id (-1 on a miss), normal opposing d, front face,
// material id
struct Hit {
  float t;
  int idx;
  Vec normal;
  bool front;
  int mat_id;
};

// the bank's accumulator row of a lane, held in registers: 3 K floats
template <int K>
struct AccRow {
  float v[3 * K];
};

template <>
struct AccRow<0> {};

// hit_epilogue.cu's lane, in registers, from the winners already loaded
// (t_tri, col where there are triangles; t_s, i_s, slot); its own loads
// (the refine row and the sphere's center and material) are the second
// round, and only a live lane makes them
__device__ __forceinline__ Hit epilogue(const Winners& w, bool live, Vec o, Vec d,
                                        float tk, int c, float ts, int is, int k) {
  const float inf = INFINITY;
  Vec center{0.0f, 0.0f, 0.0f};
  int m_s = 0;
  float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r1 = r0;
  const bool tri_row = live && w.has_tris && c >= 0;
  if (live && w.s > 0) {
    center = Vec{__ldg(w.sph_center + 3 * k), __ldg(w.sph_center + 3 * k + 1),
                 __ldg(w.sph_center + 3 * k + 2)};
    m_s = __ldg(w.sph_mat_id + k);
  }
  if (tri_row) {
    r0 = __ldg(w.refine + 2ll * c);
    r1 = __ldg(w.refine + 2ll * c + 1);
  }
  // the sphere's normal at o + t_s d (garbage where the pass missed)
  const Vec sph_n = normalize(sub(add(o, scale(ts, d)), center));
  float tt = inf;
  int i_t = -1, m_t = 0;
  Vec tri_n{0.0f, 0.0f, 0.0f};
  if (tri_row) {  // a lane with col < 0 has no triangle: t inf, id -1
    const Vec nvec{r0.x, r0.y, r0.z};
    const float denom = dot(nvec, d);
    const bool parallel = fabsf(denom) <= (float)1e-5;
    const float t_plane = (r0.w - dot(nvec, o)) / (parallel ? 1.0f : denom);
    const float t_exact = (!parallel && t_plane > w.t_min) ? t_plane : inf;
    // an exact re-test that rejects the kernel's winner keeps the kernel's t
    const bool tri_hit = isfinite(tk);
    tt = tri_hit ? (isfinite(t_exact) ? t_exact : tk) : inf;
    i_t = tri_hit ? (int)r1.x : -1;
    m_t = (int)r1.y;
    tri_n = normalize(nvec);
  }
  const bool tri_wins = tt < ts;
  Vec g = tri_wins ? tri_n : sph_n;
  const bool front = dot(g, d) < 0.0f;
  if (!front) g = neg(g);
  return Hit{tri_wins ? tt : ts, tri_wins ? i_t : is, g, front, tri_wins ? m_t : m_s};
}

template <int K>
__device__ __forceinline__ void shade_lane(const Args& a, const Bank& bk,
                                           const Winners& w,
                                           unsigned long long* __restrict__ tally) {
  __shared__ unsigned warp_live[kThreads / 32];
  constexpr bool kBank = K != 0;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch, counted on the device: a CUDA graph's replay counts too
  // (slot 0 every launch of the entry, slot 1 those of the bank's kernel)
  if (tally != nullptr && i == 0) {
    atomicAdd(tally, 1ull);
    if (kBank) atomicAdd(tally + 1, 1ull);
  }
  const bool in = i < a.n;

  // round 1: every load of the lane's own rows, before any store
  const float* __restrict__ sky = a.sky;
  Vec o{}, d{}, tp{}, light{}, u{}, normal{};
  bool live = false, front = false, alive = false;
  float prev_pdf = 0.0f, t = 0.0f, u_fres = 0.0f, u_rr = 0.0f;
  float tk = 0.0f, ts = 0.0f;
  int idx = -1, mat_id = 0, c = -1, is = -1, k = 0;
  long long bounce = 0, schunk = 0;
  AccRow<K> row;
  if (in) {
    const bool* __restrict__ active = a.active;
    live = active[i];
    o = load3(a.o, i);
    d = load3(a.d, i);
    tp = load3(a.tp, i);
    light = load3(a.light, i);
    const float* __restrict__ pdf = a.prev_pdf;
    prev_pdf = pdf[i];
    u = load3(a.unit_vec, i);
    const float* __restrict__ fres = a.u_fres;
    u_fres = fres[i];
    if (a.rr_start > 0) {
      const float* __restrict__ rr = a.u_rr;
      u_rr = rr[i];
    }
    if (w.has_tris) {
      const float* __restrict__ tt = w.t_tri;
      const int* __restrict__ cc = w.col;
      tk = tt[i];
      c = cc[i];
    }
    const float* __restrict__ t_s = w.t_s;
    const int* __restrict__ i_s = w.i_s;
    const int* __restrict__ slot = w.slot;
    ts = t_s[i];
    is = i_s[i];
    k = slot[i];
    if constexpr (kBank) {
      const long long* __restrict__ b = static_cast<const long long*>(a.bounce);
      const bool* __restrict__ al = bk.alive;
      const long long* __restrict__ sc = bk.schunk;
      bounce = b[i];
      alive = al[i];
      schunk = sc[i];
      const float* __restrict__ acc = bk.acc + 3ll * K * i;
      bool vec = false;
      if constexpr (K % 4 == 0) {
        vec = bk.vec;
        if (vec) {
#pragma unroll
          for (int j = 0; j < 3 * K / 4; ++j) {
            const float4 v = reinterpret_cast<const float4*>(acc)[j];
            row.v[4 * j] = v.x;
            row.v[4 * j + 1] = v.y;
            row.v[4 * j + 2] = v.z;
            row.v[4 * j + 3] = v.w;
          }
        }
      }
      if (!vec) {
#pragma unroll
        for (int j = 0; j < 3 * K; ++j) row.v[j] = acc[j];
      }
    } else if (a.rr_start > 0) {
      bounce = bounce_of(a.bounce, a.bounce_layout, a.bounce_value, i);
    }
  }
  const Vec horizon{__ldg(sky), __ldg(sky + 1), __ldg(sky + 2)};
  const Vec zenith{__ldg(sky + 3), __ldg(sky + 4), __ldg(sky + 5)};

  // rays_counted: the live lanes, one integer add a block
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned block_live = 0;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) block_live += warp_live[wi];
    if (block_live) atomicAdd(a.rays, (unsigned long long)block_live);
  }
  if (!in) return;

  // round 2: the epilogue's rows
  const Hit h = epilogue(w, live, o, d, tk, c, ts, is, k);
  t = h.t;
  idx = h.idx;
  normal = h.normal;
  front = h.front;
  mat_id = h.mat_id;
  const bool miss = idx < 0;

  // sky on a miss: horizon + (zenith - horizon) * 0.5 (d.y + 1)
  const float up = 0.5f * (d.y + 1.0f);
  const Vec sky_rgb = add(horizon, scale(up, sub(zenith, horizon)));
  const bool sky_seen = live && miss;
  light = add(light, sky_seen ? mul(tp, sky_rgb) : Vec{0.0f, 0.0f, 0.0f});

  bool hit_live = live && !miss;
  Vec o_new = o, d_new = d, tp_new = tp;
  if (hit_live) {
    // round 3: the material row
    const float* __restrict__ mrow = a.mat_bank + (long long)mat_id * kMatFloats;
    const Vec albedo{__ldg(mrow), __ldg(mrow + 1), __ldg(mrow + 2)};
    const float mat_type = __ldg(mrow + 3);
    const Vec emission{__ldg(mrow + 4), __ldg(mrow + 5), __ldg(mrow + 6)};
    const float power = __ldg(mrow + 7), fuzz = __ldg(mrow + 8);
    const bool emissive = power > 0.0f || mat_type == 2.0f;
    light = add(light, emissive ? scale(power, mul(tp, emission)) : Vec{0.0f, 0.0f, 0.0f});

    const Vec point = add(o, scale(t, d));
    bool transmitted;
    const Vec dir = sample_bsdf(d, normal, front, mat_type, fuzz, u, u_fres, transmitted);
    const float sign = transmitted ? -1.0f : 1.0f;
    float kk = (float)1e-4 * sign;
    if (a.adaptive) {
      const Vec mag{fabsf(point.x), fabsf(point.y), fabsf(point.z)};
      kk = kk * clamp_min(amax3(mag), 1.0f);
    }
    const Vec origin = add(point, scale(kk, normal));
    Vec through = mul(tp, albedo);
    if (a.rr_start > 0) {
      const float p = clamp(amax3(through), (float)0.05, 1.0f);
      const bool roulette = bounce >= (long long)a.rr_start;
      through = scale(roulette ? 1.0f / p : 1.0f, through);
      hit_live = !roulette || u_rr < p;
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
    const long long bounce_next = bounce + 1;
    still = hit_live && bounce_next < bk.max_depth;
    const bool done = alive && !still;
    const Vec ps = bk.clamp ? Vec{clamp(light.x, 0.0f, 1.0f), clamp(light.y, 0.0f, 1.0f),
                                  clamp(light.z, 0.0f, 1.0f)}
                            : light;
    const int slot = (int)((unsigned)schunk / bk.spb);
    float* __restrict__ acc_out = bk.acc_out + 3ll * K * i;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool here = done && (K == 1 || j == slot);
      row.v[3 * j] = row.v[3 * j] + (here ? ps.x : 0.0f);
      row.v[3 * j + 1] = row.v[3 * j + 1] + (here ? ps.y : 0.0f);
      row.v[3 * j + 2] = row.v[3 * j + 2] + (here ? ps.z : 0.0f);
    }
    bool vec = false;
    if constexpr (K % 4 == 0) {
      vec = bk.vec;
      if (vec) {
#pragma unroll
        for (int j = 0; j < 3 * K / 4; ++j)
          reinterpret_cast<float4*>(acc_out)[j] = make_float4(
              row.v[4 * j], row.v[4 * j + 1], row.v[4 * j + 2], row.v[4 * j + 3]);
      }
    }
    if (!vec) {
#pragma unroll
      for (int j = 0; j < 3 * K; ++j) acc_out[j] = row.v[j];
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
  a.pdf_out[i] = hit_live ? 0.0f : prev_pdf;
}

__global__ void __launch_bounds__(kThreads)
shade_hit_kernel(Args a, Winners w, unsigned long long* __restrict__ tally) {
  shade_lane<0>(a, Bank{}, w, tally);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
shade_bank_hit_kernel(Args a, Bank bk, Winners w, unsigned long long* __restrict__ tally) {
  shade_lane<K>(a, bk, w, tally);
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
                const void* active, const void* prev_pdf, const void* unit_vec,
                const void* u_fres,
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

// the bank's operands (per_item = bank_k * spb, BankPlan's rule, and
// below 2^31: the slot is a 32-bit division)
int bank_of(Bank& bk, const void* alive, const void* schunk, const void* acc,
            void* acc_out, void* bounce_out, void* schunk_out, void* more_out,
            void* bank_out, long long max_depth, int clamp, int bank_k, long long spb,
            long long per_item) {
  if (spb < 1 || per_item != bank_k * spb || per_item >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  bk.alive = static_cast<const bool*>(alive);
  bk.schunk = static_cast<const long long*>(schunk);
  bk.acc = static_cast<const float*>(acc);
  bk.acc_out = static_cast<float*>(acc_out);
  bk.bounce_out = static_cast<long long*>(bounce_out);
  bk.schunk_out = static_cast<long long*>(schunk_out);
  bk.more_out = static_cast<bool*>(more_out);
  bk.bank_out = static_cast<bool*>(bank_out);
  bk.max_depth = max_depth;
  bk.per_item = per_item;
  bk.spb = (unsigned)spb;
  bk.clamp = clamp;
  bk.bank_k = bank_k;
  // 16-byte rows: both bases aligned (every row then is, its width a
  // multiple of 4 floats where the vector path is taken)
  bk.vec = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)acc_out % 16 == 0);
  return (int)cudaSuccess;
}

Winners winners_of(const void* t_tri, const void* col, const void* t_s, const void* i_s,
                   const void* slot, const void* refine, const void* sph_center,
                   const void* sph_mat_id, int has_tris, int s, float t_min) {
  Winners w;
  w.t_tri = static_cast<const float*>(t_tri);
  w.col = static_cast<const int*>(col);
  w.t_s = static_cast<const float*>(t_s);
  w.i_s = static_cast<const int*>(i_s);
  w.slot = static_cast<const int*>(slot);
  w.refine = static_cast<const float4*>(refine);
  w.sph_center = static_cast<const float*>(sph_center);
  w.sph_mat_id = static_cast<const int*>(sph_mat_id);
  w.has_tris = has_tris;
  w.s = s;
  w.t_min = t_min;
  return w;
}

int launch_bank(const Args& a, const Bank& bk, const Winners& w, cudaStream_t stream,
                unsigned long long* tally) {
  const unsigned grid = (unsigned)((a.n + kThreads - 1) / kThreads);
#define MPT_BANK_CASE(K)                                                        \
  case K:                                                                       \
    shade_bank_hit_kernel<K><<<grid, kThreads, 0, stream>>>(a, bk, w, tally);   \
    break;
  switch (bk.bank_k) {
    MPT_BANK_CASE(1)
    MPT_BANK_CASE(2)
    MPT_BANK_CASE(4)
    MPT_BANK_CASE(8)
    MPT_BANK_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MPT_BANK_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// the shading from the closest hit's winners, the epilogue in registers;
// with bank_k > 0 also the wavefront advance's bank, whose `bounce` is
// int64, one a lane (bank_k 0: the bank's pointers are null and unread)
extern "C" int shade_hit_launch(
    const void* o, const void* d, const void* light, const void* tp, const void* active,
    const void* prev_pdf, const void* t_tri, const void* col, const void* t_s,
    const void* i_s, const void* slot, const void* refine, const void* sph_center,
    const void* sph_mat_id, const void* unit_vec, const void* u_fres, const void* u_rr,
    const void* bounce, const void* mat_bank, const void* sky, const void* alive,
    const void* schunk, const void* acc, void* o_out, void* d_out, void* light_out,
    void* tp_out, void* active_out, void* pdf_out, void* rays, void* acc_out,
    void* bounce_out, void* schunk_out, void* more_out, void* bank_out, long long n,
    int has_tris, int s, float t_min, int rr_start, int adaptive, int bounce_layout,
    long long bounce_value, long long max_depth, int clamp, int bank_k, long long spb,
    long long per_item, int device, void* stream, void* tally) {
  int e = set_device(device);
  if (e != (int)cudaSuccess) return e;
  const bool banked = bank_k != 0;
  if ((rr_start > 0 && (u_rr == nullptr || (bounce_layout != 0 && bounce == nullptr))) ||
      (has_tris && (t_tri == nullptr || col == nullptr)) ||
      (banked && (bounce == nullptr || bounce_layout != 8)))
    return (int)cudaErrorInvalidValue;
  Bank bk{};
  if (banked) {
    e = bank_of(bk, alive, schunk, acc, acc_out, bounce_out, schunk_out, more_out,
                bank_out, max_depth, clamp, bank_k, spb, per_item);
    if (e != (int)cudaSuccess) return e;
  }
  if (n <= 0) return (int)cudaSuccess;
  const Args a = shade_args(o, d, light, tp, active, prev_pdf, unit_vec, u_fres, u_rr,
                            bounce, mat_bank, sky, o_out, d_out, light_out, tp_out,
                            active_out, pdf_out, rays, n, rr_start, adaptive,
                            bounce_layout, bounce_value);
  const Winners w = winners_of(t_tri, col, t_s, i_s, slot, refine, sph_center,
                               sph_mat_id, has_tris, s, t_min);
  auto* counted = static_cast<unsigned long long*>(tally);
  if (banked) return launch_bank(a, bk, w, (cudaStream_t)stream, counted);
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  shade_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, w, counted);
  return (int)cudaGetLastError();
}

extern "C" const char* shade_hit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
