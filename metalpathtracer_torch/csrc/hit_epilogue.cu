// The closest hit's epilogue, for Hopper: the triangle winner's plane
// refine, the merge with the sphere pass, and the surface frame.
//
// Replaces the plain torch epilogue of the port's `closest_hit_mm_full`
// (metalpathtracer_torch/render/kernels/intersect_mm.py, after the
// `mm_closest_hit` call), whose counterpart in the JAX package is the
// epilogue of `closest_hit_mm_full`
// (metalpathtracer_tpu/render/pallas/intersect_mm.py:1315-1404): no
// Pallas body, XLA's fusion of a row gather and some 40 elementwise ops.
// For every lane i, with the triangle kernel's (t_tri[i], col[i]) and the
// sphere pass's (t_s[i], i_s[i], slot[i]) (sphere_pass.cu):
//   the winner's refine row [n, n.v0, prim, mat] = refine[max(col, 0)];
//   t_plane = (n.v0 - n.o) / (|n.d| <= 1e-5 ? 1 : n.d), accepted where
//   n.d is not that small and t_plane > t_min; a re-test that rejects the
//   kernel's winner keeps the kernel's t (no edge sparkle); no triangle
//   where col < 0 or t_tri is not finite;
//   the triangle wins where its t < t_s: t, prim id and material id of the
//   winner, its normal (normalize(n), or normalize(o + t_s d - center)
//   for a sphere) flipped to oppose d, and front_face = normal.d < 0.
// Without triangles (`has_tris` 0: t_tri and col are null) every lane
// takes the sphere pass's result; without spheres (s 0) the sphere's
// center and material id are 0. The winner's material id feeds the
// shading kernel (shade.cu), which reads its material row.
//
// Arithmetic: f32, each operation rounded on its own in the order of the
// plain version (render/kernels/shade.py::hit_epilogue_reference, on
// core/vecmath.py: a dot product's adds run (x0 + x1) + x2, a normalize
// is a * (1 / sqrt(a.a)), 0 where a.a <= 1e-20); the library is built
// with -fmad=false and '/' and sqrtf are IEEE-rounded. A float id is
// converted to int by truncation, as torch's .to(int32). So the kernel is
// bit-equal to its plain version run eagerly on the card (NaN aside: a
// lane that misses everything has a NaN normal on both, masked by the
// caller).
//
// What bounds it on an H100 SXM: bytes. A lane reads o, d (24 B), the two
// passes' results (20 B) and one 32 B refine row, and writes 21 B: ~97 B,
// 89 MB at 921,600 lanes, ~27 us at 3.35 TB/s; the row is the only
// scattered read (two 16 B loads of one 32 B sector pair). One thread a
// lane, 256 a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

// a * (1 / sqrt(a.a)), 0 where a.a <= 1e-20 (core/vecmath.py::normalize)
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n2 = dot3(x, y, z, x, y, z);
  const float inv = n2 > (float)1e-20 ? 1.0f / sqrtf(n2) : 0.0f;
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__global__ void __launch_bounds__(kThreads)
hit_epilogue_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_tri, const int* __restrict__ col,
                    const float* __restrict__ t_sph, const int* __restrict__ i_sph,
                    const int* __restrict__ slot, const float4* __restrict__ refine,
                    const float* __restrict__ sph_center,
                    const int* __restrict__ sph_mat_id, float* __restrict__ t_out,
                    int* __restrict__ idx_out, float* __restrict__ normal_out,
                    bool* __restrict__ front_out, int* __restrict__ mat_out,
                    long long n, int has_tris, int s, float t_min,
                    unsigned long long* __restrict__ tally) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (tally != nullptr && i == 0) atomicAdd(tally, 1ull);
  if (i >= n) return;
  const float inf = INFINITY;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ts = t_sph[i];

  // the sphere's normal at o + t_s d (garbage where the pass missed)
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  int m_s = 0;
  if (s > 0) {
    const int k = slot[i];
    cx = __ldg(sph_center + 3 * k);
    cy = __ldg(sph_center + 3 * k + 1);
    cz = __ldg(sph_center + 3 * k + 2);
    m_s = __ldg(sph_mat_id + k);
  }
  float sx = (ox + ts * dx) - cx, sy = (oy + ts * dy) - cy, sz = (oz + ts * dz) - cz;
  normalize3(sx, sy, sz);

  float tt = inf, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int i_t = -1, m_t = 0;
  if (has_tris) {
    const int c = col[i];
    const long long row = c > 0 ? c : 0;
    const float4 r0 = refine[2 * row], r1 = refine[2 * row + 1];
    nx = r0.x;
    ny = r0.y;
    nz = r0.z;
    i_t = (int)r1.x;
    m_t = (int)r1.y;
    const float denom = dot3(nx, ny, nz, dx, dy, dz);
    const bool parallel = fabsf(denom) <= (float)1e-5;
    const float t_plane = (r0.w - dot3(nx, ny, nz, ox, oy, oz)) / (parallel ? 1.0f : denom);
    const float t_exact = (!parallel && t_plane > t_min) ? t_plane : inf;
    const float tk = t_tri[i];
    const bool tri_hit = c >= 0 && isfinite(tk);
    tt = tri_hit ? (isfinite(t_exact) ? t_exact : tk) : inf;
    i_t = tri_hit ? i_t : -1;
    normalize3(nx, ny, nz);
  }

  const bool tri_wins = tt < ts;
  float gx = tri_wins ? nx : sx, gy = tri_wins ? ny : sy, gz = tri_wins ? nz : sz;
  const bool front = dot3(gx, gy, gz, dx, dy, dz) < 0.0f;
  if (!front) {
    gx = -gx;
    gy = -gy;
    gz = -gz;
  }
  t_out[i] = tri_wins ? tt : ts;
  idx_out[i] = tri_wins ? i_t : i_sph[i];
  mat_out[i] = tri_wins ? m_t : m_s;
  normal_out[3 * i] = gx;
  normal_out[3 * i + 1] = gy;
  normal_out[3 * i + 2] = gz;
  front_out[i] = front;
}

}  // namespace

extern "C" int hit_epilogue_launch(const void* o, const void* d, const void* t_tri,
                                   const void* col, const void* t_sph,
                                   const void* i_sph, const void* slot,
                                   const void* refine, const void* sph_center,
                                   const void* sph_mat_id, void* t_out,
                                   void* idx_out, void* normal_out,
                                   void* front_out, void* mat_out, long long n,
                                   int has_tris, int s, float t_min, int device,
                                   void* stream, void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  hit_epilogue_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_tri), static_cast<const int*>(col),
      static_cast<const float*>(t_sph), static_cast<const int*>(i_sph),
      static_cast<const int*>(slot), static_cast<const float4*>(refine),
      static_cast<const float*>(sph_center), static_cast<const int*>(sph_mat_id),
      static_cast<float*>(t_out), static_cast<int*>(idx_out),
      static_cast<float*>(normal_out), static_cast<bool*>(front_out),
      static_cast<int*>(mat_out), n, has_tris, s, t_min,
      static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* hit_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
