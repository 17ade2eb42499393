// Ray vs tile-AABB cull with per-subgroup reductions, for Hopper.
//
// Replaces the Pallas kernel _cull_kernel of the JAX reference
// (metalpathtracer_tpu/render/pallas/intersect_mm.py, launched from
// _cull_pass). For every 128-lane subgroup g and tile j it computes
//   sgm[g, j]  = does any lane of g enter tile j's box?
//   gent[g, j] = the smallest entry distance of those lanes (+inf if none)
// and for every lane the largest entry distance over the tiles it enters
// (lane_bound, -inf if none). These are what the entry-ordered tile lists
// and the closest-hit kernel's early exit need; the (n_tiles, N) slab test
// behind them never leaves registers.
//
// Arithmetic, as the reference kernel's, so that the plain torch version
// (render/kernels/intersect_mm.py::cull_pass_reference) is bit-equal:
//   inv = clip(1/d, -1e30, 1e30)    IEEE division; no inf * 0 NaN below
//   occ = active > 0.5 ? occ : -inf  (an inactive lane enters nothing)
//   per axis t0 = (lo - o) * inv, t1 = (hi - o) * inv;
//   en = max(min(t0x, t1x), t_min), ex = max(t0x, t1x), then
//   en = max(en, min(t0, t1)), ex = min(ex, max(t0, t1)) for y and z;
//   hit = ex >= en && en <= occ.
// The reference tests ex > en, which no ray passes for a flat box (lo ==
// hi on one axis: en == ex where the ray crosses the plane), so the tile of
// an axis-aligned planar mesh was never entered and its triangles never
// hit. With >= a ray that only grazes a box's edge enters it, which costs
// work and changes no closest hit.
// min and max propagate NaN as torch.minimum/maximum do (CUDA's fminf and
// fmaxf drop it), so a NaN entry never hits on either side. A hit's entry
// is never NaN, so the reductions over hits may use fminf/fmaxf.
//
// Work split: one block of 128 threads per subgroup, one ray per thread.
// Tile boxes are staged through shared memory kTileChunk at a time. Each
// thread keeps its lane's max entry in a register; each warp reduces a
// tile's any-hit with a ballot and its min entry with shuffles, and the
// four warps combine through shared memory, two barriers per chunk.
//
// What bounds it on an H100: issue rate on the (ray, tile) pairs -- ~20
// floating-point operations for the slab test and a 5-step shuffle
// reduction per pair. The inputs (48 B per ray, 32 B per tile) and outputs
// (5 B per subgroup and tile) are small next to that. A transposed warp
// reduction (one shuffle per tile instead of five) is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // rays per subgroup = threads per block
constexpr int kWarps = kLanes / 32;
constexpr int kFeatures = 12;    // x = [d, o x d, o, o.d, |o|^2, 1]
constexpr int kBoxFloats = 8;    // tile_box row [lo3, 0, hi3, 0]
constexpr int kTileChunk = 128;  // tiles staged per chunk
constexpr float kRecipClip = 1e30f;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;  // NaN if either is NaN
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kLanes)
cull_tiles_kernel(const float* __restrict__ x,         // (G*128, 12)
                  const float* __restrict__ active,    // (G*128,)
                  const float* __restrict__ occ,       // (G*128,) or null
                  const float* __restrict__ tile_box,  // (n_tiles, 8)
                  uint8_t* __restrict__ sgm,           // (G, n_tiles)
                  float* __restrict__ gent,            // (G, n_tiles)
                  float* __restrict__ lane_bound,      // (G*128,)
                  int n_tiles, float t_min) {
  __shared__ float sbox[6][kTileChunk];         // lo xyz, hi xyz
  __shared__ float smin[kWarps][kTileChunk];    // per-warp min entry
  __shared__ uint32_t sany[kWarps][kTileChunk]; // per-warp any-hit

  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t ray = (size_t)g * kLanes + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  const float* xr = x + ray * kFeatures;
  float o[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = xr[6 + a];
    inv[a] = nan_max(nan_min(__fdiv_rn(1.0f, xr[a]), kRecipClip), -kRecipClip);
  }
  const float occ_in = occ ? occ[ray] : inf;
  const float bound = active[ray] > 0.5f ? occ_in : -inf;
  float lb = -inf;

  for (int c0 = 0; c0 < n_tiles; c0 += kTileChunk) {
    const int w = min(kTileChunk, n_tiles - c0);
    for (int k = threadIdx.x; k < 6 * w; k += kLanes) {
      const int j = k / 6, f = k % 6;  // f: lo x, y, z, hi x, y, z
      sbox[f][j] = tile_box[(size_t)(c0 + j) * kBoxFloats + (f < 3 ? f : f + 1)];
    }
    __syncthreads();

    for (int j = 0; j < w; ++j) {
      float t0 = (sbox[0][j] - o[0]) * inv[0];
      float t1 = (sbox[3][j] - o[0]) * inv[0];
      float en = nan_max(nan_min(t0, t1), t_min);
      float ex = nan_max(t0, t1);
      t0 = (sbox[1][j] - o[1]) * inv[1];
      t1 = (sbox[4][j] - o[1]) * inv[1];
      en = nan_max(en, nan_min(t0, t1));
      ex = nan_min(ex, nan_max(t0, t1));
      t0 = (sbox[2][j] - o[2]) * inv[2];
      t1 = (sbox[5][j] - o[2]) * inv[2];
      en = nan_max(en, nan_min(t0, t1));
      ex = nan_min(ex, nan_max(t0, t1));
      const bool hit = ex >= en && en <= bound;

      lb = fmaxf(lb, hit ? en : -inf);
      float m = hit ? en : inf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      const uint32_t any = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) {
        smin[warp][j] = m;
        sany[warp][j] = any;
      }
    }
    __syncthreads();

    // thread j combines the four warps' partials of tile c0 + j; the next
    // chunk's first barrier orders these reads before its writes
    const int j = threadIdx.x;
    if (j < w) {
      float m = smin[0][j];
      uint32_t any = sany[0][j];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        m = fminf(m, smin[k][j]);
        any |= sany[k][j];
      }
      const size_t out = (size_t)g * n_tiles + c0 + j;
      gent[out] = m;
      sgm[out] = any != 0u;
    }
  }
  lane_bound[ray] = lb;
}

}  // namespace

extern "C" int cull_tiles_launch(const void* x, const void* active,
                                 const void* occ, const void* tile_box,
                                 void* sgm, void* gent, void* lane_bound,
                                 int n_groups, int n_tiles, float t_min,
                                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_groups > 0) {
    cull_tiles_kernel<<<n_groups, kLanes, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(active),
        static_cast<const float*>(occ), static_cast<const float*>(tile_box),
        static_cast<uint8_t*>(sgm), static_cast<float*>(gent),
        static_cast<float*>(lane_bound), n_tiles, t_min);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cull_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
