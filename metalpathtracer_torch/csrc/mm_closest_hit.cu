// Closest ray-triangle hit over entry-ordered passing-tile lists, for Hopper.
//
// Replaces two Pallas kernels of the JAX reference, both in
// metalpathtracer_tpu/render/pallas/intersect_mm.py:
//   - _mm_kernel         (VMEM-resident weights; with _tile_epilogue,
//                         _prep_x and _det_matmul_prepped)
//   - _mm_kernel_stream  (weights streamed from HBM through a VMEM slot
//                         cache, batched DMA with semaphores)
// Both compute one function: for every ray, the closest accepted
// Moller-Trumbore hit over the triangle tiles its 128-lane subgroup passes,
// walked nearest-entry first, with a best-t early exit. What separated them
// was the TPU's capacity: the resident kernel holds every weight tile in
// VMEM and ships the tile lists whole into SMEM, so past ~128k triangles or
// ~768 KB of lists the reference routes to the streaming variant. Here a
// block reads its own list row from global memory and stages one tile at a
// time in shared memory, so one kernel serves every scene size.
//
// Work split: one block of 128 threads per 128-lane subgroup g, one thread
// per ray. For list position j < counts[g] the block stops as soon as
// smin[g, j] > max over its lanes of min(best_t, lane_bound) -- the
// reference's loop condition -- else it stages tile lists[g, j] (tile_p
// columns x [wa | wu | wv | wt] x 12 features, f32, 24 KB at tile_p 128) in
// shared memory, and every thread evaluates the four determinants
//   [a | su | sv | st] = x . w      (12-term FMA chains, full f32)
// for each column against its own ray features x = [d, o x d, o, o.d, |o|^2, 1].
// Acceptance is division-free on the sign-folded values: |a| > 1e-5,
// u, v >= 0, u + v <= |a|, st > t_min |a|; the candidate t = st / a is an
// IEEE division (the caller re-derives the winner's t from its plane).
//
// Tie rules, as the reference's: inside a tile the lowest column wins an
// equal t (columns are scanned in order with a strict <); across tiles a
// later tile replaces the running best only with a strictly smaller t, and
// tiles are taken in list (entry) order.
//
// What bounds it on an H100: f32 FMA throughput on the tested (ray, triangle)
// pairs -- 48 FMAs and ~10 compares per pair -- with the shared-memory
// broadcast reads of each column's 48 weights beside them, and L2 reads of
// the weight tiles (each block re-reads the tiles of its list; the whole
// 4,968-triangle slab is 0.95 MB and stays in the 50 MB L2). Tensor cores,
// TMA staging and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                // rays per subgroup = threads per block
constexpr int kWarps = kLanes / 32;
constexpr int kFeatures = 12;              // live ray features
constexpr int kColFloats = 4 * kFeatures;  // [wa | wu | wv | wt] of one column
constexpr float kParallelEps = 1e-5f;

// Max of v over the block's 128 threads. fmaxf ignores NaN; no input here is
// NaN (entries are NaN-guarded by the cull, best_t starts at +inf).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) r = fmaxf(r, red[k]);
  return r;
}

__device__ __forceinline__ float dot12(const float (&x)[kFeatures],
                                       const float4* w) {
  const float4 a = w[0], b = w[1], c = w[2];
  float s = x[0] * a.x;
  s = fmaf(x[1], a.y, s);
  s = fmaf(x[2], a.z, s);
  s = fmaf(x[3], a.w, s);
  s = fmaf(x[4], b.x, s);
  s = fmaf(x[5], b.y, s);
  s = fmaf(x[6], b.z, s);
  s = fmaf(x[7], b.w, s);
  s = fmaf(x[8], c.x, s);
  s = fmaf(x[9], c.y, s);
  s = fmaf(x[10], c.z, s);
  s = fmaf(x[11], c.w, s);
  return s;
}

__global__ void __launch_bounds__(kLanes)
mm_closest_hit_kernel(const int32_t* __restrict__ lists,    // (G, n_tiles)
                      const int32_t* __restrict__ counts,   // (G,)
                      const float* __restrict__ smin,       // (G, n_tiles)
                      const float* __restrict__ x,          // (G*128, 12)
                      const float* __restrict__ lane_bound, // (G*128,)
                      const float* __restrict__ w,  // (n_tiles, tile_p, 4, 12)
                      float* __restrict__ out_t,            // (G*128,)
                      int32_t* __restrict__ out_col,        // (G*128,)
                      int n_tiles, int tile_p, float t_min) {
  extern __shared__ float4 sw[];  // one tile: tile_p * 12 float4
  __shared__ float red[kWarps];

  const int g = blockIdx.x;
  const size_t ray = (size_t)g * kLanes + threadIdx.x;

  float xr[kFeatures];
  {
    const float4* xp = reinterpret_cast<const float4*>(x + ray * kFeatures);
    const float4 a = xp[0], b = xp[1], c = xp[2];
    xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
    xr[4] = b.x; xr[5] = b.y; xr[6] = b.z; xr[7] = b.w;
    xr[8] = c.x; xr[9] = c.y; xr[10] = c.z; xr[11] = c.w;
  }
  const float lb = lane_bound[ray];
  float best_t = __int_as_float(0x7f800000);  // +inf
  int32_t best_c = -1;

  const int32_t* glist = lists + (size_t)g * n_tiles;
  const float* gsmin = smin + (size_t)g * n_tiles;
  const int cnt = counts[g];
  const int tile_f4 = tile_p * (kColFloats / 4);

  float thr = block_max(lb, red);
  for (int j = 0; j < cnt; ++j) {
    // block-uniform: the list row, smin and thr are the same for all threads
    if (!(gsmin[j] <= thr)) break;
    const int tile = glist[j];

    const float4* src = reinterpret_cast<const float4*>(w) + (size_t)tile * tile_f4;
    for (int k = threadIdx.x; k < tile_f4; k += kLanes) sw[k] = src[k];
    __syncthreads();

    const int32_t base = tile * tile_p;
    for (int c = 0; c < tile_p; ++c) {
      const float4* wc = sw + c * (kColFloats / 4);
      const float sa = dot12(xr, wc);
      const float su = dot12(xr, wc + 3);
      const float sv = dot12(xr, wc + 6);
      const float st = dot12(xr, wc + 9);
      const float sg = sa < 0.f ? -1.f : 1.f;
      const float sas = sa * sg, sus = su * sg, svs = sv * sg, sts = st * sg;
      if (sas > kParallelEps && sus >= 0.f && svs >= 0.f &&
          sus + svs <= sas && sts > t_min * sas) {
        const float t = __fdiv_rn(sts, sas);
        if (t < best_t) {
          best_t = t;
          best_c = base + c;
        }
      }
    }
    // every thread is past its reads of sw before the next tile overwrites it
    thr = block_max(fminf(best_t, lb), red);
  }
  out_t[ray] = best_t;
  out_col[ray] = best_c;
}

}  // namespace

extern "C" int mm_closest_hit_launch(const void* lists, const void* counts,
                                     const void* smin, const void* x,
                                     const void* lane_bound, const void* w,
                                     void* out_t, void* out_col, int n_groups,
                                     int n_tiles, int tile_p, float t_min,
                                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // one weight tile in dynamic shared memory: 24 KB at tile_p 128, 48 KB at
  // 256, which with the static reduction buffer is past the 48 KB default
  const size_t smem = (size_t)tile_p * kColFloats * sizeof(float);
  e = cudaFuncSetAttribute(mm_closest_hit_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_groups > 0) {
    mm_closest_hit_kernel<<<n_groups, kLanes, smem, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(lists), static_cast<const int32_t*>(counts),
        static_cast<const float*>(smin), static_cast<const float*>(x),
        static_cast<const float*>(lane_bound), static_cast<const float*>(w),
        static_cast<float*>(out_t), static_cast<int32_t*>(out_col), n_tiles,
        tile_p, t_min);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mm_closest_hit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
