// Closest ray-triangle hit over entry-ordered passing-tile lists, for Hopper.
//
// Replaces two Pallas kernels of the JAX reference, both in
// metalpathtracer_tpu/render/pallas/intersect_mm.py:
//   - _mm_kernel         (:477, with _tile_epilogue :406; VMEM-resident
//                         weights)
//   - _mm_kernel_stream  (:555; weights streamed from HBM through a VMEM
//                         slot cache)
// Both compute one function: for every ray, the closest accepted
// Moller-Trumbore hit over the triangle tiles its 128-lane subgroup passes,
// walked nearest-entry first, with a best-t early exit. Only the TPU's VMEM
// and SMEM capacity separated them; one kernel here serves every scene size.
//
// Contract, per 128-lane subgroup g:
//   - walk lists[g, :counts[g]] in entry order; stop before position j when
//     smin[g, j] > max over the lanes of min(best_t, lane_bound);
//   - accept division-free on the sign-folded determinants: |a| > 1e-5,
//     u, v >= 0, u + v <= |a|, st > t_min |a|; the candidate t = st / a is an
//     IEEE division;
//   - inside a tile the lowest column wins an equal t; across tiles only a
//     strictly smaller t replaces the best;
//   - outputs (t, col), col -1 on a miss; optionally the list positions each
//     subgroup walked (walked may be null).
//
// The determinants. The weight slab is compact: one row of 16 floats per
// triangle, [n, v0.n, e1, v0 x e1, e2, e2 x v0] (n = e1 x e2), and a ray
// brings 9 features, d, m = o x d and o (x is (N, 12); the last three,
// o.d, |o|^2 and 1, have no weight here). Each determinant is the FMA chain
// of its non-zero terms, in the term order of the dense 12-term dot product
// x . w that the plain twin expands to (render/kernels/intersect_mm.py::
// expand_slab), negated where the dense weight is negated:
//   a  = -(d . n)                                 3 FMA (a mul, 2 FMA)
//   su = -(d . (e2 x v0)) + m . e2                 6
//   sv = -(d . (v0 x e1)) - m . e1                 6
//   st = o . n - v0.n                              3 + 1 add
// Under round-to-nearest fma(a, -b, -s) = -fma(a, b, s) and fma(x, 0, s) = s,
// so on finite features these equal the dense chains bit for bit, up to the
// sign of zero. The sign fold flips the signs of su, sv and st by the sign
// bit of a (an xor) and takes |a|: the same values as multiplying by
// sign(a) = +-1 wherever a != 0, and a pair with a = +-0 fails |a| > 1e-5
// either way, so every accept decision and every t is the twin's.
//
// The bound. 19 FMA = 38 flop per tested (ray, triangle) pair, and the pairs
// are the list positions actually walked times 128 lanes times tile_p
// (the walk ends early, so the work depends on the data). At the f32
// CUDA-core peak of an H100 SXM (67 TFLOP/s) that is the least time; the
// bytes (ray features, lists, the walked tiles at 64 B per triangle) are
// far below it at 3.35 TB/s. About 10 more instructions per pair (sign fold,
// five compares, an add and a multiply) compete with the FMAs for dispatch.
// The walk lengths are uneven (on bunny300k's bounce-1 rays most subgroups
// walk no tile and the longest walk about a hundred), and one subgroup's
// walk runs on one SM, so the longest walk, not the total, sets the time of
// a pool-width call.
//
// What bounded the first version, and what this one does about it:
//   1. Too little parallelism at pool width: one block of 128 threads per
//      subgroup gave a 32,768-ray call 256 blocks, ~8 warps per SM, each
//      thread a chain of dependent instructions per column. Here a block
//      holds one subgroup in kSlices warps. Every warp covers all 128 rays,
//      kRays per thread (lane l takes rays l, l + 32, l + 64, l + 96), and
//      the contiguous column slice w of every tile, so it reads one column
//      at a time as a shared-memory broadcast (16 floats once per kRays
//      pairs). Each thread keeps, per ray, its slice's running best (t,
//      column, list position); after each tile the slices' t are combined
//      per ray in shared memory for the early-exit threshold, and after the
//      walk the (t, position, column) triples are merged once, which gives
//      the same winner as the contract's per-tile argmin and strict merge.
//   2. Wasted arithmetic and bytes: the dense slab ran 48 FMAs and read
//      192 B per triangle; the compact one runs 19 and reads 64 B (the
//      bunny300k slab falls from 61 MB to 20 MB, inside the 50 MB L2).
//   3. Staging not overlapped: a two-slot ring of tiles in shared memory,
//      filled with cp.async (16 B per thread, one commit group per tile);
//      the copy of list position j + 1 is in flight while j is tested. The
//      early exit may waste one prefetched tile.
//   4. Host cost per launch: cudaFuncSetAttribute is gone (the ring needs at
//      most 32 KB, under the 48 KB default) and cudaSetDevice runs only when
//      the device is not already current.
// Instruction-level parallelism: kUnroll columns times kRays rays are
// independent chains, ray features stay in registers, and the IEEE division
// runs only for accepted pairs.
//
// Why not tensor cores. TF32 (10-bit mantissa) silently flips accept/reject
// decisions at triangle edges: the trap Mosaic's default f32 matmul fell
// into on the TPU. A 3-pass split (bf16 x 3 or TF32 x 3) costs three
// products per determinant and still leaves the ~10-op epilogue on the CUDA
// cores; once the 19-FMA structure is used it would buy less than 2x, and it
// would move the rounding that the plain twin is held to.

#include <cuda_runtime.h>
#include <stdint.h>

// Column slices per tile (K: a block has 32 * K threads) and rays per
// thread: compile-time constants chosen on the card. `chip_smoke.py --sweep`
// builds this file with -DMM_SLICES=1, 2, 4, 8 and -DMM_RAYS=1, 4 and times
// each at the render paths' shapes.
#ifndef MM_SLICES
#define MM_SLICES 8
#endif
#ifndef MM_RAYS
#define MM_RAYS 4
#endif

namespace {

constexpr int kLanes = 128;                   // rays per subgroup
constexpr int kRays = MM_RAYS;                // rays per thread
constexpr int kRayThreads = kLanes / kRays;   // threads that cover a slice
constexpr int kRayWarps = kRayThreads / 32;
constexpr int kSlices = MM_SLICES;
constexpr int kThreads = kRayThreads * kSlices;
constexpr int kFeatures = 12;                 // row stride of x
constexpr int kSlabFloats = 16;               // one compact slab row
constexpr int kColF4 = kSlabFloats / 4;
constexpr int kUnroll = 4;                    // columns in flight per thread
constexpr int kMaxSharedBytes = 48 * 1024;    // dynamic + static, no opt-in
constexpr float kParallelEps = 1e-5f;

static_assert(kRays == 1 || kRays == 2 || kRays == 4, "rays per thread");
static_assert(kSlices >= 1 && kThreads <= 1024, "at most 1024 threads");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Copy one tile (tile_f4 float4) into a ring slot, 16 B per thread per step,
// as one commit group.
__device__ __forceinline__ void stage_tile(float4* slot, const float4* w,
                                           int tile, int tile_f4) {
  const float4* src = w + (size_t)tile * tile_f4;
  for (int k = threadIdx.x; k < tile_f4; k += kThreads) cp_async16(slot + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float flip_sign(float v, uint32_t sign) {
  return __uint_as_float(__float_as_uint(v) ^ sign);
}

__global__ void __launch_bounds__(kThreads)
mm_closest_hit_kernel(const int32_t* __restrict__ lists,    // (G, n_tiles)
                      const int32_t* __restrict__ counts,   // (G,)
                      const float* __restrict__ smin,       // (G, n_tiles)
                      const float* __restrict__ x,          // (G*128, 12)
                      const float* __restrict__ lane_bound, // (G*128,)
                      const float4* __restrict__ w,  // (n_tiles, tile_p, 16)
                      float* __restrict__ out_t,            // (G*128,)
                      int32_t* __restrict__ out_col,        // (G*128,)
                      int32_t* __restrict__ walked,         // (G,) or null
                      int n_tiles, int tile_p, float t_min,
                      unsigned long long* __restrict__ tally) {  // (2,) or null
  extern __shared__ float4 ring[];                // 2 slots of one tile
  __shared__ float slice_t[kSlices][kLanes];      // slices' best t per ray
  __shared__ int32_t slice_col[kSlices][kLanes];  // ... and its column
  __shared__ int32_t slice_pos[kSlices][kLanes];  // ... and list position
  __shared__ float wmax[kRayWarps];               // threshold partials

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int slice = warp / kRayWarps;
  // this thread's rays in the subgroup: r0 + q * kRayThreads, q < kRays
  const int r0 = (warp % kRayWarps) * 32 + (threadIdx.x & 31);
  const float inf = __int_as_float(0x7f800000);
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (tally != nullptr && g == 0 && threadIdx.x == 0) atomicAdd(tally, 1ull);

  float d0[kRays], d1[kRays], d2[kRays], m0[kRays], m1[kRays], m2[kRays];
  float o0[kRays], o1[kRays], o2[kRays], lb[kRays];
  // per ray, this slice's best over the walked tiles: the first (position,
  // column) of its smallest t
  float bt[kRays];
  int32_t bc[kRays], bp[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t ray = (size_t)g * kLanes + r0 + q * kRayThreads;
    const float4* xp = reinterpret_cast<const float4*>(x + ray * kFeatures);
    const float4 a = xp[0], b = xp[1], c = xp[2];
    d0[q] = a.x; d1[q] = a.y; d2[q] = a.z;
    m0[q] = a.w; m1[q] = b.x; m2[q] = b.y;
    o0[q] = b.z; o1[q] = b.w; o2[q] = c.x;
    lb[q] = lane_bound[ray];
    bt[q] = inf;
    bc[q] = -1;
    bp[q] = 0;
  }

  const int32_t* glist = lists + (size_t)g * n_tiles;
  const float* gsmin = smin + (size_t)g * n_tiles;
  const int cnt = counts[g];
  const int tile_f4 = tile_p * kColF4;
  const int cols = tile_p / kSlices;
  const int c_begin = slice * cols;

  if (cnt > 0) stage_tile(ring, w, glist[0], tile_f4);
  {
    float v = lb[0];
#pragma unroll
    for (int q = 1; q < kRays; ++q) v = fmaxf(v, lb[q]);
    v = warp_max(v);
    if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = v;
  }

  int j = 0;
  for (; j < cnt; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile j is in its slot for every thread, the threshold partials of the
    // last tile are published, and slot (j + 1) & 1 is no longer read
    __syncthreads();
    float thr = wmax[0];
#pragma unroll
    for (int k = 1; k < kRayWarps; ++k) thr = fmaxf(thr, wmax[k]);
    if (!(gsmin[j] <= thr)) break;  // block-uniform
    if (j + 1 < cnt) {
      stage_tile(ring + ((j + 1) & 1) * tile_f4, w, glist[j + 1], tile_f4);
    }

    const float4* tw = ring + (j & 1) * tile_f4;
    const int32_t base = glist[j] * tile_p;
    for (int c = c_begin; c < c_begin + cols; c += kUnroll) {
      bool ok[kUnroll][kRays];
      float num[kUnroll][kRays], den[kUnroll][kRays];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4* col = tw + (c + u) * kColF4;
        // q0 = [n, v0.n], q1 = [e1, (v0 x e1).x],
        // q2 = [(v0 x e1).yz, e2.xy], q3 = [e2.z, e2 x v0]
        const float4 q0 = col[0], q1 = col[1], q2 = col[2], q3 = col[3];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          float sa = d0[q] * -q0.x;
          sa = fmaf(d1[q], -q0.y, sa);
          sa = fmaf(d2[q], -q0.z, sa);
          float su = d0[q] * -q3.y;
          su = fmaf(d1[q], -q3.z, su);
          su = fmaf(d2[q], -q3.w, su);
          su = fmaf(m0[q], q2.z, su);
          su = fmaf(m1[q], q2.w, su);
          su = fmaf(m2[q], q3.x, su);
          float sv = d0[q] * -q1.w;
          sv = fmaf(d1[q], -q2.x, sv);
          sv = fmaf(d2[q], -q2.y, sv);
          sv = fmaf(m0[q], -q1.x, sv);
          sv = fmaf(m1[q], -q1.y, sv);
          sv = fmaf(m2[q], -q1.z, sv);
          float st = o0[q] * q0.x;
          st = fmaf(o1[q], q0.y, st);
          st = fmaf(o2[q], q0.z, st);
          st = st - q0.w;  // the dense chain's fma(1, -v0.n, st)
          const uint32_t sign = __float_as_uint(sa) & 0x80000000u;
          const float sas = fabsf(sa);
          const float sus = flip_sign(su, sign), svs = flip_sign(sv, sign);
          const float sts = flip_sign(st, sign);
          ok[u][q] = sas > kParallelEps && sus >= 0.f && svs >= 0.f &&
                     sus + svs <= sas && sts > t_min * sas;
          num[u][q] = sts;
          den[u][q] = sas;
        }
      }
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int q = 0; q < kRays; ++q) any |= ok[u][q];
      }
      if (any) {  // rare: most pairs miss
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int q = 0; q < kRays; ++q) {
            if (ok[u][q]) {
              const float t = __fdiv_rn(num[u][q], den[u][q]);
              if (t < bt[q]) {  // strict: the lowest column, the first tile
                bt[q] = t;
                bc[q] = base + c + u;
                bp[q] = j;
              }
            }
          }
        }
      }
    }

    // the threshold for position j + 1: per ray the best t over the slices,
    // then the max over the lanes of min(best t, lane bound)
#pragma unroll
    for (int q = 0; q < kRays; ++q) slice_t[slice][r0 + q * kRayThreads] = bt[q];
    __syncthreads();
    float v = -inf;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int r = r0 + q * kRayThreads;
      float best = slice_t[0][r];
#pragma unroll
      for (int s = 1; s < kSlices; ++s) best = fminf(best, slice_t[s][r]);
      v = fmaxf(v, fminf(best, lb[q]));
    }
    v = warp_max(v);
    if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = v;
  }

  // merge the slices: the smallest t, then the earliest list position, then
  // the lowest column (slices hold ascending column ranges)
  __syncthreads();  // every read of slice_t above is done
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int r = r0 + q * kRayThreads;
    slice_t[slice][r] = bt[q];
    slice_col[slice][r] = bc[q];
    slice_pos[slice][r] = bp[q];
  }
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int r = r0 + q * kRayThreads;
      float t_best = bt[q];
      int32_t c_best = bc[q], p_best = bp[q];
#pragma unroll
      for (int s = 1; s < kSlices; ++s) {
        const float t = slice_t[s][r];
        const int32_t p = slice_pos[s][r];
        if (t < t_best || (t == t_best && p < p_best)) {
          t_best = t;
          c_best = slice_col[s][r];
          p_best = p;
        }
      }
      const size_t ray = (size_t)g * kLanes + r;
      out_t[ray] = t_best;
      out_col[ray] = c_best;
    }
    if (walked != nullptr && r0 == 0) walked[g] = j;
  }
}

}  // namespace

extern "C" int mm_closest_hit_launch(const void* lists, const void* counts,
                                     const void* smin, const void* x,
                                     const void* lane_bound, const void* w,
                                     void* out_t, void* out_col, void* walked,
                                     int n_groups, int n_tiles, int tile_p,
                                     float t_min, int device, void* stream,
                                     void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  // the two-slot ring: 16 KB at tile_p 128, 32 KB at 256
  const size_t ring = 2 * (size_t)tile_p * kSlabFloats * sizeof(float);
  const size_t fixed = (size_t)kSlices * kLanes * 12 + kRayWarps * 4;
  if (tile_p <= 0 || tile_p % (kSlices * kUnroll) != 0 ||
      ring + fixed > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_groups > 0) {
    mm_closest_hit_kernel<<<n_groups, kThreads, ring, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(lists), static_cast<const int32_t*>(counts),
        static_cast<const float*>(smin), static_cast<const float*>(x),
        static_cast<const float*>(lane_bound), static_cast<const float4*>(w),
        static_cast<float*>(out_t), static_cast<int32_t*>(out_col),
        static_cast<int32_t*>(walked), n_tiles, tile_p, t_min,
        static_cast<unsigned long long*>(tally));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mm_closest_hit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
