// Ray vs tile-AABB cull with per-subgroup reductions, for Hopper.
//
// Replaces the Pallas kernel _cull_kernel of the JAX reference
// (metalpathtracer_tpu/render/pallas/intersect_mm.py:712, launched from
// _cull_pass :905) and the list sort after it (_cull_tile_lists :1008). For
// every 128-lane subgroup g and tile j it computes
//   sgm[g, j]  = does any live lane of g enter tile j's box?
//   gent[g, j] = the smallest entry distance of those lanes (+inf if none)
// and for every lane the largest entry distance over the tiles it enters
// (lane_bound, -inf if none). The (n_tiles, N) slab test behind them never
// leaves registers. Two entries share the kernel:
//   cull_tiles       writes sgm, gent and lane_bound (the plain cull);
//   cull_tile_lists  writes what the closest-hit kernel reads: each
//     subgroup's row sorted stably by entry, as torch.sort(gent,
//     stable=True) orders it (the reference's lax.sort), so lists[g] (int32)
//     holds the entered tiles nearest entry first, equal entries and then
//     the tiles entered by none (+inf) in ascending tile order; smin[g] the
//     sorted entries; counts[g] the entered tiles (the any flags, as
//     sgm.sum counts them); lane_bound already min(lane_bound, occ), as
//     torch.minimum gives it (a NaN occ passes through). gent and sgm never reach device memory.
// The sort runs in the block that holds the row, on the order_key of each
// entry with -0 taken as +0 (torch and lax compare -0 == +0). No entry is
// NaN: a NaN entry fails the hit test. The row length picks the sort:
//   rank   (n_tiles <= kRankMaxTiles; the reference scene's 39 tiles, the
//          multimesh's 81): each thread places its tiles by counting the
//          smaller keys, or the equal keys at lower tiles, in shared memory,
//          four keys a load (the row padded with keys that never count);
//          any block size, so block_warps still fits the block to the call.
//          Measured slower: each warp ranking a tile by ballots over keys
//          held in its lanes (scan step 69 -> 78 us, bunny70k 25 -> 32);
//   radix  (more tiles; bunny300k's 1,242): cub::BlockRadixSort over kWarps
//          warps, kItems keys a thread (the fewest that hold the row, up to
//          kRadixMaxTiles), stable LSD passes over blocked keys, so equal
//          keys keep ascending tile order.
// Each launch of cull_tile_lists adds one to its tally's first slot, and a
// radix launch also to its second.
//
// Arithmetic, as the reference kernel's, so that the plain torch version
// (render/kernels/intersect_mm.py::cull_pass_reference) is bit-equal:
//   inv = clip(1/d, -1e30, 1e30)    IEEE division; no inf * 0 NaN below
//   occ = active > 0.5 ? occ : -inf  (an inactive lane enters nothing)
//   per axis t0 = (lo - o) * inv, t1 = (hi - o) * inv, a subtraction and a
//   multiplication each rounded (never contracted into an FMA);
//   en = max(min(t0x, t1x), t_min), ex = max(t0x, t1x), then
//   en = max(en, min(t0, t1)), ex = min(ex, max(t0, t1)) for y and z;
//   hit = ex >= en && en <= occ.
// The reference tests ex > en, which no ray passes for a flat box (lo ==
// hi on one axis: en == ex where the ray crosses the plane), so the tile of
// an axis-aligned planar mesh was never entered and its triangles never
// hit. With >= a ray that only grazes a box's edge enters it, which costs
// work and changes no closest hit.
// min and max propagate NaN as torch.minimum/maximum do (CUDA's fminf and
// fmaxf drop it): PTX min.NaN / max.NaN, one instruction each. A hit's
// entry is never NaN, so the reductions over hits may drop NaN; they run
// on an order-preserving integer image of the float (negative floats have
// their low 31 bits flipped), which orders -0 below +0 where a float min
// leaves the sign of an equal zero open: only the sign of a zero entry can
// differ from the twin's, and only at t_min <= 0.
//
// What bounds it on an H100 SXM: the slab test's min/max. A (ray, tile)
// pair is 12 flop (6 subtractions, 6 multiplications; the 12 of the bound
// in chip_smoke.py, 7.3 us on bunny300k's 32,768 rays x 1,242 tiles at the
// 67 TFLOP/s f32 peak), but also 11 min/max, 2 compares and 2 predicated
// min/max of the reductions: the loop issues 34.1 instructions per pair
// (its SASS, read by chip_smoke.py: 13 FMNMX, 6 FADD, 6 FMUL, 2 FSETP and
// ~7 of per-tile work), 41.5 us on bunny300k at one instruction per lane
// per clock of every SM (1.98 GHz). Min/max and compares outnumber the
// FADD/FMUL, and Hopper is likely to issue them at half the FP32 add rate
// (not measured here), so they, with the per-tile integer work, set the
// pace; the kernel reaches 60-70% of the issue estimate. The bytes (48 B
// per ray, 32 B per tile in, 5 B per (subgroup, tile) and 4 B per ray out)
// bind only at few tiles: 921,600 rays x 39 tiles move 56.7 MB, 16.9 us
// at 3.35 TB/s. cull_tile_lists writes 8 B per (subgroup, tile) (list and
// smin) and 4 per subgroup (its count) instead of 5 per pair: 57.6 MB at
// that shape, 17.2 us.
//
// The design. What held the first version (one ray per thread, 128
// threads per subgroup, a warp reduction per tile) back, and what this one
// does about each:
//   1. A cross-lane reduction per (ray, tile) pair: 5 shuffles, a ballot
//      and a shared store per tile per warp, for 32 pairs. Here one warp
//      holds the whole subgroup, kRays = 4 rays per lane (lane l takes
//      rays l, l + 32, l + 64, l + 96), in registers, and a block's warps
//      split the tiles (warp w takes tiles w, w + warps, ...). For each
//      tile a lane reduces its 4 rays in registers, then the warp reduces
//      once, gent and sgm together as one redux.sync min on the integer
//      image of the entry (a lane whose rays enter nothing offers NaN, the
//      largest key), for 128 pairs, written by lane 0 straight to device
//      memory (each tile has one warp). lane_bound is a per-lane register
//      max over the warp's tiles, combined over the warps once per block by
//      shared atomicMax. The TPU kernel puts tiles on lanes and rays on
//      sublanes; that layout (each thread holding tiles and looping over
//      the rays, a redux per ray) measured slower on this card at every
//      tile count tried, most at few tiles: 39 tiles fill 39 of a warp's
//      64 tile slots, where 128 rays always fill 4 warps' lanes exactly.
//   2. Too few warps: 256 blocks of 4 warps at pool width. Here the launch
//      picks the warps per block (block_warps): enough for kFill warps on
//      every SM, at most kWarps, and at least kMinTilesPerWarp tiles each:
//      16 on the bunny legs' 32,768 rays, 9 at the flagship's pool call
//      (39 tiles), 3 at the scan's 921,600 rays, where 7,200 blocks fill
//      the card and blocks of few warps leave a short last wave. Every
//      warp of a block has the same tile count to within one.
//   3. NaN-propagating min/max of two compares and a select each: now PTX
//      min.NaN / max.NaN, one instruction each.
//   4. Box staging with 6 scalar loads and a / 6 and % 6 each, two
//      barriers per chunk, no overlap: a warp reads each of its boxes as
//      two float4 loads of one address for all lanes (32 B per tile), the
//      next tile's while it tests this one (two tiles per loop iteration,
//      so no register copies). The rays are staged once per block in
//      shared memory instead (origin, clipped reciprocal and folded bound,
//      32 B each, one thread a ray), so no warp repeats the loads and the
//      12 IEEE divisions of its lane's rays; the block has two barriers.
//   5. cudaSetDevice on every launch: now only when the device is not
//      already current.
// kWarps and kFill are compile-time constants; `chip_smoke.py --sweep`
// builds this file with -DCULL_WARPS=8, 16, 32 x -DCULL_FILL=64, 128, 256
// and times each at the render paths' shapes. At 16 warps ptxas gives the
// loop 77 registers (a block then fits once per SM); capping it at 64 for
// two blocks was measured slower on the 921,600-ray and bunny300k sets.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

#ifndef CULL_WARPS
#define CULL_WARPS 16
#endif
#ifndef CULL_FILL
#define CULL_FILL 128
#endif

namespace {

constexpr int kLanes = 128;                 // rays per subgroup
constexpr int kRays = kLanes / 32;          // rays per lane
constexpr int kWarps = CULL_WARPS;          // most tile-splitting warps per block
constexpr int kThreads = 32 * kWarps;       // ... their threads, a radix block's
constexpr int kFill = CULL_FILL;            // warps per SM a launch aims for
constexpr int kMinTilesPerWarp = 4;         // tiles a warp takes at least
constexpr int kFeatures = 12;               // x = [d, o x d, o, o.d, |o|^2, 1]
constexpr int kNanKey = 0x7fffffff;         // order_key of the NaN below
constexpr int kInfKey = 0x7f800000;         // order_key of +inf
constexpr float kRecipClip = 1e30f;
// the longest rows each sort takes: ranks are faster up to 384 tiles and
// the radix sort from 512 (measured at 32,768 and 921,600 rays on an H100)
constexpr int kRankMaxTiles = 384;
constexpr int kRadixMaxTiles = 8192;

static_assert(kWarps >= 1 && kWarps <= 32, "CULL_WARPS: 1 to 32");
static_assert(kRadixMaxTiles % kThreads == 0, "CULL_WARPS: a power of two");

// what a launch writes: the plain cull's rows, or the lists by either sort
enum Sort { kRows, kRank, kRadix };

struct Args {
  const float* x;          // (G*128, 12)
  const float* active;     // (G*128,)
  const float* occ;        // (G*128,) or null
  const float4* tile_box;  // (n_tiles, 8)
  uint8_t* sgm;            // (G, n_tiles), kRows
  float* gent;             // (G, n_tiles), kRows
  int* lists;              // (G, n_tiles), kRank and kRadix
  int* counts;             // (G,), kRank and kRadix
  float* smin;             // (G, n_tiles), kRank and kRadix
  float* lane_bound;       // (G*128,)
  int n_tiles;
  float t_min;
  unsigned long long* tally;  // (2,) or null
};

template <int kItems>
using RadixSort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;

// the row's sort keys and entered-tile count in shared memory, by sort
struct RowsSmem {};
struct RankSmem {
  alignas(16) int key[kRankMaxTiles + 4];
  int entered;
};
template <int kItems>
struct RadixSmem {
  union {  // the keys are in registers before the sort takes the storage
    int key[kThreads * kItems];
    typename RadixSort<kItems>::TempStorage sort;
  };
  int entered;
};
template <int kSort, int kItems> struct SmemOf { using type = RowsSmem; };
template <int kItems> struct SmemOf<kRank, kItems> { using type = RankSmem; };
template <int kItems> struct SmemOf<kRadix, kItems> { using type = RadixSmem<kItems>; };

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// an int whose signed order is the float's (an involution: key_value
// inverts it); the NaN 0x7fffffff maps to itself, above every number
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float clipped_recip(float d) {
  return max_nan(min_nan(__fdiv_rn(1.0f, d), kRecipClip), -kRecipClip);
}

template <int kSort, int kItems>
__global__ void __launch_bounds__(kThreads) cull_tiles_kernel(const Args a) {
  __shared__ float4 s_ray[kLanes][2];  // {o, folded bound}, {clipped inv, 0}
  __shared__ int s_lb[kLanes];         // lane bound keys, combined over the warps
  __shared__ typename SmemOf<kSort, kItems>::type s_row;

  const int g = blockIdx.x;
  const int n_tiles = a.n_tiles;
  const size_t row = (size_t)g * n_tiles;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(kNanKey);
  const int key_neg_inf = order_key(-inf);
  // the launch, counted on the device: a CUDA graph's replay counts too
  if (a.tally != nullptr && g == 0 && threadIdx.x == 0) {
    atomicAdd(a.tally, 1ull);
    if (kSort == kRadix) atomicAdd(a.tally + 1, 1ull);
  }
  if constexpr (kSort != kRows) {
    if (threadIdx.x == 0) s_row.entered = 0;
  }
  if constexpr (kSort == kRank) {
    // the row padded to whole int4 with keys that never count
    if (threadIdx.x < 4) s_row.key[n_tiles + threadIdx.x] = kNanKey;
  }

  // the subgroup's rays, staged once per block, one thread each
  for (int i = threadIdx.x; i < kLanes; i += blockDim.x) {
    const size_t ray = (size_t)g * kLanes + i;
    const float4* xr = reinterpret_cast<const float4*>(a.x + ray * kFeatures);
    const float4 p = xr[0], q = xr[1], r = xr[2];  // d = p.xyz, o = q.z q.w r.x
    const float bound = a.active[ray] > 0.5f ? (a.occ ? a.occ[ray] : inf) : -inf;
    s_ray[i][0] = make_float4(q.z, q.w, r.x, bound);
    s_ray[i][1] = make_float4(clipped_recip(p.x), clipped_recip(p.y),
                              clipped_recip(p.z), 0.f);
    s_lb[i] = key_neg_inf;
  }
  __syncthreads();

  // this lane's rays lane + 32 q, in registers
  float ox[kRays], oy[kRays], oz[kRays], ix[kRays], iy[kRays], iz[kRays];
  float bound[kRays], lb[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const float4 p = s_ray[lane + 32 * q][0], r = s_ray[lane + 32 * q][1];
    ox[q] = p.x;
    oy[q] = p.y;
    oz[q] = p.z;
    bound[q] = p.w;
    ix[q] = r.x;
    iy[q] = r.y;
    iz[q] = r.z;
    lb[q] = -inf;
  }

  // tile j against the lane's rays, then the warp's min entry and any-hit.
  // The lane's min starts at NaN, which fminf drops: it stays NaN exactly
  // where none of the lane's rays enters, and NaN's key is the largest.
  // Lane 0 writes the plain cull's row entry, or the sort key (-0's key -1
  // as +0's 0; +inf's where no lane enters) and counts the entered tile
  int entered = 0;
  auto test_tile = [&](const float4& lo, const float4& hi, int j) {
    float gmin = nan;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float t0 = __fmul_rn(__fsub_rn(lo.x, ox[q]), ix[q]);
      float t1 = __fmul_rn(__fsub_rn(hi.x, ox[q]), ix[q]);
      float en = max_nan(min_nan(t0, t1), a.t_min);
      float ex = max_nan(t0, t1);
      t0 = __fmul_rn(__fsub_rn(lo.y, oy[q]), iy[q]);
      t1 = __fmul_rn(__fsub_rn(hi.y, oy[q]), iy[q]);
      en = max_nan(en, min_nan(t0, t1));
      ex = min_nan(ex, max_nan(t0, t1));
      t0 = __fmul_rn(__fsub_rn(lo.z, oz[q]), iz[q]);
      t1 = __fmul_rn(__fsub_rn(hi.z, oz[q]), iz[q]);
      en = max_nan(en, min_nan(t0, t1));
      ex = min_nan(ex, max_nan(t0, t1));
      if (ex >= en && en <= bound[q]) {
        gmin = fminf(gmin, en);
        lb[q] = fmaxf(lb[q], en);
      }
    }
    const int kmin = __reduce_min_sync(0xffffffffu, order_key(gmin));
    const bool any = kmin != kNanKey;
    if (lane == 0) {
      if constexpr (kSort == kRows) {
        a.gent[row + j] = any ? key_value(kmin) : inf;
        a.sgm[row + j] = any;
      } else {
        s_row.key[j] = any ? (kmin == -1 ? 0 : kmin) : kInfKey;
        entered += any;
      }
    }
  };

  // warp w takes tiles w, w + warps, ...: two at a time, each box loaded
  // while the one before it is tested; the pointer steps over `warps` tiles
  const float4* box = a.tile_box + 2 * (size_t)warp;
  const int box_step = 2 * warps;
  float4 lo_a, hi_a, lo_b, hi_b;
  int j = warp;
  if (j < n_tiles) {
    lo_a = __ldg(box);
    hi_a = __ldg(box + 1);
  }
  while (j < n_tiles) {
    box += box_step;
    if (j + warps < n_tiles) {
      lo_b = __ldg(box);
      hi_b = __ldg(box + 1);
    }
    test_tile(lo_a, hi_a, j);
    j += warps;
    if (j >= n_tiles) break;
    box += box_step;
    if (j + warps < n_tiles) {
      lo_a = __ldg(box);
      hi_a = __ldg(box + 1);
    }
    test_tile(lo_b, hi_b, j);
    j += warps;
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int k = order_key(lb[q]);
    if (k != key_neg_inf) atomicMax(&s_lb[lane + 32 * q], k);
  }
  if constexpr (kSort != kRows) {
    if (lane == 0 && entered) atomicAdd(&s_row.entered, entered);
  }
  __syncthreads();
  // the lists' lane bound is min(lane bound, occ) as torch.minimum gives
  // it: a NaN occ itself, bits and all (the bound is never NaN)
  for (int i = threadIdx.x; i < kLanes; i += blockDim.x) {
    const size_t ray = (size_t)g * kLanes + i;
    float v = key_value(s_lb[i]);
    if (kSort != kRows && a.occ) {
      const float o = a.occ[ray];
      v = o != o ? o : fminf(v, o);
    }
    a.lane_bound[ray] = v;
  }

  if constexpr (kSort == kRank) {
    // tile t's list position: the keys below its own, and its own key at
    // lower tiles; read 4 at a time, the quad that holds t key by key
    if (threadIdx.x == 0) a.counts[g] = s_row.entered;
    const int4* keys = reinterpret_cast<const int4*>(s_row.key);
    const int quads = (n_tiles + 3) >> 2;
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int kt = s_row.key[t];
      const int own = t >> 2;
      int r = 0;
#pragma unroll 2
      for (int q = 0; q < own; ++q) {
        const int4 k = keys[q];
        r += (k.x <= kt) + (k.y <= kt) + (k.z <= kt) + (k.w <= kt);
      }
      {
        const int4 k = keys[own];
        const int i = 4 * own;
        r += (k.x < kt) | ((k.x == kt) & (i < t));
        r += (k.y < kt) | ((k.y == kt) & (i + 1 < t));
        r += (k.z < kt) | ((k.z == kt) & (i + 2 < t));
        r += (k.w < kt) | ((k.w == kt) & (i + 3 < t));
      }
#pragma unroll 2
      for (int q = own + 1; q < quads; ++q) {
        const int4 k = keys[q];
        r += (k.x < kt) + (k.y < kt) + (k.z < kt) + (k.w < kt);
      }
      a.lists[row + r] = t;
      a.smin[row + r] = key_value(kt);
    }
  } else if constexpr (kSort == kRadix) {
    // blocked keys (thread i holds tiles i kItems ...), flipped to the
    // unsigned order; the padding past the row sorts last
    unsigned k[kItems];
    int v[kItems];
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int tile = threadIdx.x * kItems + t;
      k[t] = tile < n_tiles ? (unsigned)s_row.key[tile] ^ 0x80000000u : 0xffffffffu;
      v[t] = tile;
    }
    if (threadIdx.x == 0) a.counts[g] = s_row.entered;
    __syncthreads();  // every key is read before the sort reuses their storage
    RadixSort<kItems>(s_row.sort).SortBlockedToStriped(k, v);
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int p = t * kThreads + threadIdx.x;
      if (p < n_tiles) {
        a.lists[row + p] = v[t];
        a.smin[row + p] = key_value((int)(k[t] ^ 0x80000000u));
      }
    }
  }
}

// Warps per block: enough blocks x warps for kFill warps on every SM, at
// most kWarps, and at least kMinTilesPerWarp tiles a warp (below that the
// per-tile work is short next to a warp's start: its ray reads, its
// reductions' barrier).
int block_warps(int n_groups, int n_tiles, int sms) {
  const long want = ((long)sms * kFill + n_groups - 1) / n_groups;
  long w = want < kWarps ? want : kWarps;
  if (w > n_tiles / kMinTilesPerWarp) w = n_tiles / kMinTilesPerWarp;
  return w < 1 ? 1 : (int)w;
}

// the device current, and its SM count (read once a device)
cudaError_t prepare(int device, int* sms_out) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                               device);
    if (e != cudaSuccess) return e;
  }
  *sms_out = sms[device];
  return cudaSuccess;
}

// the radix sort with the fewest keys a thread that hold the row
template <int kItems>
cudaError_t launch_radix(const Args& a, int n_groups, cudaStream_t stream) {
  if (kItems * kThreads < a.n_tiles) {
    if constexpr (kItems * kThreads < kRadixMaxTiles) {
      return launch_radix<2 * kItems>(a, n_groups, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  cull_tiles_kernel<kRadix, kItems><<<n_groups, kThreads, 0, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

extern "C" int cull_tiles_launch(const void* x, const void* active,
                                 const void* occ, const void* tile_box,
                                 void* sgm, void* gent, void* lane_bound,
                                 int n_groups, int n_tiles, float t_min,
                                 int device, void* stream, void* tally) {
  int sms = 0;
  cudaError_t e = prepare(device, &sms);
  if (e != cudaSuccess) return (int)e;
  if (n_groups > 0) {
    const Args a{static_cast<const float*>(x), static_cast<const float*>(active),
                 static_cast<const float*>(occ), static_cast<const float4*>(tile_box),
                 static_cast<uint8_t*>(sgm), static_cast<float*>(gent), nullptr,
                 nullptr, nullptr, static_cast<float*>(lane_bound), n_tiles, t_min,
                 static_cast<unsigned long long*>(tally)};
    const int threads = 32 * block_warps(n_groups, n_tiles, sms);
    cull_tiles_kernel<kRows, 0><<<n_groups, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int cull_tile_lists_launch(const void* x, const void* active,
                                      const void* occ, const void* tile_box,
                                      void* lists, void* counts, void* smin,
                                      void* lane_bound, int n_groups, int n_tiles,
                                      float t_min, int device, void* stream,
                                      void* tally) {
  int sms = 0;
  cudaError_t e = prepare(device, &sms);
  if (e != cudaSuccess) return (int)e;
  if (n_tiles > kRadixMaxTiles) return (int)cudaErrorInvalidValue;
  if (n_groups > 0) {
    const Args a{static_cast<const float*>(x), static_cast<const float*>(active),
                 static_cast<const float*>(occ), static_cast<const float4*>(tile_box),
                 nullptr, nullptr, static_cast<int*>(lists), static_cast<int*>(counts),
                 static_cast<float*>(smin), static_cast<float*>(lane_bound), n_tiles,
                 t_min, static_cast<unsigned long long*>(tally)};
    if (n_tiles <= kRankMaxTiles) {
      const int threads = 32 * block_warps(n_groups, n_tiles, sms);
      cull_tiles_kernel<kRank, 0><<<n_groups, threads, 0, (cudaStream_t)stream>>>(a);
    } else {
      e = launch_radix<1>(a, n_groups, (cudaStream_t)stream);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cull_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* cull_tile_lists_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
