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
// walk is serial: its list positions run one after another, each behind the
// early-exit test of the one before. On one SM the longest walk, not the
// total, set the time of a pool-width call (a 39-tile walk at tile_p 128 is
// ~80 us there, while the other SMs idle). So a second lower bound is the
// longest walk at the share of the peak of the SMs it runs on: C of them
// where a cluster of C CTAs shares the walk (below).
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
//   5. The longest walk on one SM. A subgroup's walk now runs on a thread
//      block cluster of C CTAs (C = 1, 2, 4 or 8; the grid is n_groups x C,
//      launched with cudaLaunchKernelEx and a cluster dimension, which a
//      stream capture records like any launch). CTA r of a cluster stages
//      and tests only the contiguous column slice r of every tile (tile_p /
//      C columns, split over its kSlices warps as above), so a tile costs
//      each SM 1 / C of the pairs. The early exit needs, after every tile,
//      the best t per ray over ALL columns. Each CTA min-reduces its warps'
//      running bests per ray in its own shared memory, and its warp 0
//      stores the 128 values into a slot of every CTA of the cluster
//      (distributed shared memory: mapa + st.async, whose bytes complete on
//      the receiver's mbarrier; the slot and the mbarrier alternate with the
//      list position's parity). Every warp of every CTA then reads the same
//      C x 128 values and computes the same threshold (on order-preserving
//      integer keys, one redux.sync): the exit is uniform over the cluster
//      by construction, and equals the one-CTA walk's (a min over more parts
//      is the same min). A warp tests tile j before the threshold after
//      j - 1 has arrived and undoes tile j where the rule says stop there,
//      so the exchange runs beside the arithmetic; no block or cluster
//      barrier runs per tile. One thread stages each tile slice with a bulk
//      copy (cp.async.bulk) that completes on an mbarrier of its ring slot.
//      After the walk every CTA merges its slices; rank 0 then reads the
//      peers' (t, position, column) per ray from their shared memory
//      (ld.shared::cluster) in rank order, which keeps the contract's order
//      (smallest t, earliest position, lowest column), and writes the
//      outputs; a last cluster barrier keeps every peer's shared memory
//      alive until it has.
//      The cost: about 0.7-0.9 us a tile on an H100 beside the pairs' own
//      time, whatever C (the exchange's chain of stores, waits and the
//      threshold), where one CTA's tile of 128 x 128 pairs takes ~3-4 us.
//      Worth it while a call has too few subgroups to fill the card (the
//      wavefront's pool of 256 and its drain of 8), where the longest walk
//      over C SMs sets the time; not at the scan's 7,200 subgroups, which
//      fill the card at C = 1, where the extra cost per tile is pure loss
//      (C = 2 took 57% longer there): the scan keeps the one-CTA kernel,
//      launched as before. The wrapper picks C from the subgroup count,
//      tile_p and the SM count (render/kernels/intersect_mm.py::
//      cluster_width), by a rule chosen from `chip_smoke.py --sweep`.
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
// each at the render paths' shapes, and times every cluster width there.
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
constexpr int kWarps = kThreads / 32;
constexpr int kFeatures = 12;                 // row stride of x
constexpr int kSlabFloats = 16;               // one compact slab row
constexpr int kColF4 = kSlabFloats / 4;
constexpr int kUnroll = 4;                    // columns in flight per thread
constexpr int kMaxCluster = 8;                // the portable cluster size
constexpr int kMaxSharedBytes = 48 * 1024;    // dynamic + static, no opt-in
constexpr float kParallelEps = 1e-5f;

static_assert(kRays == 1 || kRays == 2 || kRays == 4, "rays per thread");
static_assert(kSlices >= 1 && kThreads <= 1024, "at most 1024 threads");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem) : "memory");
}

// Copy n_f4 float4 into a ring slot, 16 B per thread per step, as one
// commit group.
__device__ __forceinline__ void stage_tile(float4* slot, const float4* src,
                                           int n_f4) {
  for (int k = threadIdx.x; k < n_f4; k += kThreads) cp_async16(slot + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// An s32 whose signed order is the order of the (non-NaN) floats, and back.
__device__ __forceinline__ int32_t order_key(float v) {
  const int32_t b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_float(int32_t k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float flip_sign(float v, uint32_t sign) {
  return __uint_as_float(__float_as_uint(v) ^ sign);
}

// The thread block cluster: this CTA's rank, the cluster's index along x and
// its size; its barrier (every thread of every CTA arrives; wait.acquire
// sees what the others wrote before arrive.release); shared memory
// addressed across it.
__device__ __forceinline__ uint32_t cluster_reg_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_reg_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_reg_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_peer_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ int32_t ld_peer_s32(uint32_t addr) {
  int32_t v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
// A remote store of 16 bytes that completes them on the receiver's mbarrier
// `bar` (both addresses in the receiver's shared memory, from peer_addr):
// no fence and no cluster barrier; the receiver waits on its own mbarrier.
__device__ __forceinline__ void st_async4(uint32_t addr, uint32_t bar, int4 v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

// mbarriers: one of `count` arrivals, its init made visible to the cluster;
// an arrival; this thread's arrival for the current phase, which then also
// waits for `bytes` of asynchronous copies or stores; the wait for the
// phase of parity `parity`.
__device__ __forceinline__ void mbar_init(const uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(const uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(const uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// One thread copies n_bytes (a multiple of 16) into this CTA's shared
// memory; the bytes complete on the mbarrier `bar`, whose phase this thread
// arms with its arrival.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t n_bytes,
                                          const uint64_t* bar) {
  mbar_expect(bar, n_bytes);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(n_bytes), "r"(smem_u32(bar))
               : "memory");
}

// A thread's rays' features: d, m = o x d and o, kRays of each.
struct Rays {
  float d0[kRays], d1[kRays], d2[kRays], m0[kRays], m1[kRays], m2[kRays];
  float o0[kRays], o1[kRays], o2[kRays];
};
// per ray, the best over the walked tiles of this thread's columns: the
// first (list position, column) of its smallest t
struct Best {
  float t[kRays];
  int32_t col[kRays], pos[kRays];
};

// Test columns [c_begin, c_begin + cols) of the staged tile `tw` (list
// position j, first column `base`) against the thread's rays.
__device__ __forceinline__ void test_tile(const float4* tw, int c_begin, int cols,
                                          int32_t base, int j, float t_min,
                                          const Rays& r, Best& best) {
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
        float sa = r.d0[q] * -q0.x;
        sa = fmaf(r.d1[q], -q0.y, sa);
        sa = fmaf(r.d2[q], -q0.z, sa);
        float su = r.d0[q] * -q3.y;
        su = fmaf(r.d1[q], -q3.z, su);
        su = fmaf(r.d2[q], -q3.w, su);
        su = fmaf(r.m0[q], q2.z, su);
        su = fmaf(r.m1[q], q2.w, su);
        su = fmaf(r.m2[q], q3.x, su);
        float sv = r.d0[q] * -q1.w;
        sv = fmaf(r.d1[q], -q2.x, sv);
        sv = fmaf(r.d2[q], -q2.y, sv);
        sv = fmaf(r.m0[q], -q1.x, sv);
        sv = fmaf(r.m1[q], -q1.y, sv);
        sv = fmaf(r.m2[q], -q1.z, sv);
        float st = r.o0[q] * q0.x;
        st = fmaf(r.o1[q], q0.y, st);
        st = fmaf(r.o2[q], q0.z, st);
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
            if (t < best.t[q]) {  // strict: the lowest column, the first tile
              best.t[q] = t;
              best.col[q] = base + c + u;
              best.pos[q] = j;
            }
          }
        }
      }
    }
  }
}

// The max over the lanes of min(t[q], lb[q]), every thread's kRays rays:
// the early-exit threshold. Every warp holds it (through wmax where a slice
// spans several warps).
__device__ __forceinline__ float lane_threshold(const float (&t)[kRays],
                                                const float (&lb)[kRays], int warp,
                                                int slice, float* wmax) {
  float v = fminf(t[0], lb[0]);
#pragma unroll
  for (int q = 1; q < kRays; ++q) v = fmaxf(v, fminf(t[q], lb[q]));
  v = warp_max(v);
  if (kRayWarps > 1) {
    if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = v;
    __syncthreads();
    v = wmax[0];
#pragma unroll
    for (int k = 1; k < kRayWarps; ++k) v = fmaxf(v, wmax[k]);
  }
  return v;
}

// the kernels' parameters, and the same names passed on
#define MM_ARGS                                                      \
  const int32_t* __restrict__ lists,      /* (G, n_tiles) */          \
  const int32_t* __restrict__ counts,     /* (G,) */                  \
  const float* __restrict__ smin,         /* (G, n_tiles) */          \
  const float* __restrict__ x,            /* (G*128, 12) */           \
  const float* __restrict__ lane_bound,   /* (G*128,) */              \
  const float4* __restrict__ w,           /* (n_tiles, tile_p, 16) */ \
  float* __restrict__ out_t,              /* (G*128,) */              \
  int32_t* __restrict__ out_col,          /* (G*128,) */              \
  int32_t* __restrict__ walked,           /* (G,) or null */          \
  int n_tiles, int tile_p, float t_min,                               \
  unsigned long long* __restrict__ tally  /* (2,) or null */
#define MM_PASS                                                          \
  lists, counts, smin, x, lane_bound, w, out_t, out_col, walked, n_tiles, \
      tile_p, t_min, tally

// One subgroup's walk. kCluster: the walk is shared by the CTAs of a
// cluster (cluster size > 1); false is the one-CTA walk, with no cluster
// instruction.
template <bool kCluster>
__device__ __forceinline__ void walk(MM_ARGS) {
  // 2 slots of this CTA's columns of one tile; in a cluster, after them,
  // the threshold exchange (below) and its six mbarriers
  extern __shared__ float4 ring[];
  __shared__ float slice_t[kSlices][kLanes];      // slices' best t per ray
  __shared__ int32_t slice_col[kSlices][kLanes];  // ... and its column
  __shared__ int32_t slice_pos[kSlices][kLanes];  // ... and list position
  __shared__ float wmax[kRayWarps];               // threshold partials

  const int n_cta = kCluster ? (int)cluster_reg_size() : 1;
  const int rank = kCluster ? (int)cluster_reg_rank() : 0;
  const int g = kCluster ? (int)cluster_reg_id() : blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int slice = warp / kRayWarps;
  // this thread's rays in the subgroup: r0 + q * kRayThreads, q < kRays
  const int r0 = (warp % kRayWarps) * 32 + (threadIdx.x & 31);
  const float inf = __int_as_float(0x7f800000);
  // the launch, counted on the device (a CUDA graph's replay counts too),
  // and in the second slot the launches that shared walks over clusters
  if (tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(tally, 1ull);
    if (kCluster) atomicAdd(tally + 1, 1ull);
  }

  Rays ray;
  Best best;
  float lb[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t i = (size_t)g * kLanes + r0 + q * kRayThreads;
    const float4* xp = reinterpret_cast<const float4*>(x + i * kFeatures);
    const float4 a = xp[0], b = xp[1], c = xp[2];
    ray.d0[q] = a.x; ray.d1[q] = a.y; ray.d2[q] = a.z;
    ray.m0[q] = a.w; ray.m1[q] = b.x; ray.m2[q] = b.y;
    ray.o0[q] = b.z; ray.o1[q] = b.w; ray.o2[q] = c.x;
    lb[q] = lane_bound[i];
    best.t[q] = inf;
    best.col[q] = -1;
    best.pos[q] = 0;
  }

  const int32_t* glist = lists + (size_t)g * n_tiles;
  const float* gsmin = smin + (size_t)g * n_tiles;
  const int cnt = counts[g];
  const int tile_f4 = tile_p * kColF4;
  const int cta_cols = tile_p / n_cta;            // this CTA's column slice
  const int cta_f4 = cta_cols * kColF4;
  const float4* wcta = w + rank * cta_f4;         // ... of tile 0
  const int cols = cta_cols / kSlices;            // ... of this warp
  const int c_begin = slice * cols;
  // in a cluster, per parity of the list position: this CTA's best t per
  // ray and every CTA's (order keys, ray r0 + q * kRayThreads at r0 * kRays
  // + q), and the mbarriers of the CTAs' parts (xbar), of the ring's slots
  // (full) and of this CTA's warps' parts (wbar)
  int32_t* loc = reinterpret_cast<int32_t*>(ring + 2 * cta_f4);
  int32_t* part = loc + 2 * kLanes;  // [parity][source rank][128]
  const uint64_t* xbar = reinterpret_cast<const uint64_t*>(part + 2 * n_cta * kLanes);
  const uint64_t* full = xbar + 2;
  const uint64_t* wbar = xbar + 4;
  // a peer's shared memory is reduced into only once every CTA of the
  // cluster runs and has set up its slots and mbarriers: this arrival's
  // wait comes before the first remote operation
  if (kCluster) {
    for (int k = threadIdx.x; k < 2 * kLanes; k += kThreads) loc[k] = order_key(inf);
    if (threadIdx.x == 0) {
      for (int k = 0; k < 4; ++k) mbar_init(xbar + k, 1);
      mbar_init(wbar, kWarps);
      mbar_init(wbar + 1, kWarps);
    }
    __syncthreads();
    cluster_arrive();
  }
  bool started = !kCluster;

  int j = 0;
  if (!kCluster) {
    if (cnt > 0) stage_tile(ring, wcta + (size_t)glist[0] * tile_f4, cta_f4);
    {
      float v = lb[0];
#pragma unroll
      for (int q = 1; q < kRays; ++q) v = fmaxf(v, lb[q]);
      v = warp_max(v);
      if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = v;
    }
    for (; j < cnt; ++j) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // tile j is in its slot for every thread, the threshold partials of
      // the last tile are published, and slot (j + 1) & 1 is no longer read
      __syncthreads();
      float thr = wmax[0];
#pragma unroll
      for (int k = 1; k < kRayWarps; ++k) thr = fmaxf(thr, wmax[k]);
      if (!(gsmin[j] <= thr)) break;  // block-uniform
      if (j + 1 < cnt) {
        stage_tile(ring + ((j + 1) & 1) * cta_f4, wcta + (size_t)glist[j + 1] * tile_f4,
                   cta_f4);
      }
      test_tile(ring + (j & 1) * cta_f4, c_begin, cols, glist[j] * tile_p, j, t_min,
                ray, best);
      // the threshold for position j + 1: per ray the best t over the
      // slices, then the max over the lanes of min(best t, lane bound)
#pragma unroll
      for (int q = 0; q < kRays; ++q) slice_t[slice][r0 + q * kRayThreads] = best.t[q];
      __syncthreads();
      float v = -inf;
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        const int r = r0 + q * kRayThreads;
        float b = slice_t[0][r];
#pragma unroll
        for (int s = 1; s < kSlices; ++s) b = fminf(b, slice_t[s][r]);
        v = fmaxf(v, fminf(b, lb[q]));
      }
      v = warp_max(v);
      if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = v;
    }
  } else {
    // The walk over a cluster. Tile j is tested before the exit rule has
    // decided on it: the threshold after tile j - 1 needs every CTA's part,
    // and waiting for it would leave the SM idle. The parts arrive while
    // tile j runs; where the rule says stop at j, this CTA's best goes back
    // to what it was before tile j, so the outputs and `walked` are those of
    // the one-CTA walk.
    // The exchange of position j, in slot p = j & 1, with no block or
    // cluster barrier: every thread min-reduces its running best per ray
    // into loc[p] (shared atomics) and its warp arrives on wbar[p]; warp 0
    // waits for the warps, then stores loc[p] into part[p][rank] of every
    // CTA of the cluster with st.async, which completes on that CTA's
    // xbar[p] (phase (j >> 1) & 1); a thread deciding on j + 1 waits on
    // xbar[p] and takes the min over the C parts. No slot is written too
    // early: a thread adds position j + 2 only after the exchange of j + 1,
    // which every warp of every CTA joined after it had read j; and loc[p]
    // is never reset, since a running best never grows, so its min over
    // positions j, j - 2, ... is that of j. Thread 0 stages tile j into ring
    // slot p with one bulk copy that completes on full[p], and tile j + 2
    // once wbar[p] says that no warp reads the slot any more.
    int issued = 0, landed = 0;  // tiles staged, and waited for
    auto stage = [&](int k, int32_t entry) {  // tile `entry` at list position k
      if (threadIdx.x == 0) {
        bulk_copy(ring + (k & 1) * cta_f4, wcta + (size_t)entry * tile_f4,
                  cta_f4 * sizeof(float4), full + (k & 1));
      }
      ++issued;
    };
    if (cnt > 0) stage(0, glist[0]);
    if (cnt > 1) stage(1, glist[1]);
    int32_t tile = cnt > 0 ? glist[0] : 0;        // entry j
    int32_t staged = cnt > 2 ? glist[2] : 0;      // entry j + 2
    float smin_next = cnt > 0 ? gsmin[0] : 0.f;   // smin of j
    bool unread = false;  // the exchange of the last position is not waited for
    float thr = lane_threshold(lb, lb, warp, slice, wmax);  // max of the bounds
    // the bounds as keys, NaN as +inf: min(key(t), key(bound)) is then the
    // key of fminf(t, bound) for every t a walk holds (never NaN)
    int32_t lbk[kRays];
#pragma unroll
    for (int q = 0; q < kRays; ++q) lbk[q] = order_key(lb[q] == lb[q] ? lb[q] : inf);
    if (cnt > 0 && gsmin[0] <= thr) {
      for (;;) {
        const int p = j & 1;
        const int32_t tile_j = tile;
        const float smin_j = smin_next;
        const int32_t stage_j = staged;
        // the next position's list entries and smin, loaded while j runs
        tile = j + 1 < cnt ? glist[j + 1] : 0;
        staged = j + 3 < cnt ? glist[j + 3] : 0;
        smin_next = j + 1 < cnt ? gsmin[j + 1] : 0.f;
        mbar_wait(full + p, (j >> 1) & 1);  // tile j is in its slot
        ++landed;
        const Best before = best;
        test_tile(ring + p * cta_f4, c_begin, cols, tile_j * tile_p + rank * cta_cols, j,
                  t_min, ray, best);
        if (j > 0) {
          // the cluster's best after position j - 1: the same threshold in
          // every warp of every CTA, so the exit is uniform over the cluster
          mbar_wait(xbar + (p ^ 1), ((j - 1) >> 1) & 1);
          unread = false;
          const int32_t* k = part + (p ^ 1) * n_cta * kLanes + r0 * kRays;
          int32_t b[kRays];
#pragma unroll
          for (int q = 0; q < kRays; ++q) b[q] = k[q];
          for (int r = 1; r < n_cta; ++r) {
#pragma unroll
            for (int q = 0; q < kRays; ++q) b[q] = min(b[q], k[r * kLanes + q]);
          }
          int32_t v = min(b[0], lbk[0]);
#pragma unroll
          for (int q = 1; q < kRays; ++q) v = max(v, min(b[q], lbk[q]));
          v = __reduce_max_sync(0xffffffffu, v);
          thr = key_float(v);
          if (kRayWarps > 1) {  // a slice spans several warps
            if (slice == 0 && (threadIdx.x & 31) == 0) wmax[warp] = thr;
            __syncthreads();
#pragma unroll
            for (int w = 0; w < kRayWarps; ++w) thr = fmaxf(thr, wmax[w]);
          }
          if (!(smin_j <= thr)) {
            best = before;
            break;
          }
        }
        int32_t* mine = loc + p * kLanes + r0 * kRays;
#pragma unroll
        for (int q = 0; q < kRays; ++q) atomicMin(mine + q, order_key(best.t[q]));
        if (!started) {
          cluster_wait();
          started = true;
        }
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(wbar + p);
        if (warp == 0) {
          mbar_wait(wbar + p, (j >> 1) & 1);
          if (threadIdx.x == 0) {
            if (j + 2 < cnt) {
              bulk_copy(ring + p * cta_f4, wcta + (size_t)stage_j * tile_f4,
                        cta_f4 * sizeof(float4), full + p);
            }
            mbar_expect(xbar + p, n_cta * kLanes * sizeof(int32_t));
          }
          // 128 keys, 4 a lane
          const int e = (threadIdx.x & 31) * 4;
          const int4 v = *reinterpret_cast<const int4*>(loc + p * kLanes + e);
          const int32_t* slot = part + (p * n_cta + rank) * kLanes + e;
          for (int r = 0; r < n_cta; ++r) {
            st_async4(peer_addr(slot, r), peer_addr(xbar + p, r), v);
          }
        }
        if (j + 2 < cnt) ++issued;
        unread = true;
        if (++j == cnt) break;
      }
    }
    // no remote operation and no copy lands in a CTA that has left
    if (unread) mbar_wait(xbar + ((j - 1) & 1), ((j - 1) >> 1) & 1);
    for (; landed < issued; ++landed) mbar_wait(full + (landed & 1), (landed >> 1) & 1);
    if (!started) cluster_wait();
  }

  // merge the slices: the smallest t, then the earliest list position, then
  // the lowest column (slices hold ascending column ranges)
  __syncthreads();  // every read of slice_t above is done
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int r = r0 + q * kRayThreads;
    slice_t[slice][r] = best.t[q];
    slice_col[slice][r] = best.col[q];
    slice_pos[slice][r] = best.pos[q];
  }
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int r = r0 + q * kRayThreads;
#pragma unroll
      for (int s = 1; s < kSlices; ++s) {
        const float t = slice_t[s][r];
        const int32_t p = slice_pos[s][r];
        if (t < best.t[q] || (t == best.t[q] && p < best.pos[q])) {
          best.t[q] = t;
          best.col[q] = slice_col[s][r];
          best.pos[q] = p;
        }
      }
      // in a cluster, this CTA's winner where its peers' rank 0 reads it
      // (slice 0's own row: no other thread reads it any more)
      if (kCluster) {
        slice_t[0][r] = best.t[q];
        slice_col[0][r] = best.col[q];
        slice_pos[0][r] = best.pos[q];
      }
    }
  }
  if (kCluster) {
    // merge the CTAs in rank order (ascending column slices) in rank 0
    cluster_arrive();
    cluster_wait();
    if (rank == 0 && slice == 0) {
      for (int p = 1; p < n_cta; ++p) {
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          const int r = r0 + q * kRayThreads;
          const float t = ld_peer_f32(peer_addr(&slice_t[0][r], p));
          const int32_t pos = ld_peer_s32(peer_addr(&slice_pos[0][r], p));
          if (t < best.t[q] || (t == best.t[q] && pos < best.pos[q])) {
            best.t[q] = t;
            best.col[q] = ld_peer_s32(peer_addr(&slice_col[0][r], p));
            best.pos[q] = pos;
          }
        }
      }
    }
    // every peer's shared memory stays until rank 0 has read it
    cluster_arrive();
    cluster_wait();
  }
  if (rank == 0 && slice == 0) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const size_t i = (size_t)g * kLanes + r0 + q * kRayThreads;
      out_t[i] = best.t[q];
      out_col[i] = best.col[q];
    }
    if (walked != nullptr && r0 == 0) walked[g] = j;
  }
}

__global__ void __launch_bounds__(kThreads) mm_closest_hit_kernel(MM_ARGS) {
  walk<false>(MM_PASS);
}

// the same name in its own namespace, so a profile's kernel name still
// reads mm_closest_hit_kernel; two CTAs an SM, as the one-CTA kernel has
namespace clustered {
__global__ void __launch_bounds__(kThreads, 2) mm_closest_hit_kernel(MM_ARGS) {
  walk<true>(MM_PASS);
}
}  // namespace clustered

}  // namespace

extern "C" int mm_closest_hit_launch(const void* lists, const void* counts,
                                     const void* smin, const void* x,
                                     const void* lane_bound, const void* w,
                                     void* out_t, void* out_col, void* walked,
                                     int n_groups, int n_tiles, int tile_p,
                                     float t_min, int cluster, int device,
                                     void* stream, void* tally) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  // the ring of this CTA's columns (two slots of 16 KB at tile_p 128, 32 KB
  // at 256 for one CTA) and, in a cluster, the threshold exchange
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      tile_p <= 0 || tile_p % (cluster * kSlices * kUnroll) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t ring = 2 * (size_t)(tile_p / cluster) * kSlabFloats * sizeof(float);
  const size_t xch = cluster > 1 ? (2 + 2 * (size_t)cluster) * kLanes * sizeof(int32_t) +
                                      6 * sizeof(uint64_t)
                                : 0;
  const size_t fixed = (size_t)kSlices * kLanes * 12 + kRayWarps * 4;
  if (ring + xch + fixed > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (n_groups <= 0) return (int)cudaGetLastError();
  const int32_t* l = static_cast<const int32_t*>(lists);
  const int32_t* cn = static_cast<const int32_t*>(counts);
  const float* sm = static_cast<const float*>(smin);
  const float* xf = static_cast<const float*>(x);
  const float* lbf = static_cast<const float*>(lane_bound);
  const float4* wf = static_cast<const float4*>(w);
  float* ot = static_cast<float*>(out_t);
  int32_t* oc = static_cast<int32_t*>(out_col);
  int32_t* wk = static_cast<int32_t*>(walked);
  unsigned long long* ty = static_cast<unsigned long long*>(tally);
  if (cluster == 1) {
    mm_closest_hit_kernel<<<n_groups, kThreads, ring, (cudaStream_t)stream>>>(
        l, cn, sm, xf, lbf, wf, ot, oc, wk, n_tiles, tile_p, t_min, ty);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_groups * (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ring + xch;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, clustered::mm_closest_hit_kernel, l, cn, sm, xf, lbf, wf,
                         ot, oc, wk, n_tiles, tile_p, t_min, ty);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* mm_closest_hit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
