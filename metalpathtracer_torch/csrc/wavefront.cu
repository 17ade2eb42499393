// The persistent wavefront's regeneration, for Hopper: four kernels that
// take the place of some 76 small torch kernels an advance.
//
// Replaces the JAX package's XLA fusions of the wavefront's lane refill
// (no Pallas body): `one_advance`'s queue pop
// (metalpathtracer_tpu/render/integrator.py:979-995), `restart_lanes`
// (:768-779) with `pix_samp_of` (:624-638) and `generate_rays`
// (render/pipeline.py:33), and `maybe_sort`'s tile-set key and its pack
// and gather of the lane state (:835-870, :916-940). In the port they are
// render/integrator.py::_Wavefront's `restart_lanes`, `window`'s queue and
// `sort_pool`; their plain versions are
// render/kernels/wavefront.py::*_reference.
//
// restart_lanes  one thread a lane. From the lane's work item and its
//   sample chunk it computes its local pixel l = (item % groups) * bank_k +
//   schunk / spb, its pixel pixel_offset + l + (l / width) * (row_stride -
//   1) * width (row_stride 1: a contiguous range; n: every n-th row of a
//   tile shard) and its sample (item / groups) * spb + schunk % spb +
//   sample_offset (int64; sample_offset read from its 0-d tensor, so a
//   replayed CUDA graph sees each render's value) and writes both for
//   every lane. Where `restart` is set it draws the jitter pair
//   (threefry of key (seed, pixel), counter (sample, 0): purpose 0 at
//   bounce 0, threefry_rounds.cuh's rounds) and builds the primary ray from
//   the (4, 3) camera basis [origin, first_pixel, u, v]:
//     sx = (px + u1) * (1 / W), sy = (py + u2) * (1 / H)
//     d = ((first_pixel + sx u) + sy v) - origin, d /= |d|
//   and resets the lane: o = origin, tp = 1, bounce = 0, prev_pdf = 0,
//   alive = 1; other lanes keep their state. The order is the plain
//   version's as torch runs it on the card: a tensor divided by a Python
//   number is multiplied by the number's float32 reciprocal there (torch's
//   CUDA division by a CPU scalar), and `torch.linalg.vector_norm` over
//   the 3 components adds (d0^2 + d2^2) + d1^2 (measured on an H100:
//   every other order of the sum differs from it on some rays); d / |d| is
//   an IEEE division.
// queue_pop  the window's queue after an advance, in place: where `bank`
//   (the lane finished its work item) pend_idx = item % groups, the pend
//   row = the accumulator row, the accumulator row = 0; every banked lane
//   takes the next item of the queue in lane order, item' = next_item +
//   (its rank among banked lanes: torch.cumsum's order), and regenerates
//   where item' < total; restart = more | regen. Block B-1 writes
//   next_item' = min(next_item + (banked lanes), total) to its own 0-d
//   output. Each block counts the banked lanes before its own range
//   itself (16-byte loads of the bool mask, mostly from L2), then ranks
//   its lanes with warp ballots and one scan of the warps' counts a tile of
//   1,024 lanes: one launch, no second pass and no flags between blocks.
// tileset_key  one thread a lane: the slab test of
//   render/kernels/intersect_mm.py::_cull_hit_mask against the <= 32
//   coarse boxes (staged in shared memory): t0 = (lo - o) * (1 / d),
//   t1 = (hi - o) * (1 / d); an axis whose min (or max) of t0, t1 is NaN
//   does not constrain (torch.minimum and torch.maximum propagate NaN,
//   which the plain version then replaces by -inf / +inf; fminf would
//   drop it); bit c is set where exit > enter on a live lane (enter starts
//   at t_min, exit at +inf). The key is written as int32 key - 2^31, an
//   order-preserving map of the 32-bit signature, so that torch's stable
//   argsort sorts 32-bit keys and gives the permutation of the int64 key.
// permute_lanes  one thread an output lane: row perm[i] of every lane
//   field (o, d, the accumulator row, light, throughput, prev_pdf, item,
//   schunk, bounce, alive, pixel, sample and, in the feed, the pending
//   bank's index and row) into row i of contiguous outputs. Pure data
//   movement, so bit-equal by construction.
//
// What bounds them on an H100 SXM: bytes and the launch. At the pool's
// 32,768 lanes the restart moves about 130 B a lane (4.3 MB: ~1.3 us at
// 3.35 TB/s), the queue about 12 B a lane plus the banked lanes' rows, the
// key 25 B a lane, the gather twice the lane state (about 200 B a lane at
// bank_k 4); each is a few microseconds, mostly its launch and one or two
// dependent rounds of loads. Built with -fmad=false, like the bounce
// step's kernels: no product is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry_rounds.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQueueThreads = 1024;  // a queue tile: one lane a thread
constexpr int kQueueBlocks = 128;    // the queue's grid grows in tiles past this
constexpr int kMaxBoxes = 32;        // bits of the tile-set key
constexpr int kBoxFloats = 8;        // [lo xyz, 0, hi xyz, 0]

__device__ __forceinline__ void count_launch(unsigned long long* tally) {
  if (tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(tally, 1ull);
}

// ---------------------------------------------------------------- restart

struct RestartArgs {
  const long long* __restrict__ item;
  const long long* __restrict__ schunk;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ tp;
  const long long* __restrict__ bounce;
  const float* __restrict__ prev_pdf;
  const bool* __restrict__ alive;
  const bool* __restrict__ restart;
  const float* __restrict__ basis;  // (4, 3): origin, first_pixel, u, v
  const long long* __restrict__ sample_offset;  // 0-d
  float* __restrict__ o_out;
  float* __restrict__ d_out;
  float* __restrict__ tp_out;
  long long* __restrict__ bounce_out;
  float* __restrict__ prev_pdf_out;
  bool* __restrict__ alive_out;
  long long* __restrict__ pixel_out;
  long long* __restrict__ sample_out;
  long long n, width, height, groups, bank_k, spb, pixel_offset, row_stride;
  uint32_t seed;
};

__global__ void __launch_bounds__(kThreads)
restart_lanes_kernel(RestartArgs a, unsigned long long* __restrict__ tally) {
  count_launch(tally);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long item = a.item[i], schunk = a.schunk[i];
  const bool restart = a.restart[i];
  const long long local = (item % a.groups) * a.bank_k + schunk / a.spb;
  const long long pixel =
      a.pixel_offset + local + (local / a.width) * ((a.row_stride - 1) * a.width);
  const long long sample = (item / a.groups) * a.spb + schunk % a.spb + *a.sample_offset;
  a.pixel_out[i] = pixel;
  a.sample_out[i] = sample;
  if (!restart) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.o_out[3 * i + c] = a.o[3 * i + c];
      a.d_out[3 * i + c] = a.d[3 * i + c];
      a.tp_out[3 * i + c] = a.tp[3 * i + c];
    }
    a.bounce_out[i] = a.bounce[i];
    a.prev_pdf_out[i] = a.prev_pdf[i];
    a.alive_out[i] = a.alive[i];
    return;
  }
  // the jitter pair: uniform2(seed, pixel, sample, bounce 0, purpose 0)
  uint32_t x0[1] = {(uint32_t)sample}, x1[1] = {0u};
  threefry2x32<1>(a.seed, (uint32_t)pixel, x0, x1);
  const float u1 = to_uniform(x0[0]), u2 = to_uniform(x1[0]);
  const float px = (float)(pixel % a.width);
  const float py = (float)(pixel / a.width);
  const float sx = (px + u1) * (1.0f / (float)a.width);
  const float sy = (py + u2) * (1.0f / (float)a.height);
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = ((a.basis[3 + c] + sx * a.basis[6 + c]) + sy * a.basis[9 + c]) - a.basis[c];
  }
  const float norm = sqrtf((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.o_out[3 * i + c] = a.basis[c];
    a.d_out[3 * i + c] = d[c] / norm;
    a.tp_out[3 * i + c] = 1.0f;
  }
  a.bounce_out[i] = 0;
  a.prev_pdf_out[i] = 0.0f;
  a.alive_out[i] = true;
}

// ------------------------------------------------------------------ queue

struct QueueArgs {
  const bool* __restrict__ bank;
  const bool* __restrict__ more;
  const long long* __restrict__ next_item;  // 0-d
  long long* __restrict__ item;             // in place
  float* __restrict__ acc;                  // in place
  long long* __restrict__ pend_idx;         // in place
  float* __restrict__ pend_rgb;             // in place
  bool* __restrict__ restart;
  long long* __restrict__ next_out;  // 0-d
  long long n, total, groups, tile_lanes;  // tile_lanes: lanes a block
  int ka;
};

// the block's sum of `v` (every thread gets it); `warp_sums` holds 32
__device__ __forceinline__ long long block_sum(long long v, long long* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kQueueThreads / 32; ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(kQueueThreads)
queue_pop_kernel(QueueArgs a, unsigned long long* __restrict__ tally) {
  __shared__ long long warp_sums[kQueueThreads / 32];
  __shared__ int warp_counts[kQueueThreads / 32];
  count_launch(tally);
  const long long first = (long long)blockIdx.x * a.tile_lanes;
  const long long next_item = *a.next_item;
  // the banked lanes before this block's first lane: its bytes as 16-byte
  // words (first is a multiple of 1,024, the mask 16-byte aligned)
  long long before = 0;
  const uint4* words = reinterpret_cast<const uint4*>(a.bank);
  for (long long w = threadIdx.x; w < first / 16; w += kQueueThreads) {
    const uint4 v = words[w];
    before += __popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
              __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u));
  }
  long long rank = block_sum(before, warp_sums) / 8;  // __vcmpne4 sets 8 bits a byte
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long end = min(first + a.tile_lanes, a.n);
  for (long long base = first; base < end; base += kQueueThreads) {
    const long long i = base + threadIdx.x;
    const bool live = i < end;
    const bool bank = live && a.bank[i];
    const bool more = live && a.more[i];
    const long long item = live ? a.item[i] : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, bank);
    __syncthreads();  // warp_counts may still be read by the last tile
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int warp_before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kQueueThreads / 32; ++w) {
      warp_before += w < warp ? warp_counts[w] : 0;
      tile += warp_counts[w];
    }
    const long long mine = rank + warp_before + __popc(ballot & ((1u << lane) - 1u));
    rank += tile;
    if (!live) continue;
    bool regen = false;
    if (bank) {
      a.pend_idx[i] = item % a.groups;
      float* row = a.acc + i * a.ka;
      float* pend = a.pend_rgb + i * a.ka;
      for (int c = 0; c < a.ka; ++c) {
        pend[c] = row[c];
        row[c] = 0.0f;
      }
      const long long new_item = next_item + mine;
      regen = new_item < a.total;
      if (regen) a.item[i] = new_item;
    }
    a.restart[i] = more || regen;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *a.next_out = min(next_item + rank, a.total);
  }
}

// --------------------------------------------------------------- tile set

__device__ __forceinline__ bool either_nan(float x, float y) {
  return isnan(x) || isnan(y);
}

__global__ void __launch_bounds__(kThreads)
tileset_key_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const bool* __restrict__ alive, const float* __restrict__ box,
                   int* __restrict__ key, long long n, int nc, float t_min,
                   unsigned long long* __restrict__ tally) {
  __shared__ float sbox[kMaxBoxes * kBoxFloats];
  count_launch(tally);
  for (int k = threadIdx.x; k < nc * kBoxFloats; k += kThreads) sbox[k] = box[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t bits = 0;
  if (alive[i]) {
    float oa[3], ia[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      oa[c] = o[3 * i + c];
      ia[c] = 1.0f / d[3 * i + c];
    }
    for (int b = 0; b < nc; ++b) {
      const float* bx = sbox + b * kBoxFloats;
      float enter = t_min, exit = INFINITY;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t0 = (bx[c] - oa[c]) * ia[c];
        const float t1 = (bx[4 + c] - oa[c]) * ia[c];
        const bool nan = either_nan(t0, t1);
        enter = fmaxf(enter, nan ? -INFINITY : fminf(t0, t1));
        exit = fminf(exit, nan ? INFINITY : fmaxf(t0, t1));
      }
      bits |= (exit > enter ? 1u : 0u) << b;
    }
  }
  key[i] = (int)(bits ^ 0x80000000u);
}

// ---------------------------------------------------------------- gather

struct LaneFields {
  const float* o; const float* d; const float* acc; const float* light;
  const float* tp; const float* prev_pdf; const long long* item;
  const long long* schunk; const long long* bounce; const bool* alive;
  const long long* pixel; const long long* sample; const long long* pend_idx;
  const float* pend_rgb;
};

struct LaneOutputs {
  float* o; float* d; float* acc; float* light; float* tp; float* prev_pdf;
  long long* item; long long* schunk; long long* bounce; bool* alive;
  long long* pixel; long long* sample; long long* pend_idx; float* pend_rgb;
};

__global__ void __launch_bounds__(kThreads)
permute_lanes_kernel(const long long* __restrict__ perm, LaneFields in, LaneOutputs out,
                     long long n, int ka, unsigned long long* __restrict__ tally) {
  count_launch(tally);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.o[3 * i + c] = in.o[3 * j + c];
    out.d[3 * i + c] = in.d[3 * j + c];
    out.light[3 * i + c] = in.light[3 * j + c];
    out.tp[3 * i + c] = in.tp[3 * j + c];
  }
  for (int c = 0; c < ka; ++c) out.acc[i * ka + c] = in.acc[j * ka + c];
  out.prev_pdf[i] = in.prev_pdf[j];
  out.item[i] = in.item[j];
  out.schunk[i] = in.schunk[j];
  out.bounce[i] = in.bounce[j];
  out.alive[i] = in.alive[j];
  out.pixel[i] = in.pixel[j];
  out.sample[i] = in.sample[j];
  if (in.pend_idx != nullptr) {
    out.pend_idx[i] = in.pend_idx[j];
    for (int c = 0; c < ka; ++c) out.pend_rgb[i * ka + c] = in.pend_rgb[j * ka + c];
  }
}

int use_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

unsigned grid_of(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int restart_lanes_launch(
    const void* item, const void* schunk, const void* o, const void* d, const void* tp,
    const void* bounce, const void* prev_pdf, const void* alive, const void* restart,
    const void* basis, const void* sample_offset, void* o_out, void* d_out, void* tp_out,
    void* bounce_out, void* prev_pdf_out, void* alive_out, void* pixel_out,
    void* sample_out, long long n, long long width, long long height, long long groups,
    long long bank_k, long long spb, long long pixel_offset, long long row_stride,
    uint32_t seed, int device, void* stream, void* tally) {
  const int rc = use_device(device);
  if (rc != 0) return rc;
  if (width < 1 || height < 1 || groups < 1 || spb < 1 || row_stride < 1)
    return (int)cudaErrorInvalidValue;
  RestartArgs a;
  a.item = static_cast<const long long*>(item);
  a.schunk = static_cast<const long long*>(schunk);
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.tp = static_cast<const float*>(tp);
  a.bounce = static_cast<const long long*>(bounce);
  a.prev_pdf = static_cast<const float*>(prev_pdf);
  a.alive = static_cast<const bool*>(alive);
  a.restart = static_cast<const bool*>(restart);
  a.basis = static_cast<const float*>(basis);
  a.sample_offset = static_cast<const long long*>(sample_offset);
  a.o_out = static_cast<float*>(o_out);
  a.d_out = static_cast<float*>(d_out);
  a.tp_out = static_cast<float*>(tp_out);
  a.bounce_out = static_cast<long long*>(bounce_out);
  a.prev_pdf_out = static_cast<float*>(prev_pdf_out);
  a.alive_out = static_cast<bool*>(alive_out);
  a.pixel_out = static_cast<long long*>(pixel_out);
  a.sample_out = static_cast<long long*>(sample_out);
  a.n = n;
  a.width = width;
  a.height = height;
  a.groups = groups;
  a.bank_k = bank_k;
  a.spb = spb;
  a.pixel_offset = pixel_offset;
  a.row_stride = row_stride;
  a.seed = seed;
  if (n <= 0) return (int)cudaSuccess;
  restart_lanes_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* restart_lanes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int queue_pop_launch(const void* bank, const void* more, const void* next_item,
                                void* item, void* acc, void* pend_idx, void* pend_rgb,
                                void* restart, void* next_out, long long n, int ka,
                                long long total, long long groups, int device,
                                void* stream, void* tally) {
  const int rc = use_device(device);
  if (rc != 0) return rc;
  if (groups < 1 || ka < 1 || n < 1) return (int)cudaErrorInvalidValue;
  QueueArgs a;
  a.bank = static_cast<const bool*>(bank);
  a.more = static_cast<const bool*>(more);
  a.next_item = static_cast<const long long*>(next_item);
  a.item = static_cast<long long*>(item);
  a.acc = static_cast<float*>(acc);
  a.pend_idx = static_cast<long long*>(pend_idx);
  a.pend_rgb = static_cast<float*>(pend_rgb);
  a.restart = static_cast<bool*>(restart);
  a.next_out = static_cast<long long*>(next_out);
  a.n = n;
  a.total = total;
  a.groups = groups;
  a.ka = ka;
  // whole tiles of 1,024 lanes a block, as many as keep the grid at
  // kQueueBlocks or fewer
  const long long tiles = (n + kQueueThreads - 1) / kQueueThreads;
  const long long per_block = (tiles + kQueueBlocks - 1) / kQueueBlocks;
  a.tile_lanes = per_block * kQueueThreads;
  const unsigned grid = (unsigned)((tiles + per_block - 1) / per_block);
  queue_pop_kernel<<<grid, kQueueThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* queue_pop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tileset_key_launch(const void* o, const void* d, const void* alive,
                                  const void* box, void* key, long long n, int nc,
                                  float t_min, int device, void* stream, void* tally) {
  const int rc = use_device(device);
  if (rc != 0) return rc;
  if (nc < 0 || nc > kMaxBoxes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  tileset_key_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const bool*>(alive), static_cast<const float*>(box),
      static_cast<int*>(key), n, nc, t_min, static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* tileset_key_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int permute_lanes_launch(
    const void* perm, const void* o, const void* d, const void* acc, const void* light,
    const void* tp, const void* prev_pdf, const void* item, const void* schunk,
    const void* bounce, const void* alive, const void* pixel, const void* sample,
    const void* pend_idx, const void* pend_rgb, void* o_out, void* d_out, void* acc_out,
    void* light_out, void* tp_out, void* prev_pdf_out, void* item_out, void* schunk_out,
    void* bounce_out, void* alive_out, void* pixel_out, void* sample_out,
    void* pend_idx_out, void* pend_rgb_out, long long n, int ka, int device, void* stream,
    void* tally) {
  const int rc = use_device(device);
  if (rc != 0) return rc;
  const bool pend = pend_idx != nullptr;
  if (ka < 1 || pend != (pend_rgb != nullptr) || pend != (pend_idx_out != nullptr) ||
      pend != (pend_rgb_out != nullptr))
    return (int)cudaErrorInvalidValue;
  const LaneFields in{
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(acc), static_cast<const float*>(light),
      static_cast<const float*>(tp), static_cast<const float*>(prev_pdf),
      static_cast<const long long*>(item), static_cast<const long long*>(schunk),
      static_cast<const long long*>(bounce), static_cast<const bool*>(alive),
      static_cast<const long long*>(pixel), static_cast<const long long*>(sample),
      static_cast<const long long*>(pend_idx), static_cast<const float*>(pend_rgb)};
  const LaneOutputs out{
      static_cast<float*>(o_out), static_cast<float*>(d_out),
      static_cast<float*>(acc_out), static_cast<float*>(light_out),
      static_cast<float*>(tp_out), static_cast<float*>(prev_pdf_out),
      static_cast<long long*>(item_out), static_cast<long long*>(schunk_out),
      static_cast<long long*>(bounce_out), static_cast<bool*>(alive_out),
      static_cast<long long*>(pixel_out), static_cast<long long*>(sample_out),
      static_cast<long long*>(pend_idx_out), static_cast<float*>(pend_rgb_out)};
  if (n <= 0) return (int)cudaSuccess;
  permute_lanes_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(perm), in, out, n, ka,
      static_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* permute_lanes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
