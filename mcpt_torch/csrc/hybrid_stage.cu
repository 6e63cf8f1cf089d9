// The hybrid engine's stages around its bounces for Hopper: the step's first
// pool of camera rays, and between two bounces the Bernoulli roulette to a
// live cap, the coherence sort's keys, and the reorder of the pool by the
// sorted keys (the kept prefix and the dropped tail).
//
// Not a TPU kernel: mcpt runs these stages through XLA (_render_hybrid_jit
// in mcpt/pallas/cluster_megakernel.py: _hybrid_sort_key, lax.sort, the
// roulette and the prefix slice, fused by the compiler around the
// pallas_call of the fused bounce).  The port's plain versions
// (mcpt_torch/kernels/cluster_megakernel.py _roulette, _hybrid_sort_key,
// _reorder_reference) run them as ~100 eager tensor ops a re-sorted bounce,
// each a launch of a few microseconds that the host takes longer to issue
// than the card to run, with three pageable host-to-device copies (and their
// stream synchronisations) in every roulette: on the H100 the card idled
// ~15 ms of a ~38-ms dining-room step in these two stages (PERF.md §5).
// The raygen's plain version (camera_pool_reference; _xla_camera_rays in
// mcpt) reads the camera table back to the host, uploads scalars and hashes
// the RNG streams in int64 tensors: ~180 ops and 4-5 ms of an idle card at
// the start of every step.
//
// Each kernel computes its plain version's arithmetic bit for bit: the same
// float32 operations in the same order (built with -fmad=false, as every
// source here), the murmur3 hash of bounce_core.cuh on uint32_t, and int32
// keys composed as the plain int64 ones are.  No host value is read: the
// live count stays on the card between the count and the roulette, and the
// tail's NaN canary is written into the segment count on the card.
//
// Bound at config 8's full pool (N = 3,686,400 lanes, 3.35 TB/s): the
// raygen writes the 16 planes and the ids (251 MB, 0.075 ms) and reads the
// 7.4-MB pixel order once a sample; the keys
// read 7 planes (103 MB) and write 15 MB; the reorder reads at least the 16
// planes and the ids of every lane (251 MB) and writes as much; the roulette
// reads the alive plane twice, the ids and the throughput (74 MB) and
// writes 59 MB.  With torch.sort's passes over the keys and indices in
// between, a full re-sort moves ~0.97 GB (~0.29 ms) and a roulette ~0.04
// ms.  The design: one thread a lane and one pass a kernel, every plane
// read and written coalesced, except the reorder's reads, which follow the
// sorted order; nothing but the outputs reaches memory.  A 4-byte read at
// a random lane costs a 32-byte sector, so the reorder gathers two planes
// at a time (a slice of its grid; the card runs the blocks of one slice
// before the next, in order): the 29 MB it reads at random then stays in
// the 50 MB L2.  In one A/B at the full pool (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6), gathering all 16 planes a thread (236 MB at random)
// took 1.20 ms, one plane a slice 0.58 ms, two 0.57 ms (0.45 ms against
// 0.50 when half the pool is dropped) and torch's index_select with the id
// gather 0.61 ms: the slices are bound by L2 sectors, not by device memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"

namespace mcpt {

constexpr int kStageBlock = 256;  // threads per block
constexpr int kPlanes = 16;       // state planes (cluster_megakernel.PLANES)
constexpr int kThroughput = 6;    // tr, tg, tb
constexpr int kRadiance = 9;      // rr, rg, rb
constexpr int kAlive = 12;
constexpr unsigned kCountMaxBlocks = 1024;  // then grid-stride
constexpr int kDeadKey = 0x7FFFFFFF;
// the reorder gathers kSlicePlanes planes a slice of its grid, kSlices
// slices of planes and one of ids
constexpr int kSlicePlanes = 2;
constexpr int kSlices = kPlanes / kSlicePlanes;

inline unsigned stage_blocks(long long n) {
  return static_cast<unsigned>((n + kStageBlock - 1) / kStageBlock);
}

// torch.clamp on float: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// camera_pool_reference: lane i < n_rays is sample i / n_px of pixel
// perm[i % n_px], RNG stream (sample_base + sample)·W·H + pixel mod 2^32 (its
// id), cam_ray's ray with throughput 1 and alive 1; a pad lane has direction
// (1, 0, 0) and id (sample_base + spp)·W·H + (i - n_rays) mod 2^32; every
// other plane is 0.  cam: 0:3 position, 3:6 forward, 6:9 right, 9:12 up, 12
// half_w, 13 half_h, 14 is_ortho (the sf slots cam_ray reads).  Each thread
// writes its lane of all 16 planes and its id, so every store is coalesced.
// At config 8's pool it took 0.107 ms, 70% of its bound; two or four lanes
// a thread with vector stores took 0.100 / 0.101 ms (PERF.md §6).
__global__ void __launch_bounds__(kStageBlock)
    raygen_kernel(const float* __restrict__ cam,
                  const long long* __restrict__ perm, int n_px, int n_rays,
                  int n_pool, int width, int height, uint32_t seed,
                  long long sample_base, int spp, float* __restrict__ state,
                  int* __restrict__ rid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pool) return;
  // the ids mod 2^32, in uint32_t arithmetic
  const uint32_t total = static_cast<uint32_t>(width) * height;
  const uint32_t base = static_cast<uint32_t>(sample_base);
  float v[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) v[p] = 0.0f;
  uint32_t id;
  if (i < n_rays) {
    const int s = i / n_px;
    const int px = static_cast<int>(perm[i - s * n_px]);
    id = (base + s) * total + px;
    float sf[18];
#pragma unroll
    for (int j = 0; j < 14; ++j) sf[j] = cam[j];
    sf[17] = cam[14];
    Params prm{};
    prm.width = width;
    prm.height = height;
    prm.seed = seed;
    PathState ray;
    cam_ray(sf, prm, static_cast<float>(px % width),
            static_cast<float>(px / width), id, ray);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[j] = ray.o[j];
      v[3 + j] = ray.d[j];
      v[kThroughput + j] = 1.0f;
    }
    v[kAlive] = 1.0f;
  } else {
    id = (base + spp) * total + (i - n_rays);
    v[3] = 1.0f;
  }
  const size_t ns = static_cast<size_t>(n_pool);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) state[p * ns + i] = v[p];
  rid[i] = static_cast<int>(id);
}

// *count += the lanes with alive > 0 (the caller zeroes it)
__global__ void __launch_bounds__(kStageBlock)
    live_count_kernel(const float* __restrict__ alive, int n,
                      int* __restrict__ count) {
  __shared__ int warp_sums[kStageBlock / 32];
  int c = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    c += alive[i] > 0.0f;
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < kStageBlock / 32 ? warp_sums[threadIdx.x] : 0;
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if (threadIdx.x == 0 && c != 0) atomicAdd(count, c);
  }
}

// _roulette: p = min(1, cap / max(live, 1)); alive &= u < p; tr *= 1/p on
// every lane, dead ones included
__global__ void __launch_bounds__(kStageBlock)
    roulette_kernel(float* __restrict__ state, const int* __restrict__ rid,
                    int n, float cap, uint32_t seed, uint32_t salt,
                    const int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the plain version's float32 sum of 0/1 values: exact below 2^24
  const float live = static_cast<float>(*count);
  const float p = fminf(1.0f, cap / fmaxf(live, 1.0f));
  const float inv = 1.0f / p;
  const size_t ns = static_cast<size_t>(n);
  float* a = state + kAlive * ns + i;
  const float u = u01(seed, salt, static_cast<uint32_t>(rid[i]));
  *a = (*a > 0.0f && u < p) ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) state[(kThroughput + c) * ns + i] *= inv;
}

// lbvh.expand_bits_10: the low 10 bits of v to every 3rd bit
__device__ __forceinline__ uint32_t expand_bits_10(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// one axis of lbvh.morton30's input: the origin in the scene box, in [0, 1)
__device__ __forceinline__ uint32_t morton_axis(float o, float lo,
                                                float inv_ext) {
  const float u = clamp_nan((o - lo) * inv_ext, 0.0f, MCPT_F(0.999999));
  const float q = clamp_nan(u * 1024.0f, 0.0f, 1023.0f);
  return expand_bits_10(static_cast<uint32_t>(static_cast<long long>(q)));
}

// _hybrid_sort_key's direction cell: clamp(int((c + 1) * scale), 0, top)
__device__ __forceinline__ uint32_t dir_cell(float c, float scale, int top) {
  const long long v = static_cast<long long>((c + 1.0f) * scale);
  return static_cast<uint32_t>(v < 0 ? 0 : (v > top ? top : v));
}

// _hybrid_sort_key, mode 0 cell, 1 dir, 2 dir6, 3 dir9
__global__ void __launch_bounds__(kStageBlock)
    sort_key_kernel(const float* __restrict__ ox,
                    const float* __restrict__ oy,
                    const float* __restrict__ oz,
                    const float* __restrict__ dx,
                    const float* __restrict__ dy,
                    const float* __restrict__ dz,
                    const float* __restrict__ alive, int n, float lo0,
                    float lo1, float lo2, float inv0, float inv1, float inv2,
                    int mode, int coarse_bits, int* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!(alive[i] > 0.5f)) {
    key[i] = kDeadKey;
    return;
  }
  const uint32_t m = (morton_axis(ox[i], lo0, inv0) << 2) |
                     (morton_axis(oy[i], lo1, inv1) << 1) |
                     morton_axis(oz[i], lo2, inv2);
  const float x = dx[i], y = dy[i], z = dz[i];
  const uint32_t octant = (x > 0.0f) + 2u * (y > 0.0f) + 4u * (z > 0.0f);
  const int fine_bits = min(30 - coarse_bits, 12);
  const uint32_t coarse = m >> (30 - coarse_bits);
  const uint32_t fine =
      (m >> (30 - coarse_bits - fine_bits)) & ((1u << fine_bits) - 1u);
  uint32_t k;
  if (mode == 0) {
    k = (coarse << (3 + fine_bits)) | (octant << fine_bits) | fine;
  } else if (mode == 1) {
    k = (octant << (coarse_bits + fine_bits)) | (coarse << fine_bits) | fine;
  } else if (mode == 2) {
    const uint32_t d6 = (dir_cell(x, 2.0f, 3) << 4) |
                        (dir_cell(y, 2.0f, 3) << 2) | dir_cell(z, 2.0f, 3);
    k = (d6 << (coarse_bits + fine_bits)) | (coarse << fine_bits) | fine;
  } else {
    const uint32_t d9 = (dir_cell(x, 4.0f, 7) << 6) |
                        (dir_cell(y, 4.0f, 7) << 3) | dir_cell(z, 4.0f, 7);
    const int fb9 = min(fine_bits, 30 - 9 - coarse_bits);
    k = (d9 << (coarse_bits + fb9)) | (coarse << fb9) |
        (fine >> (fine_bits - fb9));
  }
  key[i] = static_cast<int>(k);
}

// Slice y of lane i of the sorted order: planes kSlicePlanes·y onward of
// the (16, n) state, or (y == kSlices) the ids.  i < keep goes to the kept
// pool at i, the rest to the tail at i - keep: its ids and radiance, and a
// live lane there sets the segment count to NaN.
__global__ void __launch_bounds__(kStageBlock)
    reorder_kernel(const float* __restrict__ state,
                   const int* __restrict__ rid,
                   const long long* __restrict__ order, int n, int keep,
                   float* __restrict__ out_state, int* __restrict__ out_rid,
                   int* __restrict__ tail_rid, float* __restrict__ tail_rad,
                   double* __restrict__ segs_total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int p0 = y * kSlicePlanes;
  if (i >= n) return;
  const bool kept = i < keep;
  // a tail lane keeps its id, its radiance and its alive flag only
  if (!kept && y < kSlices &&
      (p0 + kSlicePlanes <= kRadiance || p0 > kAlive))
    return;
  const size_t ns = static_cast<size_t>(n);
  const size_t src = static_cast<size_t>(order[i]);
  if (y == kSlices) {
    const int r = rid[src];
    if (kept) out_rid[i] = r;
    else tail_rid[i - keep] = r;
    return;
  }
#pragma unroll
  for (int p = p0; p < p0 + kSlicePlanes; ++p) {
    const float v = state[p * ns + src];
    if (kept) {
      out_state[p * static_cast<size_t>(keep) + i] = v;
    } else if (p >= kRadiance && p < kRadiance + 3) {
      tail_rad[(p - kRadiance) * static_cast<size_t>(n - keep) + (i - keep)] =
          v;
    } else if (p == kAlive && v > 0.0f) {
      *segs_total = __longlong_as_double(0x7FF8000000000000LL);
    }
  }
}

}  // namespace mcpt

extern "C" {

// The hybrid's first pool on `stream`: the (16, n_pool) state and the
// (n_pool,) ids of spp samples of the n_px pixels `perm` (int64 pixel ids)
// from the camera `cam` (15 floats on the card, raygen_kernel's layout), the
// seed and the sample base by value.  Returns the cudaError_t of the launch
// (0 on success; nothing is launched for n_pool = 0).
int mcpt_hybrid_raygen(const float* cam, const long long* perm, int n_px,
                       int n_rays, int n_pool, int width, int height,
                       unsigned seed, long long sample_base, int spp,
                       float* state, int* rid, void* stream) {
  if (n_pool <= 0) return 0;
  mcpt::raygen_kernel<<<mcpt::stage_blocks(n_pool), mcpt::kStageBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      cam, perm, n_px, n_rays, n_pool, width, height, seed, sample_base, spp,
      state, rid);
  return static_cast<int>(cudaGetLastError());
}

// The roulette over the (16, n) state on `stream`: count the live lanes
// into `count` (one device int of scratch), then select and rescale, with
// the cap, the seed and the salt by value.  Returns the cudaError_t of the
// launches (0 on success; nothing is launched for n = 0).
int mcpt_hybrid_roulette(float* state, const int* rid, int n, float cap,
                         unsigned seed, unsigned salt, int* count,
                         void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = mcpt::stage_blocks(n);
  const unsigned count_blocks =
      blocks < mcpt::kCountMaxBlocks ? blocks : mcpt::kCountMaxBlocks;
  mcpt::live_count_kernel<<<count_blocks, mcpt::kStageBlock, 0, s>>>(
      state + mcpt::kAlive * static_cast<size_t>(n), n, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mcpt::roulette_kernel<<<blocks, mcpt::kStageBlock, 0, s>>>(
      state, rid, n, cap, seed, salt, count);
  return static_cast<int>(cudaGetLastError());
}

// The int32 sort keys of n lanes on `stream` from the origin, direction and
// alive planes (device pointers), the scene box's low corner and inverse
// extent, the key mode (0 cell, 1 dir, 2 dir6, 3 dir9) and the coarse
// cell's Morton bits.  Returns the cudaError_t of the launch.
int mcpt_hybrid_sort_key(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* alive, int n, float lo0, float lo1,
                         float lo2, float inv0, float inv1, float inv2,
                         int mode, int coarse_bits, int* key, void* stream) {
  if (n <= 0) return 0;
  mcpt::sort_key_kernel<<<mcpt::stage_blocks(n), mcpt::kStageBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, alive, n, lo0, lo1, lo2, inv0, inv1, inv2,
      mode, coarse_bits, key);
  return static_cast<int>(cudaGetLastError());
}

// The (16, n) state and its ids in `order` (a permutation of 0..n-1, int64)
// on `stream`: the first `keep` lanes into out_state (16 x keep) and
// out_rid, the other n - keep lanes' ids and radiance into tail_rid and
// tail_rad (3 x (n - keep)), and NaN into *segs_total if one of those is
// alive.  Returns the cudaError_t of the launch.
int mcpt_hybrid_reorder(const float* state, const int* rid,
                        const long long* order, int n, int keep,
                        float* out_state, int* out_rid, int* tail_rid,
                        float* tail_rad, double* segs_total, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(mcpt::stage_blocks(n), mcpt::kSlices + 1);
  mcpt::reorder_kernel<<<grid, mcpt::kStageBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      state, rid, order, n, keep, out_state, out_rid, tail_rid, tail_rad,
      segs_total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
