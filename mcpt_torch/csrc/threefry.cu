// Threefry-2x32 uniform draws and random bits for Hopper: the wavefront
// engine's random numbers, bit-equal to jax.random's.
//
// Not a TPU kernel: mcpt draws these through XLA (jax.random.uniform in
// mcpt/render/shade.py:188, integrator.py:81 and :324, camera.py:146),
// and the port's plain version (mcpt_torch/rng.py threefry2x32) runs the
// same hash as ~160 int64 tensor ops over the whole draw.  On the H100 those
// ops took ~60% of the wavefront's device time (PERF.md §5), which is the
// measured reason for a hand kernel.
//
// Element i of the flat shape hashes the counter pair (i >> 32, i & 2^32-1)
// under the key (k0, k1) with Threefry-2x32 (20 rounds, rotations
// 13,15,26,6 / 17,29,16,24, parity 0x1BD11BDA, five key injections) and
// takes x0 ^ x1.  `uniform` writes the float32 in [0, 1) built from the top
// 23 bits (the mantissa of a float in [1, 2), minus 1: exact); `bits`
// writes the 32 bits zero-extended into int64, as the plain version holds
// them.  Every word is uint32_t (no signed shift anywhere) and the index is
// 64-bit, so draws past 2^31 elements stay right.
//
// Bound: per output ~75 32-bit integer operations (2 + 20 x 3 for the
// rounds, a rotation being one funnel shift, 10 for the key injections, 1
// xor, 2 for the float's bits) and 4 B written (8 for bits); nothing is
// read.  Integer work issues on the ALU pipe and, as IMAD, on the FMA pipe,
// so the ceiling is the SM's issue rate, 128 lanes a clock (a 64-a-clock
// ALU bound was beaten on the card; PERF.md): ~0.074 ms for a config-8
// bounce's 9 x 3,686,400 draws at 1980 MHz, against 0.040 ms of writes at
// 3.35 TB/s, so operations bound it.  The design: one pass, nothing but
// the output reaches memory; each thread hashes 4 consecutive elements (4
// independent chains hide the ALU latency) and stores them as one 16-byte
// vector; a grid-stride loop covers any count.

#include <cuda_runtime.h>

#include <cstdint>

namespace mcpt {

constexpr int kThreefryBlock = 256;  // threads per block
constexpr int kThreefryPerThread = 4;  // consecutive elements per thread
constexpr unsigned kThreefryMaxBlocks = 1u << 20;  // then grid-stride

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;  // rotate left by r
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 13);
  mix(x0, x1, 15);
  mix(x0, x1, 26);
  mix(x0, x1, 6);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 17);
  mix(x0, x1, 29);
  mix(x0, x1, 16);
  mix(x0, x1, 24);
}

// x0 ^ x1 of Threefry-2x32 of the counter pair of element i under (k0, k1);
// k2 = k0 ^ k1 ^ 0x1BD11BDA
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  rounds_a(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds_b(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds_a(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds_b(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds_a(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float to_uniform(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// kUniform: out is float32 (uniform draws); else int64 (the bits)
template <bool kUniform>
__global__ void __launch_bounds__(kThreefryBlock)
    threefry_kernel(uint32_t k0, uint32_t k1, uint64_t n, void* out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x *
                          kThreefryPerThread;
  for (uint64_t base = (static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) * kThreefryPerThread;
       base < n; base += stride) {
    uint32_t b[kThreefryPerThread];
#pragma unroll
    for (int q = 0; q < kThreefryPerThread; ++q)
      b[q] = threefry_bits(k0, k1, k2, base + q);
    const bool whole = base + kThreefryPerThread <= n;
    if (kUniform) {
      float* o = static_cast<float*>(out);
      if (whole) {
        *reinterpret_cast<float4*>(o + base) =
            make_float4(to_uniform(b[0]), to_uniform(b[1]), to_uniform(b[2]),
                        to_uniform(b[3]));
      } else {
        for (int q = 0; base + q < n; ++q) o[base + q] = to_uniform(b[q]);
      }
    } else {
      long long* o = static_cast<long long*>(out);
      if (whole) {
        longlong2* o2 = reinterpret_cast<longlong2*>(o + base);
        o2[0] = make_longlong2(b[0], b[1]);
        o2[1] = make_longlong2(b[2], b[3]);
      } else {
        for (int q = 0; base + q < n; ++q) o[base + q] = b[q];
      }
    }
  }
}

}  // namespace mcpt

extern "C" {

// n elements of threefry draws under key (k0, k1) into `out` on `stream`:
// float32 uniforms (uniform 1) or int64 bits (uniform 0).  `out` is a device
// pointer, 16-byte aligned, of n elements.  Returns the cudaError_t of the
// launch (0 on success; nothing is launched for n = 0).
int mcpt_threefry(unsigned k0, unsigned k1, unsigned long long n,
                  int uniform, void* out, void* stream) {
  if (n == 0) return 0;
  const unsigned long long per_block =
      static_cast<unsigned long long>(mcpt::kThreefryBlock) *
      mcpt::kThreefryPerThread;
  const unsigned long long need = (n + per_block - 1) / per_block;
  const unsigned blocks = need < mcpt::kThreefryMaxBlocks
                              ? static_cast<unsigned>(need)
                              : mcpt::kThreefryMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform)
    mcpt::threefry_kernel<true><<<blocks, mcpt::kThreefryBlock, 0, s>>>(
        k0, k1, n, out);
  else
    mcpt::threefry_kernel<false><<<blocks, mcpt::kThreefryBlock, 0, s>>>(
        k0, k1, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
