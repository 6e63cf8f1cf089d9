// The FP32 fused multiply-add peak probe for Hopper: long chains of
// dependent FMAs on every element of a float32 array.
//
// Replaces mcpt/runtime.py measure_vpu_peak (:152; kernel body :171-180,
// pallas_call at :184), the denominator of bench.py's utilisation figures.
//
// What it computes (mcpt's kernel body): the (GRID*SUB, 128) array is cut
// into blocks of SUB = 256 rows.  Each block takes a = x[r0, 0]*1e-8 +
// 1.0000001 and b = x[r0, 1]*1e-8 + 1e-9 from its first row r0, and every
// element of the block runs v = v*a + b, UNROLL*loops times.  Each step is
// one __fmaf_rn: the library is built with -fmad=false, so a plain v*a + b
// would compile to an FMUL and an FADD and measure half the FMA rate.  The
// coefficients themselves are a separate multiply and add, as mcpt's f32
// arithmetic rounds them.
//
// Bound: operations.  A call at mcpt's size does 2*131072*128*8192 =
// 274.9 GFLOP (4.10 ms at the H100's 67 TFLOP/s) and moves 64 MiB in and
// 64 MiB out (0.04 ms at 3.35 TB/s).  A thread's chain is dependent, with
// about 4 cycles from one FFMA to the next, so each of an SM's four
// schedulers needs at least four warps in flight (or a thread several
// independent chains) to issue one FFMA a cycle.  Design: 256 threads a
// block, kChains = 4 elements per thread, one FFMA per step and per element;
// blocks of 1024 consecutive elements, so a block never straddles two of
// mcpt's 256-row blocks, and coalesced loads and stores.  Full occupancy
// alone was not enough: on the H100 one chain a thread ran at 50% of the
// peak, two at 66% and four at 98%.  The rate followed the share of FFMAs
// that take an operand from the reuse cache (cuobjdump -sass): 0 of 256 with
// one chain, 258 of 512 with two, 1023 of 1024 with four, whose consecutive
// FFMAs read the same a and b.

#include <cuda_runtime.h>

#include <cstddef>

namespace mcpt {

constexpr int kSub = 256;                   // rows of one of mcpt's blocks
constexpr int kCols = 128;                  // lanes of a row
constexpr int kBlockElems = kSub * kCols;   // 32768 elements
constexpr int kUnroll = 256;                // FMAs per loop iteration
constexpr int kFmaThreads = 256;            // threads per CUDA block
constexpr int kChains = 4;                  // independent chains a thread

__global__ void __launch_bounds__(kFmaThreads)
    fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int loops) {
  const size_t base =
      static_cast<size_t>(blockIdx.x) * (kFmaThreads * kChains);
  const size_t first = base / kBlockElems * kBlockElems;  // the block's row 0
  // Python float constants as PyTorch rounds them (double -> float)
  const float scale = static_cast<float>(1e-8);
  const float a = __fadd_rn(__fmul_rn(__ldg(x + first), scale),
                            static_cast<float>(1.0000001));
  const float b = __fadd_rn(__fmul_rn(__ldg(x + first + 1), scale),
                            static_cast<float>(1e-9));
  const size_t mine = base + threadIdx.x;
  float v[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) v[j] = x[mine + j * kFmaThreads];
#pragma unroll 1
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) v[j] = __fmaf_rn(v[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) out[mine + j * kFmaThreads] = v[j];
}

}  // namespace mcpt

extern "C" {

// One probe over n_blocks of mcpt's 256x128 blocks (x and out: device
// pointers to n_blocks*32768 floats) with 256*loops FMAs per element, on
// `stream`.  Returns the cudaError_t of the launch (0 on success).
int mcpt_fma_chain(const float* x, float* out, int n_blocks, int loops,
                   void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(n_blocks) * mcpt::kBlockElems;
  const unsigned grid =
      static_cast<unsigned>(n / (mcpt::kFmaThreads * mcpt::kChains));
  mcpt::fma_peak_kernel<<<grid, mcpt::kFmaThreads, 0, s>>>(x, out, loops);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
