// Batched CIOS Montgomery multiplication for BN254 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bn254_tpu/kernels/montmul.py:
// _montmul_kernel (launched through montmul_batched from
// bn254_tpu/fields/limbs.py:mont_mul). Same numbers, limb for limb:
// REDC(a*b) with R = 2^270 over 18 little-endian limbs of 15 bits,
// per-step lazy lo/hi column accumulation, m_i = (t0 * PINV0) & MASK,
// the one-limb shift, one final carry chain, no conditional subtract.
//
// Contract (asserted on the host by fields/limbs.py:mont_mul): input limbs
// < 2^16 and a.vmax * b.vmax + R * p < 2^538, so every limb product is
// exact in uint32 and every column stays below 2^26.
//
// Design: one thread per batch element. The (18, N) limb-major layout
// makes each limb load coalesced across a warp (limb i of neighbouring
// elements lies at neighbouring addresses). The CIOS itself is
// bn254_tower.cuh's `cios`, the leaf the fused kernels share, inlined here:
// the 18 + 18 + 19 uint32 values live in registers; every loop is fully
// unrolled, so the per-step shift of the accumulator is register renaming.
// p's limbs sit in constant memory and are read at the same index by the
// whole warp (broadcast).
// Tensors are int64 at the interface (torch on the CPU has no uint32
// arithmetic); the arithmetic inside is uint32, as on the TPU.
//
// What bounds it: per element it moves 3 x 18 x 8 bytes and does 2 x 18 x
// 18 limb multiply-adds (plus masks, shifts and adds), so at int64 storage
// the card's memory rate is the nominal bound, not its INT32 rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "bn254_tower.cuh"

namespace {

__global__ void __launch_bounds__(256)
montmul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
               int64_t* __restrict__ out, int64_t n) {
  using bn254::kLimbs;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;

  uint32_t av[kLimbs], bv[kLimbs], r[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    av[i] = static_cast<uint32_t>(a[i * n + e]);
    bv[i] = static_cast<uint32_t>(b[i * n + e]);
  }
  bn254::cios(r, av, bv);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i * n + e] = static_cast<int64_t>(r[i]);
}

}  // namespace

// out = REDC(a * b) for n elements of (18, n) int64 limb arrays on the
// device, launched on `stream`. Returns the cudaError_t of the launch.
extern "C" int bn254_montmul(const int64_t* a, const int64_t* b, int64_t* out,
                             int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  montmul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
