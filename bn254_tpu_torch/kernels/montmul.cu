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
// elements lies at neighbouring addresses). The 18 + 18 + 19 uint32 values
// live in registers; every loop is fully unrolled, so the per-step shift
// of the accumulator is register renaming. p's limbs sit in constant
// memory and are read at the same index by the whole warp (broadcast).
// Tensors are int64 at the interface (torch on the CPU has no uint32
// arithmetic); the arithmetic inside is uint32, as on the TPU.
//
// What bounds it: per element it moves 3 x 18 x 8 bytes and does 2 x 18 x
// 18 limb multiply-adds (plus masks, shifts and adds), so at int64 storage
// the card's memory rate is the nominal bound, not its INT32 rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 18;
constexpr int kLimbBits = 15;
constexpr uint32_t kMask = (1u << kLimbBits) - 1u;
// -p^{-1} mod 2^15
constexpr uint32_t kPinv0 = 25481u;

__constant__ uint32_t kP[kLimbs] = {
    0x7D47, 0x30F9, 0x305B, 0x6104, 0x28D3, 0x0E39, 0x245A, 0x40B5, 0x5D97,
    0x02B0, 0x5A06, 0x022D, 0x1B85, 0x3405, 0x384C, 0x2739, 0x3064, 0x0000,
};

__global__ void __launch_bounds__(256)
montmul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
               int64_t* __restrict__ out, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;

  uint32_t av[kLimbs], bv[kLimbs], t[kLimbs + 1];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    av[i] = static_cast<uint32_t>(a[i * n + e]);
    bv[i] = static_cast<uint32_t>(b[i * n + e]);
  }
#pragma unroll
  for (int j = 0; j <= kLimbs; ++j) t[j] = 0u;

#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t ai = av[i];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      const uint32_t prod = ai * bv[j];  // exact: limbs < 2^16
      t[j] += prod & kMask;
      t[j + 1] += prod >> kLimbBits;
    }
    const uint32_t m = (t[0] * kPinv0) & kMask;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      const uint32_t prod = m * kP[j];
      t[j] += prod & kMask;
      t[j + 1] += prod >> kLimbBits;
    }
    const uint32_t carry0 = t[0] >> kLimbBits;  // t[0] & kMask == 0 here
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] = t[j + 1];
    t[kLimbs] = 0u;
    t[0] += carry0;
  }

  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t v = t[i] + c;
    out[i * n + e] = static_cast<int64_t>(v & kMask);
    c = v >> kLimbBits;
  }
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
