// BN254 field arithmetic for one lane: the device library of the fused
// kernels (fused.cu) and the CIOS leaf of the montmul kernel.
//
// Numbers: little-endian limbs of 15 bits in uint32_t[18], Montgomery radix
// R = 2^270, p's limbs below. The tower (fields/tower.py:
//   Fq2 = Fq[i]/(i^2+1), Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v),
//   xi = 9 + i)
// lives in the level schedules of fused.cu's cooperative kernels
// (kernels/coop_schedule.py), which run it Fp operation by Fp operation.
//
// `cios` is the leaf multiply, the same arithmetic as the Pallas kernel
// bn254_tpu/kernels/montmul.py:_montmul_kernel and kernels/montmul.py's
// plain version: per-step lazy lo/hi column accumulation, one final carry
// chain, no conditional subtraction. Its contract: operand limbs < 2^16 and
// a * b + R * p < 2^538 (fields/limbs.py:mont_mul asserts it on the host).
// `cios_wide` computes the same limbs with 64-bit columns (one IMAD.WIDE a
// multiply-add); glv_dbl_add, expu_sq2, fq12_cyc_sq, fq12_mul_line, fq12_sq,
// g2_dbl_step, g2_add_step and the two pow windows run it, the rest cios.
//
// Reduction schedule of the fused kernels (their own, not the plain
// bodies' lazy one): every Fp they hold is fully carried (limbs < 2^15) and
// below 2p. Then every CIOS operand meets the contract ((2p)^2 + R p <
// 2^538), the REDC of two such values is again below 2p (ab/R + p < 4p^2/R
// + p < 2p), and sums and differences come back below 2p with one
// conditional subtraction of 2p (`fp_fold_2p`). An input El (value < 2^270,
// limbs < 2^26) is carried, then brought into [0, 2p) by one CIOS with R mod
// p, as the plain pins' `vreduce` does; an output is made canonical
// (`fp_canon_limbs`) before it is stored. Values agree with the plain bodies
// modulo p; limbs need not.
//
// Every function is __host__ __device__ under nvcc (BN_FN) and plain C++
// under a host compiler, so tests/test_torch_fused_host.py can build the
// same bodies with g++. With BN254_CHECK_BOUNDS defined (host builds only)
// every CIOS operand limb is checked < 2^16 and every Fp result < 2p with
// limbs < 2^15; a failed check counts in `bn254_bound_faults`.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define BN_FN __host__ __device__
#define BN_INLINE __forceinline__
#else
#define BN_FN
#define BN_INLINE inline
#endif

#if defined(BN254_CHECK_BOUNDS) && !defined(__CUDACC__)
inline int bn254_bound_faults = 0;
#define BN_CHECK(cond)                \
  do {                                \
    if (!(cond)) ++bn254_bound_faults; \
  } while (0)
#else
#define BN_CHECK(cond) ((void)0)
#endif

namespace bn254 {

constexpr int kLimbs = 18;
constexpr int kLimbBits = 15;
constexpr uint32_t kMask = (1u << kLimbBits) - 1u;
constexpr uint32_t kPinv0 = 25481u;  // -p^{-1} mod 2^15

#ifdef __CUDACC__
// p, 2p and R mod p, read at the same index by a whole warp (broadcast)
static __constant__ uint32_t kPDev[kLimbs] = {
    0x7D47, 0x30F9, 0x305B, 0x6104, 0x28D3, 0x0E39, 0x245A, 0x40B5, 0x5D97,
    0x02B0, 0x5A06, 0x022D, 0x1B85, 0x3405, 0x384C, 0x2739, 0x3064, 0x0000};
static __constant__ uint32_t k2PDev[kLimbs] = {
    0x7A8E, 0x61F3, 0x60B6, 0x4208, 0x51A7, 0x1C72, 0x48B4, 0x016A, 0x3B2F,
    0x0561, 0x340C, 0x045B, 0x370A, 0x680A, 0x7098, 0x4E72, 0x60C8, 0x0000};
static __constant__ uint32_t kRModPDev[kLimbs] = {
    0x4CC9, 0x3599, 0x74E9, 0x44D3, 0x49DF, 0x43B9, 0x6F66, 0x7F53, 0x7450,
    0x22C1, 0x0F7C, 0x6C65, 0x49E7, 0x2660, 0x3B5B, 0x71CD, 0x279B, 0x0000};
#endif
static const uint32_t kPHost[kLimbs] = {
    0x7D47, 0x30F9, 0x305B, 0x6104, 0x28D3, 0x0E39, 0x245A, 0x40B5, 0x5D97,
    0x02B0, 0x5A06, 0x022D, 0x1B85, 0x3405, 0x384C, 0x2739, 0x3064, 0x0000};
static const uint32_t k2PHost[kLimbs] = {
    0x7A8E, 0x61F3, 0x60B6, 0x4208, 0x51A7, 0x1C72, 0x48B4, 0x016A, 0x3B2F,
    0x0561, 0x340C, 0x045B, 0x370A, 0x680A, 0x7098, 0x4E72, 0x60C8, 0x0000};
static const uint32_t kRModPHost[kLimbs] = {
    0x4CC9, 0x3599, 0x74E9, 0x44D3, 0x49DF, 0x43B9, 0x6F66, 0x7F53, 0x7450,
    0x22C1, 0x0F7C, 0x6C65, 0x49E7, 0x2660, 0x3B5B, 0x71CD, 0x279B, 0x0000};

BN_FN BN_INLINE uint32_t p_limb(int i) {
#ifdef __CUDA_ARCH__
  return kPDev[i];
#else
  return kPHost[i];
#endif
}

BN_FN BN_INLINE uint32_t p2_limb(int i) {
#ifdef __CUDA_ARCH__
  return k2PDev[i];
#else
  return k2PHost[i];
#endif
}

BN_FN BN_INLINE uint32_t rmodp_limb(int i) {
#ifdef __CUDA_ARCH__
  return kRModPDev[i];
#else
  return kRModPHost[i];
#endif
}

// ---------------------------------------------------------------------------
// The leaf: CIOS REDC(a * b), R = 2^270 (bit-exact with montmul_plain)
// ---------------------------------------------------------------------------

BN_FN BN_INLINE void cios(uint32_t out[kLimbs], const uint32_t av[kLimbs],
                          const uint32_t bv[kLimbs]) {
  uint32_t t[kLimbs + 1];
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
      const uint32_t prod = m * p_limb(j);
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
    out[i] = v & kMask;
    c = v >> kLimbBits;
  }
}

// t + a * b, a 32 x 32 -> 64-bit multiply-add. nvcc makes most of them one
// IMAD.WIDE.U32 and some, where it knows both operands are below 2^15, a
// 32-bit IMAD and a 64-bit add: about 2.2 SASS instructions a multiply-add
// over a whole leaf, against cios's 4.9. Inline PTX mad.wide.u32 was worse
// (ptxas splits more of them): 6,288 against 5,600 instructions in
// el_pow_step_mul's kernel (NVIDIA H100 80GB HBM3, CUDA 12.9).
BN_FN BN_INLINE uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t t) {
  return t + static_cast<uint64_t>(a) * b;
}

// The same REDC with 64-bit columns: each multiply-add is one mad_wide into
// its column, where cios splits every product into its low 15 bits and the
// rest. A column's running sum (at most 36 products below 2^32 and a
// carry) stays below 2^38. The digits of the running sum are the same in
// both representations, so every m digit (from the low 15 bits of column
// 0) and the result are bit-identical to cios's and montmul_plain's. Same
// contract as cios.
BN_FN BN_INLINE void cios_wide(uint32_t out[kLimbs], const uint32_t av[kLimbs],
                               const uint32_t bv[kLimbs]) {
  uint64_t t[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t ai = av[i];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] = mad_wide(ai, bv[j], t[j]);
    const uint32_t m = (static_cast<uint32_t>(t[0]) * kPinv0) & kMask;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] = mad_wide(m, p_limb(j), t[j]);
    const uint64_t carry0 = t[0] >> kLimbBits;  // the low 15 bits are 0 here
#pragma unroll
    for (int j = 0; j < kLimbs - 1; ++j) t[j] = t[j + 1];
    t[kLimbs - 1] = 0u;
    t[0] += carry0;
  }
  uint64_t c = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t v = t[i] + c;
    out[i] = static_cast<uint32_t>(v) & kMask;
    c = v >> kLimbBits;
  }
}

// ---------------------------------------------------------------------------
// Fp: values in [0, 2p), limbs < 2^15
// ---------------------------------------------------------------------------

struct Fp {
  uint32_t l[kLimbs];
};

BN_FN BN_INLINE void fp_check(const Fp& a) {
#ifdef BN254_CHECK_BOUNDS
  // limbs < 2^15 and a < 2p (compare from the top limb down)
  int lt = 0, decided = 0;
  for (int i = kLimbs - 1; i >= 0; --i) {
    BN_CHECK(a.l[i] <= kMask);
    if (!decided && a.l[i] != p2_limb(i)) {
      lt = a.l[i] < p2_limb(i);
      decided = 1;
    }
  }
  BN_CHECK(lt);
#else
  (void)a;
#endif
}

// s in [0, 4p) with limbs < 2^15 -> s or s - 2p, whichever is below 2p
BN_FN BN_INLINE void fp_fold_2p(Fp& r, const uint32_t s[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t v = s[i] + (1u << kLimbBits) - p2_limb(i) - borrow;
    d[i] = v & kMask;
    borrow = 1u - (v >> kLimbBits);
  }
  const uint32_t keep = 0u - borrow;  // all ones where s < 2p
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.l[i] = (s[i] & keep) | (d[i] & ~keep);
  fp_check(r);
}

BN_FN BN_INLINE void fp_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.l[i] = 0u;
}

// a in [0, 2p) -> its canonical value in [0, p)
BN_FN BN_INLINE void fp_canon_limbs(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t v = a[i] + (1u << kLimbBits) - p_limb(i) - borrow;
    d[i] = v & kMask;
    borrow = 1u - (v >> kLimbBits);
  }
  const uint32_t keep = 0u - borrow;  // all ones where a < p
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r[i] = (a[i] & keep) | (d[i] & ~keep);
}

// a == 0 mod p, for a in [0, 2p) with carried limbs
BN_FN BN_INLINE bool fp_is_zero(const uint32_t a[kLimbs]) {
  uint32_t c[kLimbs];
  fp_canon_limbs(c, a);
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) any |= c[i];
  return any == 0u;
}

// the window of the fused pow chain (fields/limbs.py:_POW_WINDOW)
constexpr int kPowWindow = 3;

}  // namespace bn254
