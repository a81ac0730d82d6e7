// Fused BN254 kernels for Hopper (sm_90a): tower ops, Miller-loop digits and
// step ops, exp_u steps, pow windows and GLV ladder steps.
//
// Each kernel runs one whole straight-line body for every lane, replacing
// one Pallas kernel of bn254_tpu/kernels/fused.py:fused_op:
//
//   key              TPU body                       in -> out (18-limb Els)
//   miller_dbl_body  pairing/miller.py:257            20 -> 18
//   miller_add_body  pairing/miller.py:265            24 -> 18
//   miller_dbl_body2 pairing/miller.py:334            28 -> 18
//   miller_add_body2 pairing/miller.py:352            32 -> 18
//   expu_step        pairing/final_exp.py:45          24 -> 12
//   expu_sq2         pairing/final_exp.py:53          12 -> 12
//   fq12_mul         fields/tower.py:374              24 -> 12
//   fq12_sq          fields/tower.py:384              12 -> 12
//   fq12_cyc_sq      fields/tower.py:399              12 -> 12
//   el_pow_step_mul  fields/limbs.py:783               2 -> 1
//   el_pow_step_sq   fields/limbs.py:790               1 -> 1
//   glv_dbl_add      curve/glv.py:213                  6 -> 3
//   fq12_mul_line    pairing/miller.py:90             18 -> 12
//   g2_dbl_step      pairing/miller.py:125             8 -> 12
//   g2_add_step      pairing/miller.py:167            12 -> 12
//
// Interface (kernels/fused.py): one contiguous (n_in, 18, n) int64 input, one
// (n_out, 18, n) int64 output, Els in the plain body's tree order (an Fq12
// as c0.c0.c0, c0.c0.c1, ..., c1.c2.c1; a ProjG2 or a G1 point as x, y, z).
// Every input El must have a value below 2^270 and limbs below 2^26; every
// output El is canonical (below p, limbs below 2^15), inside any bound the
// plain body declares. The arithmetic is bn254_tower.cuh's: the plain
// bodies' formulas with their own reduction schedule, so the kernel agrees
// with the plain version BY CANONICAL VALUE plus the bound check, not limb
// for limb (chip_smoke.py and tests/test_torch_fused_host.py compare so).
//
// Design: one thread per lane, 64-thread blocks (8,193 Miller lanes fill
// 129 blocks, about one per SM, for the digit bodies and for the scan form's
// step ops alike; the two-pair bodies of the independent tier at 4,096
// tuples fill 64, half the SMs). The step ops (g2_dbl_step, g2_add_step,
// fq12_mul_line) are the same device functions the digit bodies chain, one
// launch each, so the scan form pays a launch and an HBM round trip of f, T
// and the line per step. The Fq12 accumulator and the temporaries
// live in local memory; the Fq2-level functions and the leaf are not
// inlined, which keeps the nvcc build in seconds. The limb layout makes
// each lane's limb loads coalesced across a warp.
//
// What bounds it: per lane a body does 3-172 leaf multiplies of 648 32-bit
// multiply-adds each and moves (n_in + n_out) x 18 x 8 bytes, so the INT32
// rate is the nominal bound; at one thread per lane and one lane for the
// shared final exponentiation, latency of the dependent leaf chain is what
// the one-lane kernels actually pay.
//
// Under a host compiler (no __CUDACC__) the file instead exports
// bn254_host_<key>(in, out, n), the same lane bodies in a plain loop, which
// tests/test_torch_fused_host.py builds with g++ and holds against the
// plain torch bodies.

#include "bn254_tower.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace bn254 {

// Els first .. first+count-1 of lane e (value < 2^270, limbs < 2^26),
// carried and brought into [0, 2p)
BN_FN BN_INLINE void load_els(Fp* dst, int count, int first,
                              const int64_t* in, int64_t n, int64_t e) {
  for (int k = 0; k < count; ++k) {
    Fp raw;
    uint32_t c = 0u;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const uint32_t v =
          static_cast<uint32_t>(in[((first + k) * kLimbs + i) * n + e]) + c;
      raw.l[i] = v & kMask;
      c = v >> kLimbBits;
    }
    BN_CHECK(c == 0u);  // value < 2^270
    fp_load(dst[k], raw);
  }
}

// canonical outputs: below p, limbs below 2^15
BN_FN BN_INLINE void store_els(int64_t* out, int first, const Fp* src,
                               int count, int64_t n, int64_t e) {
  for (int k = 0; k < count; ++k) {
    Fp c;
    fp_canon(c, src[k]);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      out[((first + k) * kLimbs + i) * n + e] = c.l[i];
  }
}

template <typename T>
BN_FN BN_INLINE Fp* els(T& x) {
  return reinterpret_cast<Fp*>(&x);
}

template <typename T>
BN_FN BN_INLINE const Fp* els(const T& x) {
  return reinterpret_cast<const Fp*>(&x);
}

// inputs (f, t, xp, yp) -> outputs (f, t)
BN_FN BN_INLINE void lane_miller_dbl_body(const int64_t* in, int64_t* out,
                                          int64_t n, int64_t e) {
  Fq12 f, fo;
  ProjG2 t, to;
  Fp xp, yp;
  load_els(els(f), 12, 0, in, n, e);
  load_els(els(t), 6, 12, in, n, e);
  load_els(&xp, 1, 18, in, n, e);
  load_els(&yp, 1, 19, in, n, e);
  miller_dbl_body(fo, to, f, t, xp, yp);
  store_els(out, 0, els(fo), 12, n, e);
  store_els(out, 12, els(to), 6, n, e);
}

// inputs (f, t, qx, qy, xp, yp) -> outputs (f, t)
BN_FN BN_INLINE void lane_miller_add_body(const int64_t* in, int64_t* out,
                                          int64_t n, int64_t e) {
  Fq12 f, fo;
  ProjG2 t, to;
  Fq2 qx, qy;
  Fp xp, yp;
  load_els(els(f), 12, 0, in, n, e);
  load_els(els(t), 6, 12, in, n, e);
  load_els(els(qx), 2, 18, in, n, e);
  load_els(els(qy), 2, 20, in, n, e);
  load_els(&xp, 1, 22, in, n, e);
  load_els(&yp, 1, 23, in, n, e);
  miller_add_body(fo, to, f, t, qx, qy, xp, yp);
  store_els(out, 0, els(fo), 12, n, e);
  store_els(out, 12, els(to), 6, n, e);
}

// inputs (f, t, xp0, yp0, ca, cb, cc, xp1, yp1) -> outputs (f, t); the
// constant triple is one (18,) El each, broadcast over the lanes by the
// wrapper's packing like any other operand
BN_FN BN_INLINE void lane_miller_dbl_body2(const int64_t* in, int64_t* out,
                                           int64_t n, int64_t e) {
  Fq12 f, fo;
  ProjG2 t, to;
  Fq2 ca, cb, cc;
  Fp xp0, yp0, xp1, yp1;
  load_els(els(f), 12, 0, in, n, e);
  load_els(els(t), 6, 12, in, n, e);
  load_els(&xp0, 1, 18, in, n, e);
  load_els(&yp0, 1, 19, in, n, e);
  load_els(els(ca), 2, 20, in, n, e);
  load_els(els(cb), 2, 22, in, n, e);
  load_els(els(cc), 2, 24, in, n, e);
  load_els(&xp1, 1, 26, in, n, e);
  load_els(&yp1, 1, 27, in, n, e);
  miller_dbl_body2(fo, to, f, t, xp0, yp0, ca, cb, cc, xp1, yp1);
  store_els(out, 0, els(fo), 12, n, e);
  store_els(out, 12, els(to), 6, n, e);
}

// inputs (f, t, qx, qy, xp0, yp0, ca, cb, cc, xp1, yp1) -> outputs (f, t)
BN_FN BN_INLINE void lane_miller_add_body2(const int64_t* in, int64_t* out,
                                           int64_t n, int64_t e) {
  Fq12 f, fo;
  ProjG2 t, to;
  Fq2 qx, qy, ca, cb, cc;
  Fp xp0, yp0, xp1, yp1;
  load_els(els(f), 12, 0, in, n, e);
  load_els(els(t), 6, 12, in, n, e);
  load_els(els(qx), 2, 18, in, n, e);
  load_els(els(qy), 2, 20, in, n, e);
  load_els(&xp0, 1, 22, in, n, e);
  load_els(&yp0, 1, 23, in, n, e);
  load_els(els(ca), 2, 24, in, n, e);
  load_els(els(cb), 2, 26, in, n, e);
  load_els(els(cc), 2, 28, in, n, e);
  load_els(&xp1, 1, 30, in, n, e);
  load_els(&yp1, 1, 31, in, n, e);
  miller_add_body2(fo, to, f, t, qx, qy, xp0, yp0, ca, cb, cc, xp1, yp1);
  store_els(out, 0, els(fo), 12, n, e);
  store_els(out, 12, els(to), 6, n, e);
}

// inputs (acc, m) -> acc^4 * m
BN_FN BN_INLINE void lane_expu_step(const int64_t* in, int64_t* out,
                                    int64_t n, int64_t e) {
  Fq12 acc, m, o;
  load_els(els(acc), 12, 0, in, n, e);
  load_els(els(m), 12, 12, in, n, e);
  expu_step(o, acc, m);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (acc) -> acc^4
BN_FN BN_INLINE void lane_expu_sq2(const int64_t* in, int64_t* out,
                                   int64_t n, int64_t e) {
  Fq12 acc, o;
  load_els(els(acc), 12, 0, in, n, e);
  expu_sq2(o, acc);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (a, b) -> a * b
BN_FN BN_INLINE void lane_fq12_mul(const int64_t* in, int64_t* out,
                                   int64_t n, int64_t e) {
  Fq12 a, b, o;
  load_els(els(a), 12, 0, in, n, e);
  load_els(els(b), 12, 12, in, n, e);
  fq12_mul(o, a, b);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (a) -> a^2
BN_FN BN_INLINE void lane_fq12_sq(const int64_t* in, int64_t* out,
                                  int64_t n, int64_t e) {
  Fq12 a, o;
  load_els(els(a), 12, 0, in, n, e);
  fq12_sq(o, a);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (a) -> a^2 by the cyclotomic formula
BN_FN BN_INLINE void lane_fq12_cyc_sq(const int64_t* in, int64_t* out,
                                      int64_t n, int64_t e) {
  Fq12 a, o;
  load_els(els(a), 12, 0, in, n, e);
  fq12_cyc_sq(o, a);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (acc, m) -> acc^8 * m
BN_FN BN_INLINE void lane_el_pow_step_mul(const int64_t* in, int64_t* out,
                                          int64_t n, int64_t e) {
  Fp acc[2], o;
  load_els(acc, 2, 0, in, n, e);
  el_pow_step_mul(o, acc[0], acc[1]);
  store_els(out, 0, &o, 1, n, e);
}

// inputs (acc) -> acc^8
BN_FN BN_INLINE void lane_el_pow_step_sq(const int64_t* in, int64_t* out,
                                         int64_t n, int64_t e) {
  Fp acc, o;
  load_els(&acc, 1, 0, in, n, e);
  el_pow_step_sq(o, acc);
  store_els(out, 0, &o, 1, n, e);
}

// inputs (acc.x, acc.y, acc.z, sel.x, sel.y, sel.z) -> 2 acc + sel
BN_FN BN_INLINE void lane_glv_dbl_add(const int64_t* in, int64_t* out,
                                      int64_t n, int64_t e) {
  G1 acc, sel, o;
  load_els(els(acc), 3, 0, in, n, e);
  load_els(els(sel), 3, 3, in, n, e);
  glv_dbl_add(o, acc, sel);
  store_els(out, 0, els(o), 3, n, e);
}

// inputs (f, a, b, c) -> f * (a + b w + c v w)
BN_FN BN_INLINE void lane_fq12_mul_line(const int64_t* in, int64_t* out,
                                        int64_t n, int64_t e) {
  Fq12 f, o;
  Fq2 a, b, c;
  load_els(els(f), 12, 0, in, n, e);
  load_els(els(a), 2, 12, in, n, e);
  load_els(els(b), 2, 14, in, n, e);
  load_els(els(c), 2, 16, in, n, e);
  fq12_mul_line(o, f, a, b, c);
  store_els(out, 0, els(o), 12, n, e);
}

// inputs (t, xp, yp) -> (2t, its tangent line (a, b, c))
BN_FN BN_INLINE void lane_g2_dbl_step(const int64_t* in, int64_t* out,
                                      int64_t n, int64_t e) {
  ProjG2 t, to;
  Line ln;
  Fp xp, yp;
  load_els(els(t), 6, 0, in, n, e);
  load_els(&xp, 1, 6, in, n, e);
  load_els(&yp, 1, 7, in, n, e);
  dbl_step(to, ln, t, xp, yp);
  store_els(out, 0, els(to), 6, n, e);
  store_els(out, 6, els(ln), 6, n, e);
}

// inputs (t, qx, qy, xp, yp) -> (t + q, its chord line (a, b, c))
BN_FN BN_INLINE void lane_g2_add_step(const int64_t* in, int64_t* out,
                                      int64_t n, int64_t e) {
  ProjG2 t, to;
  Line ln;
  Fq2 qx, qy;
  Fp xp, yp;
  load_els(els(t), 6, 0, in, n, e);
  load_els(els(qx), 2, 6, in, n, e);
  load_els(els(qy), 2, 8, in, n, e);
  load_els(&xp, 1, 10, in, n, e);
  load_els(&yp, 1, 11, in, n, e);
  add_step(to, ln, t, qx, qy, xp, yp);
  store_els(out, 0, els(to), 6, n, e);
  store_els(out, 6, els(ln), 6, n, e);
}

}  // namespace bn254

#ifdef __CUDACC__

namespace {
constexpr int kThreads = 64;
}

// bn254_<key>(in, out, n, stream): launch on `stream`, return cudaGetLastError
#define BN254_FUSED_KERNEL(key)                                               \
  __global__ void __launch_bounds__(kThreads)                                 \
      key##_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, \
                   int64_t n) {                                               \
    const int64_t e =                                                         \
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;          \
    if (e < n) bn254::lane_##key(in, out, n, e);                              \
  }                                                                           \
  extern "C" int bn254_##key(const int64_t* in, int64_t* out, int64_t n,      \
                             void* stream) {                                  \
    if (n <= 0) return 0;                                                     \
    const int64_t blocks = (n + kThreads - 1) / kThreads;                     \
    key##_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,                \
                   static_cast<cudaStream_t>(stream)>>>(in, out, n);          \
    return static_cast<int>(cudaGetLastError());                              \
  }

#else

// bn254_host_<key>(in, out, n): the lane bodies in a loop on the host;
// returns the number of failed bound checks (0 without BN254_CHECK_BOUNDS)
#ifndef BN254_CHECK_BOUNDS
static int bn254_bound_faults = 0;
#endif
#define BN254_FUSED_KERNEL(key)                                              \
  extern "C" int bn254_host_##key(const int64_t* in, int64_t* out,           \
                                  int64_t n) {                               \
    bn254_bound_faults = 0;                                                  \
    for (int64_t e = 0; e < n; ++e) bn254::lane_##key(in, out, n, e);        \
    return bn254_bound_faults;                                               \
  }

// the shared leaf alone, on (18, n) limbs (montmul.cu's arithmetic)
extern "C" void bn254_host_cios(const int64_t* a, const int64_t* b,
                                int64_t* out, int64_t n) {
  for (int64_t e = 0; e < n; ++e) {
    uint32_t av[bn254::kLimbs], bv[bn254::kLimbs], r[bn254::kLimbs];
    for (int i = 0; i < bn254::kLimbs; ++i) {
      av[i] = static_cast<uint32_t>(a[i * n + e]);
      bv[i] = static_cast<uint32_t>(b[i * n + e]);
    }
    bn254::cios(r, av, bv);
    for (int i = 0; i < bn254::kLimbs; ++i) out[i * n + e] = r[i];
  }
}

#endif

BN254_FUSED_KERNEL(miller_dbl_body)
BN254_FUSED_KERNEL(miller_add_body)
BN254_FUSED_KERNEL(miller_dbl_body2)
BN254_FUSED_KERNEL(miller_add_body2)
BN254_FUSED_KERNEL(expu_step)
BN254_FUSED_KERNEL(expu_sq2)
BN254_FUSED_KERNEL(fq12_mul)
BN254_FUSED_KERNEL(fq12_sq)
BN254_FUSED_KERNEL(fq12_cyc_sq)
BN254_FUSED_KERNEL(el_pow_step_mul)
BN254_FUSED_KERNEL(el_pow_step_sq)
BN254_FUSED_KERNEL(glv_dbl_add)
BN254_FUSED_KERNEL(fq12_mul_line)
BN254_FUSED_KERNEL(g2_dbl_step)
BN254_FUSED_KERNEL(g2_add_step)
