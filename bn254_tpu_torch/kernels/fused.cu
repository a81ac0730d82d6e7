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
//   g1_add           dist/batch_verify.py:412          6 -> 3
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
// Design, the cooperative kernels (every key but the two pow windows:
// miller_dbl_body, miller_add_body, expu_step, fq12_mul, miller_dbl_body2,
// miller_add_body2, glv_dbl_add, expu_sq2, fq12_cyc_sq, fq12_mul_line,
// fq12_sq, g2_dbl_step, g2_add_step, g1_add): a group of G threads per lane. Their
// bodies are level schedules (kernels/coop_schedule.py, generated into
// coop_schedule.cuh): each level is a set of independent Fp operations (a
// CIOS product, an input load, one thread's chain of additions, or its chain
// of masked selects) that read only what earlier levels wrote. Thread g of
// the group runs operations g, g + G, ... of a level, then the group
// synchronises (__syncwarp for G <= 32, __syncthreads for a 64-thread group).
// A lane's values live in shared memory, one slot of 9 words (two 15-bit
// limbs each) per Fp, reused once dead: 91, 86, 108, 108, 97, 92, 20, 42, 42,
// 63, 72, 33, 28 and 19 slots (3.3, 3.1, 3.9, 3.9, 3.5, 3.3, 0.7, 1.5, 1.5,
// 2.3, 2.6, 1.2, 1.0 and 0.7 KB). The products of one product depth share a
// level (4, 4, 3, 1, 5, 4, 7, 2, 1, 1, 1, 3, 4 and 5 such levels, loads
// excluded;
// fq12_mul's 54 products are one level, each cyclotomic square's 18 another,
// the line fold's 39 one, fq12_sq's 36 one), the leaf runs with its operands
// in registers, and results agree with the plain bodies by canonical value.
// The leaf is the schedule's (S::kWideLeaf): cios_wide for glv_dbl_add,
// expu_sq2, fq12_cyc_sq, fq12_mul_line, fq12_sq, g2_dbl_step, g2_add_step
// and g1_add, cios for the six others; BN254_WIDE_LEAF=0 or 1, where
// defined, sets it for every schedule (kernel_times.py --leaf builds so).
// expu_sq2 (acc^4) is two Granger-Scott squarings, 36 products in 19 levels;
// fq12_cyc_sq one, 18 in 10. fq12_mul_line (f times the sparse line a + b w +
// c v w) is the plain body's Karatsuba over Fq6: fq6_mul_by_0's 9 products
// and two fq6_mul_by_01 of 15, 39 products in 8 levels (18 loads, then
// additions, the 39 products, then the Karatsuba's additions). fq12_sq (a^2,
// the plain body's complex squaring over Fq6: two fq6_mul of 18 products)
// runs its 36 products in one level of its 10; g2_dbl_step (2T and its
// tangent line at P, the point's Els, then the line's, as the plain body
// returns them) its 42 in three levels of 10, 17 and 15, of its 14;
// g2_add_step (T + Q for an affine Q and its chord line at P, in the same
// order) its 41 in four levels of 6, 14, 9 and 12, of its 16. glv_dbl_add
// (one Shamir step, 2 acc + sel) is the plain body's dbl-2009-l, add-2007-bl
// and the doubling of 2 acc that the plain complete add computes on every
// lane, 30 products in 22 levels of 1-7 operations, then one SEL per output
// coordinate with the plain body's four selects in its order. g1_add (one
// level of the signature tree-sum, p1 + p2) is the same complete addition
// alone: add-2007-bl and the doubling of p1, 23 products in 15 levels of
// 1-9 operations, then the three SELs. The Miller
// bodies keep the plain bodies' order (the square of a doubling digit, the
// step, the line fold, then the two-pair bodies' constant line), and the
// two-pair bodies' constant triple (ca, cb, cc) is read like any other input
// El: the wrapper's packing broadcasts it over the lanes. G comes from the
// lane count and the card's SM count (kCoopRule below, kGlvRule for
// glv_dbl_add, kG1AddRule for g1_add, kScanRule for the scan loop's
// fq12_sq, g2_dbl_step and g2_add_step): 64 for the one-lane final
// exponentiation, the narrow end of the Fq12 product tree and the scan
// loop's 65 and 128 lanes, 8 for 4,096 and 8,193 lanes, 4 for the scan
// loop's 8,192 and 8,193, 2 for glv_dbl_add's 16,384; g1_add 16 up to
// 1,024 lanes, 8 at 2,048 and 4 at 4,096. What bounds them: at thousands
// of lanes the instruction rate of the leaves; at one lane the latency of
// the levels, most of them chains of additions whose carries run limb by
// limb; glv_dbl_add and g1_add, whose levels hold 1-9 operations, the
// latency of their 22 and 15 levels.
//
// Design, the pow windows el_pow_step_mul (acc^8 m) and el_pow_step_sq
// (acc^8), one body (lane_el_pow_step<kMul>): the input loads, three
// squares and, for a nonzero window, the multiply, a strict chain of six
// products (four with the multiply off). One thread per lane, 64-thread
// blocks, every value in registers, each product cios_wide on the previous
// one's result. No two of its Fp operations are independent, so a level
// schedule would hold one product a level; sharing each product's columns
// between T threads of a lane (a shuffle for a_i, for m and for the column
// shift each CIOS round) was measured slower at every width for
// el_pow_step_mul, T = 1 / 2 / 4 / 8 in ms per launch (NVIDIA H100 80GB
// HBM3, 700.00 W): one lane, device time, 0.0113 / 0.0158 / 0.0139 /
// 0.0148; 8,193 lanes 0.0158 / 0.0177 / 0.0187 / 0.0231; 32,768 0.0209 /
// 0.0387 / 0.0547 / 0.0775; 65,536 0.0385 / 0.0745 / 0.0982 / 0.1480. What
// bounds them: at 65,536 lanes the instruction rate of their leaves, at one
// lane the latency of the chain.
//
// Under a host compiler (no __CUDACC__) the file instead exports
// bn254_host_<key>(in, out, n), the same lane bodies in a plain loop (the
// cooperative ones level by level, the group's threads in turn, also as
// bn254_host_<key>_g with a given G), and the two leaves as
// bn254_host_cios and bn254_host_cios_wide, which
// tests/test_torch_fused_host.py and tests/test_torch_coop.py build with
// g++ and hold against the plain torch bodies and montmul_plain.

#include "bn254_tower.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <algorithm>
#include <vector>
#endif

namespace bn254 {

// input El `el` of lane e (value < 2^270, limbs < 2^26), carried
BN_FN BN_INLINE void load_raw(Fp& raw, int el, const int64_t* in, int64_t n,
                              int64_t e) {
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t v = static_cast<uint32_t>(in[(el * kLimbs + i) * n + e]) + c;
    raw.l[i] = v & kMask;
    c = v >> kLimbBits;
  }
  BN_CHECK(c == 0u);  // value < 2^270
}

// REDC(a b) by cios_wide, operands and result in registers
BN_FN BN_INLINE void fp_mul_wide(Fp& r, const Fp& a, const Fp& b) {
#ifdef BN254_CHECK_BOUNDS
  for (int i = 0; i < kLimbs; ++i) {
    BN_CHECK(a.l[i] < (1u << 16));
    BN_CHECK(b.l[i] < (1u << 16));
  }
#endif
  Fp o;
  cios_wide(o.l, a.l, b.l);
  fp_check(o);
  r = o;
}

// inputs (acc, m) -> acc^8 m (kMul) or (acc) -> acc^8: the loads (REDC by
// R mod p, as a schedule's LOAD), three squares and, for a nonzero window, the
// multiply, one chain of cios_wide products (six, or four with kMul off)
template <bool kMul>
BN_FN BN_INLINE void lane_el_pow_step(const int64_t* in, int64_t* out,
                                      int64_t n, int64_t e) {
  constexpr int kIn = kMul ? 2 : 1;
  Fp one, v[kIn];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) one.l[i] = rmodp_limb(i);
#pragma unroll
  for (int k = 0; k < kIn; ++k) {
    Fp raw;
    load_raw(raw, k, in, n, e);
    fp_mul_wide(v[k], raw, one);
  }
#pragma unroll 1  // one copy of the square: 140 (146 without m), not 200
  for (int w = 0; w < kPowWindow; ++w) fp_mul_wide(v[0], v[0], v[0]);
  if constexpr (kMul) fp_mul_wide(v[0], v[0], v[kIn - 1]);
  uint32_t c[kLimbs];
  fp_canon_limbs(c, v[0].l);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i * n + e] = c[i];
}

}  // namespace bn254

// ---------------------------------------------------------------------------
// The lane-cooperative kernels: G threads per lane over the level schedules
// of coop_schedule.cuh
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
#define BN_TABLE static __device__ const
#define BN_COOP __device__ __forceinline__
#else
#define BN_TABLE static const
#define BN_COOP inline
#endif

// the instantiated group sizes (threads per lane); glv_dbl_add's also 1, 2
#define BN254_COOP_GROUPS(X) X(4) X(8) X(16) X(32) X(64)
#define BN254_GLV_GROUPS(X) X(1) X(2) BN254_COOP_GROUPS(X)

#include "coop_schedule.cuh"

namespace bn254 {

// op kinds, chain and select step codes and encodings of
// kernels/coop_schedule.py
enum : uint32_t { kOpMul = 0u, kOpLoad = 1u, kOpLin = 2u, kOpSel = 3u };
enum : uint32_t {
  kStepSet = 0u, kStepAdd, kStepSub, kStepRsub, kStepZero, kStepDbl
};
enum : uint32_t {
  kSelTake = 0u, kSelTakeZero, kSelTakeOne, kSelIfZero, kSelIfNonzero
};
constexpr uint32_t kNoSlot = 0x3FFFu, kNoEl = 0xFFFFu;
constexpr int kStepSlotBits = 13;
constexpr int kSlotWords = 9;  // an Fp in a slot: two 15-bit limbs a word

// The group size G for n lanes on a card of `sms` SMs, by L = n / sms
// lanes per SM (rounded up): the row of the smallest max_lanes_per_sm that
// L does not exceed. Each row is the G that was fastest where it was
// measured (chip_smoke.py's coop_sweep, every G at 1, 2, 4, 8, 15, 32 and
// 63 lanes per SM; NVIDIA H100 80GB HBM3, 700.00 W), with each boundary
// between two measured widths. miller_dbl_body, ms per launch: G=64 at 1
// and 2 lanes a SM (0.060, 0.067; G=32 0.064, 0.072); G=32 at 4 and 8
// (0.073, 0.087; G=64 0.081, 0.139; G=16 0.097, 0.099); G=16 at 15
// (0.111; G=32 0.151, G=8 0.158); G=8 at 32 (4,096 lanes: 0.173; G=16
// 0.193, G=4 0.264) and at 63 (8,193 lanes: 0.308, 4 % above G=4's 0.295,
// which is 1.5x slower at 32). expu_step orders the same way but at 63,
// where G=16 is 7 % faster than G=8. The two-pair bodies order the same
// way, every pick within 7 % of the best G (miller_dbl_body2 /
// miller_add_body2): 0.079 / 0.054 at 1 lane (G=64); at 4 lanes a SM
// miller_add_body2's G=32 0.069 against G=64's 0.066; at 32 (4,096 lanes)
// G=8 0.222 / 0.161 (G=4 0.349 / 0.254, G=16 0.255 / 0.182); at 63 G=8
// 0.395 / 0.296 against G=4's 0.390 / 0.278. fq12_mul and miller_add_body
// too, every pick within 8 % of the best G (fq12_mul / miller_add_body):
// 0.025 / 0.045 at 1 lane (G=64); at 4 lanes a SM G=32 0.035 / 0.056
// against G=64's 0.033 / 0.054; at 32 G=8 0.090 / 0.108 (G=16 0.093 /
// 0.123); at 63 G=8 0.197 / 0.198 against fq12_mul's G=16 0.183 and
// miller_add_body's G=4 0.191. expu_sq2 and fq12_cyc_sq (two and one
// cyclotomic squares over cios_wide, 18 products a product level) too,
// every pick within 4 % of the best G where their paths run them (expu_sq2
// / fq12_cyc_sq): at one lane, device time, G=64 0.0388 / 0.0227 against
// G=32's 0.0381 / 0.0220; at 4,096 lanes G=8 0.0867 / 0.0512 (G=4 0.1013 /
// 0.0578, G=16 0.1054 / 0.0607); at 8,193, where no path runs them, G=4
// 0.136 / 0.080 beats G=8's 0.153 / 0.088. fq12_mul_line (39 products a
// level over cios_wide) too, every pick within 3 % of the best G where its
// paths run it, G = 4 / 8 / 16 / 32 / 64: at 65 and 128 lanes (the tampered
// 64-tuple fallback and key check) G=64 0.0262 / 0.0216 against G=32's
// 0.0257 / 0.0232 (one lane, device time: 0.0184 against 0.0207); at 8,192
// and 8,193 G=8 0.1048 / 0.1049 against G=4's 0.1018 / 0.1030 (G=16
// 0.1294 / 0.1299); at 264 lanes, where no path runs it, G=32 0.0256 beat
// G=64's 0.0280 in one of two turns. Bigger groups idle more threads in
// each level's last round; smaller ones leave the SM's schedulers waiting
// on the leaf's dependent carries.
struct CoopRule {
  int64_t max_lanes_per_sm;
  int group;
};
constexpr int64_t kAnyWidth = int64_t(1) << 40;
constexpr CoopRule kCoopRule[] = {{3, 64}, {11, 32}, {23, 16}, {kAnyWidth, 8}};

// glv_dbl_add's rows, from its own sweep (coop_sweep at 1, 2, 32, 63 and
// 125 lanes a SM; NVIDIA H100 80GB HBM3, 700.00 W), ms per launch: at 1 and
// 2 lanes a SM G = 8 to 64 within 2 % (0.049-0.051; device time at one
// lane 0.044 at G=64, 0.045 at G=16), G=4 0.063, G=2 0.085; at 32 (4,096
// lanes) G=4 0.063 (G=8 0.065, G=2 0.086); at 63 (8,193) G=4 0.083 (G=2
// 0.087, G=8 0.113); at 125 (16,384, the GLV ladder) G=2 0.115 (G=4 0.148,
// G=8 0.209). G=1 takes 0.123-0.125 at every width, 10 % above G=2 at 125
// lanes a SM: one thread runs every operation of a level in turn, ~4 warps
// a SM at 16,384 lanes. Its levels hold 1-7 operations, so a big
// group's threads idle, and at thousands of lanes their issue slots cost
// more than the warps a bigger group adds (G=2 at 16,384 lanes: ~8 warps a
// SM). 4-31 lanes a SM, which no path runs, take G=4 unmeasured.
constexpr CoopRule kGlvRule[] = {{3, 64}, {94, 4}, {kAnyWidth, 2}};

// g1_add's rows, from its own sweep at the widths of the signature
// tree-sum, which halves its lanes every level from 4,096 (8,192 tuples)
// down to one (every G at 1-4,096 and 8,192 lanes, 50 launches back to
// back; NVIDIA H100 80GB HBM3, 700.00 W), ms per launch: at 1-4 lanes a
// SM G=16 and G=32 within 1 % (0.0378-0.0384; G=64 0.0385-0.0390, G=4
// 0.0483-0.0489); at 8 (1,024 lanes) G=16 0.0381 (G=8 0.0406, G=32
// 0.0495); at 16 (2,048) G=8 0.0410 (G=4 0.0492, G=16 0.0498); at 32
// (4,096) G=4 0.0492 (G=8 0.0531) and at 63 (8,192) G=4 0.0645 (G=8
// 0.0929). Each level is latency-bound: its 15 levels hold 1-9 operations,
// and the whole tree-sum of 8,192 rows takes 0.54 ms of device time.
constexpr CoopRule kG1AddRule[] = {{11, 16}, {23, 8}, {kAnyWidth, 4}};

// The scan loop's rows (fq12_sq, g2_dbl_step, g2_add_step), from their own
// sweep (coop_sweep at 1, 2, 4, 8, 15, 32 and 63 lanes a SM; NVIDIA H100
// 80GB HBM3, 700.00 W), ms per launch, fq12_sq / g2_dbl_step: at 1 lane a SM (1, 65 and 128 lanes: the
// tampered 64-tuple fallback and the key check) G=64 0.0288 / 0.0306 (G=32
// 0.0312 / 0.0304; one lane, device time, 0.0279 / 0.0285 against 0.0281 /
// 0.0283); at 4 G=32 0.0318 / 0.0306 (G=16 0.0355 / 0.0330, G=64 0.0395 /
// 0.0392); at 8 and 15 G=16 0.0368 / 0.0335 and 0.0486 / 0.0427 (G=32 0.0439
// / 0.0393 at 8, G=8 0.0516 / 0.0437 at 15); at 32 (4,096 lanes) G=8 0.0686
// / 0.0565 (G=4 0.0786 / 0.0669); at 63 (8,192 and 8,193 lanes: the Miller
// rows and the stacked independent tier) G=4 0.1046 / 0.0884, where
// kCoopRule's G=8 takes 0.1158 / 0.0977, 11 % more. G=4 packs 16 lanes a
// block: fq12_sq's 41.5 KB of slots a block leave room for 5 blocks a SM
// (g2_dbl_step's 19 KB for 10), enough for one wave of 8,193 lanes, and its
// product levels (36; 10, 17 and 15) idle fewer of a group's threads in
// their last round than G=8's. g2_add_step (product levels of 6, 14, 9 and
// 12; 16 KB a block at G=4, 10 blocks a SM) fits the same rule, within 2.2 %
// of the best G at every width its paths run it at (coop_sweep and
// kernel_times.py --every-group): at 1, 65 and 128 lanes G=64 0.0349 /
// 0.0359 / 0.0360 against G=32's 0.0342 / 0.0356 / 0.0356; at 8,192 and
// 8,193 G=4 0.0868 / 0.0876, where G=8 takes 0.1033 / 0.1034.
constexpr CoopRule kScanRule[] = {
    {3, 64}, {5, 32}, {23, 16}, {47, 8}, {kAnyWidth, 4}};

// the group size of `rule` for n lanes on `sms` SMs
template <int N>
constexpr int coop_group(const CoopRule (&rule)[N], int64_t n, int sms) {
  const int64_t per_sm = (n + sms - 1) / sms;
  for (int i = 0; i < N - 1; ++i)
    if (per_sm <= rule[i].max_lanes_per_sm) return rule[i].group;
  return rule[N - 1].group;
}

// the group sizes `rule` can pick, into out[0..cap); returns their number
template <int N>
int coop_groups(const CoopRule (&rule)[N], int* out, int cap) {
  for (int i = 0; i < N && i < cap; ++i) out[i] = rule[i].group;
  return N;
}

BN_COOP uint32_t tab(const uint16_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

BN_COOP void slot_get(uint32_t r[kLimbs], const uint32_t* st, uint32_t slot) {
  const uint32_t* w = st + slot * kSlotWords;
#pragma unroll
  for (int j = 0; j < kSlotWords; ++j) {
    const uint32_t v = w[j];
    r[2 * j] = v & 0xFFFFu;
    r[2 * j + 1] = v >> 16;
  }
#ifdef BN254_CHECK_BOUNDS
  for (int i = 0; i < kLimbs; ++i) BN_CHECK(r[i] <= kMask);  // written, carried
#endif
}

BN_COOP void slot_put(uint32_t* st, uint32_t slot, const uint32_t r[kLimbs]) {
  uint32_t* w = st + slot * kSlotWords;
#pragma unroll
  for (int j = 0; j < kSlotWords; ++j) w[j] = r[2 * j] | (r[2 * j + 1] << 16);
}

// a chain of additions (coop_schedule.py, LIN): each step's result below 2p
// with carried limbs, a sum as fold_2p(lhs + rhs), a difference as
// fold_2p(lhs + (2p - rhs))
BN_COOP void coop_chain(Fp& acc, const uint16_t* steps, uint32_t len,
                        const uint32_t* st) {
  for (uint32_t s = 0; s < len; ++s) {
    const uint32_t w = tab(steps + s);
    const uint32_t code = w >> kStepSlotBits;
    if (code == kStepZero) {
      fp_zero(acc);
      continue;
    }
    uint32_t x[kLimbs];
    if (code == kStepDbl) {
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) x[i] = acc.l[i];
    } else {
      slot_get(x, st, w & ((1u << kStepSlotBits) - 1u));
    }
    if (code == kStepSet) {
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) acc.l[i] = x[i];
      continue;
    }
    const uint32_t swap = 0u - static_cast<uint32_t>(code == kStepRsub);
    const uint32_t neg =
        0u - static_cast<uint32_t>(code == kStepSub || code == kStepRsub);
    uint32_t sum[kLimbs];
    uint32_t borrow = 0u, carry = 0u;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const uint32_t lhs = (acc.l[i] & ~swap) | (x[i] & swap);
      const uint32_t rhs = (x[i] & ~swap) | (acc.l[i] & swap);
      const uint32_t v = p2_limb(i) + (1u << kLimbBits) - rhs - borrow;
      borrow = 1u - (v >> kLimbBits);
      const uint32_t term = ((v & kMask) & neg) | (rhs & ~neg);
      const uint32_t t = lhs + term + carry;
      sum[i] = t & kMask;
      carry = t >> kLimbBits;
    }
    fp_fold_2p(acc, sum);  // lhs + term < 4p
  }
}

// a chain of masked selects (coop_schedule.py, SEL): a take (a slot, 0 or
// the Montgomery one) replaces acc where every test since the previous take
// holds; a test asks whether a slot is zero mod p (fp_is_zero). Branch free:
// the lanes of a warp run the same steps on their own data.
BN_COOP void coop_select(Fp& acc, const uint16_t* steps, uint32_t len,
                         const uint32_t* st) {
  fp_zero(acc);  // the first step is a take
  uint32_t hold = ~0u;  // all ones while every test since the take holds
  for (uint32_t s = 0; s < len; ++s) {
    const uint32_t w = tab(steps + s);
    const uint32_t code = w >> kStepSlotBits;
    const uint32_t slot = w & ((1u << kStepSlotBits) - 1u);
    uint32_t x[kLimbs];
    if (code == kSelIfZero || code == kSelIfNonzero) {
      slot_get(x, st, slot);
      const uint32_t zero = 0u - static_cast<uint32_t>(fp_is_zero(x));
      hold &= code == kSelIfZero ? zero : ~zero;
      continue;
    }
    if (code == kSelTake) {
      slot_get(x, st, slot);
    } else {
#pragma unroll
      for (int i = 0; i < kLimbs; ++i)
        x[i] = code == kSelTakeOne ? rmodp_limb(i) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      acc.l[i] = (x[i] & hold) | (acc.l[i] & ~hold);
    hold = ~0u;
  }
}

// op k of schedule S on lane e, whose slots are st; its products (MUL and
// LOAD) run the schedule's leaf, cios_wide or cios
template <class S>
BN_COOP void coop_op(int k, uint32_t* st, const int64_t* in, int64_t* out,
                     int64_t n, int64_t e) {
  const uint16_t* op = S::ops() + 4 * k;
  const uint32_t w0 = tab(op), gout = tab(op + 1);
  const uint32_t a = tab(op + 2), b = tab(op + 3);
  const uint32_t kind = w0 >> 14, slot = w0 & kNoSlot;
  Fp r;
  if (kind == kOpLin) {
    coop_chain(r, S::steps() + a, b, st);
  } else if (kind == kOpSel) {
    coop_select(r, S::steps() + a, b, st);
  } else {
    uint32_t x[kLimbs], y[kLimbs];
    if (kind == kOpLoad) {  // input El a: carried, then REDC by R mod p
      uint32_t c = 0u;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        const uint32_t v =
            static_cast<uint32_t>(in[(a * kLimbs + i) * n + e]) + c;
        x[i] = v & kMask;
        c = v >> kLimbBits;
        y[i] = rmodp_limb(i);
      }
      BN_CHECK(c == 0u);  // value < 2^270
    } else {
      slot_get(x, st, a);
      slot_get(y, st, b);
    }
#ifdef BN254_WIDE_LEAF
    constexpr bool wide = BN254_WIDE_LEAF;
#else
    constexpr bool wide = S::kWideLeaf;
#endif
    if constexpr (wide) {
      cios_wide(r.l, x, y);
    } else {
      cios(r.l, x, y);
    }
    fp_check(r);
  }
  if (slot != kNoSlot) slot_put(st, slot, r.l);
  if (gout != kNoEl) {
    uint32_t c[kLimbs];
    fp_canon_limbs(c, r.l);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) out[(gout * kLimbs + i) * n + e] = c[i];
  }
}

}  // namespace bn254

// bn254_<key>_groups(out, cap): the sizes `rule` can pick (their number);
// bn254_<key>_group(n, sms): its pick for n lanes on `sms` SMs
#define BN254_RULE_EXPORTS(key, rule)                                      \
  extern "C" int bn254_##key##_groups(int* out, int cap) {                 \
    return bn254::coop_groups(bn254::rule, out, cap);                      \
  }                                                                        \
  extern "C" int bn254_##key##_group(int64_t n, int sms) {                 \
    return bn254::coop_group(bn254::rule, n, sms);                         \
  }

#ifdef __CUDACC__

namespace {
constexpr int kThreads = 64;
}

// bn254_<key>(in, out, n, stream): lane body `lane` launched on `stream`;
// returns cudaGetLastError
#define BN254_FUSED_KERNEL(key, lane)                                         \
  __global__ void __launch_bounds__(kThreads)                                 \
      key##_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, \
                   int64_t n) {                                               \
    const int64_t e =                                                         \
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;          \
    if (e < n) bn254::lane(in, out, n, e);                                    \
  }                                                                           \
  extern "C" int bn254_##key(const int64_t* in, int64_t* out, int64_t n,      \
                             void* stream) {                                  \
    if (n <= 0) return 0;                                                     \
    const int64_t blocks = (n + kThreads - 1) / kThreads;                     \
    key##_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,                \
                   static_cast<cudaStream_t>(stream)>>>(in, out, n);          \
    return static_cast<int>(cudaGetLastError());                              \
  }

// -- the cooperative kernels: kCoopThreads threads a block, kCoopThreads / G
// lanes, each lane's slots in dynamic shared memory
constexpr int kCoopThreads = 64;

template <int G>
__device__ __forceinline__ void coop_sync() {
  if constexpr (G <= 32) {
    __syncwarp();  // a group never straddles a warp; every thread syncs
  } else {
    __syncthreads();
  }
}

template <class S, int G>
__global__ void __launch_bounds__(kCoopThreads)
    coop_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                int64_t n) {
  extern __shared__ uint32_t coop_slots[];
  constexpr int kLanes = kCoopThreads / G;
  const int lane = threadIdx.x / G, g = threadIdx.x % G;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kLanes + lane;
  uint32_t* st = coop_slots + lane * S::kLaneWords;
  const uint16_t* levels = S::levels();
  for (int v = 0; v < S::kLevels; ++v) {
    if (e < n) {
      const int end = bn254::tab(levels + v + 1);
      for (int k = bn254::tab(levels + v) + g; k < end; k += G)
        bn254::coop_op<S>(k, st, in, out, n, e);
    }
    coop_sync<G>();
  }
}

template <class S, int G>
constexpr size_t coop_smem() {
  return sizeof(uint32_t) * (kCoopThreads / G) * S::kLaneWords;
}

template <class S, int G>
cudaError_t coop_allow_smem() {
  static const cudaError_t rc = cudaFuncSetAttribute(
      coop_kernel<S, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(coop_smem<S, G>()));
  return rc;
}

template <class S, int G>
int coop_launch(const int64_t* in, int64_t* out, int64_t n,
                cudaStream_t stream) {
  const cudaError_t rc = coop_allow_smem<S, G>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  constexpr int kLanes = kCoopThreads / G;
  const int64_t blocks = (n + kLanes - 1) / kLanes;
  coop_kernel<S, G><<<static_cast<unsigned>(blocks), kCoopThreads,
                      coop_smem<S, G>(), stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

// info[0..5]: resident blocks per SM, shared bytes per block, lanes per
// block, registers per thread, local (stack) bytes per thread, threads
template <class S, int G>
int coop_info(int* info) {
  cudaError_t rc = coop_allow_smem<S, G>();
  cudaFuncAttributes fa;
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, coop_kernel<S, G>);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, coop_kernel<S, G>, kCoopThreads, coop_smem<S, G>());
  if (rc != cudaSuccess) return static_cast<int>(rc);
  info[0] = blocks;
  info[1] = static_cast<int>(coop_smem<S, G>());
  info[2] = kCoopThreads / G;
  info[3] = fa.numRegs;
  info[4] = static_cast<int>(fa.localSizeBytes);
  info[5] = kCoopThreads;
  return 0;
}

inline int coop_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// a cooperative kernel over schedule S (GROUPS: its instantiated sizes;
// rule: its CoopRule rows): bn254_<key>(in, out, n, stream) with the rule's
// G; bn254_<key>_g with a given G (one that is not instantiated is
// cudaErrorInvalidValue); bn254_<key>_info; bn254_<key>_groups and _group,
// the rule's sizes and pick
#define BN254_COOP_CASE_LAUNCH(G) \
  case G:                         \
    return coop_launch<S, G>(in, out, n, static_cast<cudaStream_t>(stream));
#define BN254_COOP_CASE_INFO(G) \
  case G:                       \
    return coop_info<S, G>(info);
#define BN254_COOP_KERNEL(key, Sched, GROUPS, rule)                          \
  extern "C" int bn254_##key##_g(const int64_t* in, int64_t* out, int64_t n, \
                                 int group, void* stream) {                  \
    using S = bn254::Sched;                                                  \
    if (n <= 0) return 0;                                                    \
    switch (group) { GROUPS(BN254_COOP_CASE_LAUNCH) }                        \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  }                                                                          \
  extern "C" int bn254_##key(const int64_t* in, int64_t* out, int64_t n,     \
                             void* stream) {                                 \
    const int sms = coop_sms();                                              \
    if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);                \
    return bn254_##key##_g(in, out, n,                                       \
                           bn254::coop_group(bn254::rule, n, sms), stream);  \
  }                                                                          \
  extern "C" int bn254_##key##_info(int group, int* info) {                  \
    using S = bn254::Sched;                                                  \
    switch (group) { GROUPS(BN254_COOP_CASE_INFO) }                          \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  }                                                                          \
  BN254_RULE_EXPORTS(key, rule)

#else

// bn254_host_<key>(in, out, n): lane body `lane` in a loop on the host;
// returns the number of failed bound checks (0 without BN254_CHECK_BOUNDS)
#ifndef BN254_CHECK_BOUNDS
static int bn254_bound_faults = 0;
#endif
#define BN254_FUSED_KERNEL(key, lane)                                        \
  extern "C" int bn254_host_##key(const int64_t* in, int64_t* out,           \
                                  int64_t n) {                               \
    bn254_bound_faults = 0;                                                  \
    for (int64_t e = 0; e < n; ++e) bn254::lane(in, out, n, e);              \
    return bn254_bound_faults;                                               \
  }

// the two leaves alone, on (18, n) limbs (montmul.cu's arithmetic)
template <void (*Leaf)(uint32_t*, const uint32_t*, const uint32_t*)>
void host_leaf(const int64_t* a, const int64_t* b, int64_t* out, int64_t n) {
  for (int64_t e = 0; e < n; ++e) {
    uint32_t av[bn254::kLimbs], bv[bn254::kLimbs], r[bn254::kLimbs];
    for (int i = 0; i < bn254::kLimbs; ++i) {
      av[i] = static_cast<uint32_t>(a[i * n + e]);
      bv[i] = static_cast<uint32_t>(b[i * n + e]);
    }
    Leaf(r, av, bv);
    for (int i = 0; i < bn254::kLimbs; ++i) out[i * n + e] = r[i];
  }
}

extern "C" void bn254_host_cios(const int64_t* a, const int64_t* b,
                                int64_t* out, int64_t n) {
  host_leaf<bn254::cios>(a, b, out, n);
}

extern "C" void bn254_host_cios_wide(const int64_t* a, const int64_t* b,
                                     int64_t* out, int64_t n) {
  host_leaf<bn254::cios_wide>(a, b, out, n);
}

// bn254_host_<key>_g(in, out, n, G): the cooperative schedule on the host,
// each level's ops in the order of the group's threads g = 0..G-1, each
// thread's share g, g + G, ...; the slots start poisoned (limbs 0xFFFF),
// so a read of a slot no earlier level wrote fails a bound check. A G that
// is not instantiated returns -1.
template <class S>
int coop_host(const int64_t* in, int64_t* out, int64_t n, int group) {
  bn254_bound_faults = 0;
  std::vector<uint32_t> st(S::kLaneWords);
  const uint16_t* levels = S::levels();
  for (int64_t e = 0; e < n; ++e) {
    std::fill(st.begin(), st.end(), 0xFFFFFFFFu);
    for (int v = 0; v < S::kLevels; ++v)
      for (int g = 0; g < group; ++g)
        for (int k = levels[v] + g; k < levels[v + 1]; k += group)
          bn254::coop_op<S>(k, st.data(), in, out, n, e);
  }
  return bn254_bound_faults;
}

constexpr int kHostSms = 132;  // the H100's

// bn254_host_<key>(in, out, n) takes G by the rule for a 132-SM card
#define BN254_HOST_CASE(G) case G:
#define BN254_COOP_KERNEL(key, Sched, GROUPS, rule)                          \
  extern "C" int bn254_host_##key##_g(const int64_t* in, int64_t* out,       \
                                      int64_t n, int group) {                \
    switch (group) {                                                         \
      GROUPS(BN254_HOST_CASE)                                                \
      return coop_host<bn254::Sched>(in, out, n, group);                     \
    }                                                                        \
    return -1;                                                               \
  }                                                                          \
  extern "C" int bn254_host_##key(const int64_t* in, int64_t* out,           \
                                  int64_t n) {                               \
    return coop_host<bn254::Sched>(                                          \
        in, out, n, bn254::coop_group(bn254::rule, n, kHostSms));            \
  }                                                                          \
  BN254_RULE_EXPORTS(key, rule)

#endif

BN254_FUSED_KERNEL(el_pow_step_mul, lane_el_pow_step<true>)
BN254_FUSED_KERNEL(el_pow_step_sq, lane_el_pow_step<false>)
BN254_COOP_KERNEL(miller_dbl_body, CoopMillerDblBody, BN254_COOP_GROUPS,
                  kCoopRule)
BN254_COOP_KERNEL(expu_step, CoopExpuStep, BN254_COOP_GROUPS, kCoopRule)
BN254_COOP_KERNEL(miller_dbl_body2, CoopMillerDblBody2, BN254_COOP_GROUPS,
                  kCoopRule)
BN254_COOP_KERNEL(miller_add_body2, CoopMillerAddBody2, BN254_COOP_GROUPS,
                  kCoopRule)
BN254_COOP_KERNEL(fq12_mul, CoopFq12Mul, BN254_COOP_GROUPS, kCoopRule)
BN254_COOP_KERNEL(miller_add_body, CoopMillerAddBody, BN254_COOP_GROUPS,
                  kCoopRule)
BN254_COOP_KERNEL(glv_dbl_add, CoopGlvDblAdd, BN254_GLV_GROUPS, kGlvRule)
BN254_COOP_KERNEL(expu_sq2, CoopExpuSq2, BN254_COOP_GROUPS, kCoopRule)
BN254_COOP_KERNEL(fq12_cyc_sq, CoopFq12CycSq, BN254_COOP_GROUPS, kCoopRule)
BN254_COOP_KERNEL(fq12_mul_line, CoopFq12MulLine, BN254_COOP_GROUPS,
                  kCoopRule)
BN254_COOP_KERNEL(fq12_sq, CoopFq12Sq, BN254_COOP_GROUPS, kScanRule)
BN254_COOP_KERNEL(g2_dbl_step, CoopG2DblStep, BN254_COOP_GROUPS, kScanRule)
BN254_COOP_KERNEL(g2_add_step, CoopG2AddStep, BN254_COOP_GROUPS, kScanRule)
BN254_COOP_KERNEL(g1_add, CoopG1Add, BN254_COOP_GROUPS, kG1AddRule)
