// B13's arithmetic: BLS12-381 Fq on [0, 2q) and the G1 add and doubling as
// programs over field slots.  Included only by g1_ops.cu; the other kernels
// keep fq_chain.cuh's fully reduced arithmetic, whose carry primitives this
// file uses.
//
// Values are 12 little-endian 32-bit words in Montgomery form (R = 2^384),
// held in [0, 2q) between the steps of a formula and fully reduced only when
// they leave it (`reduce`), so the outputs are byte-equal to the plain
// versions':
//
//   * `mul`: CIOS with the partial sums split into an even and an odd half
//     (the words of a * b_i at even and at odd j go to two arrays, so each
//     product row is two independent carry chains of 12, and each half takes
//     the other's role after the shift by one word; ptxas fuses each (lo, hi)
//     pair of a chain into one IMAD.WIDE.U32.X).  Inputs below 2q give an
//     output below 2q without a final subtract: t < (4 q^2 + q R) / R < 2q
//     as 4q < R, and every partial sum stays below a + q < 2^383;
//   * `sqr`: the 66 cross products once (each row two chains, the pairs at
//     even and at odd words), doubled by funnel shifts, the 12 squares on
//     the diagonal, then twelve reduction rows on the low half as `mul` runs
//     them and the high half added: 222 limb products where `mul` takes
//     300.  Every chain keeps a limb product's lo and hi words adjacent, so
//     ptxas fuses the pair into one IMAD.WIDE.U32.X; a first squaring with
//     separate lo and hi chains (two SASS instructions a half) was slower
//     than `mul(a, a)` when timed with utils/bench_g1.py on an H100;
//   * `add` / `sub`: modulo 2q (one conditional subtract of 2q, or an add of
//     2q after a borrow);
//   * `reduce`: [0, 2q) -> [0, q), one conditional subtract of q.
//
// A formula is a program of steps {op, d, a, b}: slot d <- slot a op slot b.
// `run` interprets it in one loop, so the products' code exists once in a
// kernel however many products its formula takes (the parent kernels
// inlined every product: 29,928 SASS instructions for the add, whose misses
// in the instruction cache doubled its time; see g1_ops.cu).  Slots are the
// caller's: shared memory on the card, plain arrays on a host.
#pragma once

#include "fq_chain.cuh"

namespace fql {

using fqc::fe;
using fqc::N;
using fqc::N0;
using fqc::qw;
using fqc::add_cc;
using fqc::addc_cc;
using fqc::addc;
using fqc::sub_cc;
using fqc::subc_cc;
using fqc::subc;
using fqc::mad_lo_cc;
using fqc::madc_lo_cc;
using fqc::mad_hi_cc;
using fqc::madc_hi_cc;
using fqc::madc_hi;

// word k of 2q
__device__ __forceinline__ constexpr uint32_t q2w(int k) {
  return k == 0 ? 0xffff5556u : k == 1 ? 0x73fdffffu : k == 2 ? 0x62a7ffffu
       : k == 3 ? 0x3d57fffdu : k == 4 ? 0xed61ec48u : k == 5 ? 0xce61a541u
       : k == 6 ? 0xe70a257eu : k == 7 ? 0xc8ee9709u : k == 8 ? 0x869759aeu
       : k == 9 ? 0x96374f6cu : k == 10 ? 0x72ffcd34u : 0x340223d4u;
}

// a + b mod 2q, a, b < 2q
__device__ __forceinline__ void add(fe& r, const fe& a, const fe& b) {
  fe t, d;
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) t[k] = addc_cc(a[k], b[k]);
  t[N - 1] = addc(a[N - 1], b[N - 1]);  // < 4q < 2^384
  d[0] = sub_cc(t[0], q2w(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = subc_cc(t[k], q2w(k));
  const uint32_t borrow = subc(0u, 0u);  // all ones when t < 2q
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = borrow ? t[k] : d[k];
}

// a - b mod 2q, a, b < 2q
__device__ __forceinline__ void sub(fe& r, const fe& a, const fe& b) {
  fe t;
  t[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) t[k] = subc_cc(a[k], b[k]);
  const uint32_t mask = subc(0u, 0u);  // all ones when a < b: add 2q back
  r[0] = add_cc(t[0], q2w(0) & mask);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(t[k], q2w(k) & mask);
  r[N - 1] = addc(t[N - 1], q2w(N - 1) & mask);
}

// [0, 2q) -> [0, q)
__device__ __forceinline__ void reduce(fe& r, const fe& a) {
  fe d;
  d[0] = sub_cc(a[0], qw(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = subc_cc(a[k], qw(k));
  const uint32_t borrow = subc(0u, 0u);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = borrow ? a[k] : d[k];
}

// a == 0 mod q, for a < 2q: a is 0 or q
__device__ __forceinline__ bool is_zero_mod(const fe& a) {
  uint32_t z = 0u, e = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    z |= a[k];
    e |= a[k] ^ qw(k);
  }
  return z == 0u || e == 0u;
}

// One CIOS row on the split partial sum.  On entry E and O hold
// V = (E >> 32) + O (E[0] = 0): E's words 1.. at positions 0.., O's at
// positions 0...  Adds a * bi, then m q with m chosen to clear the lowest
// word; on return O (lowest word 0) and E hold (V + a bi + m q) / 2^32 as
// (O >> 32) + E, so the next row is row(O, E, ...).
__device__ __forceinline__ void row(uint32_t* E, uint32_t* O, const fe& a, uint32_t bi) {
  // O holds positions k, E positions k + 1 from here: E[1] joins O[0], the
  // rest of E moves down two words while the odd products of a * bi land
  O[0] = add_cc(O[0], E[1]);
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    E[j] = madc_lo_cc(a[j + 1], bi, E[j + 2]);
    E[j + 1] = madc_hi_cc(a[j + 1], bi, E[j + 3]);
  }
  E[N - 2] = madc_lo_cc(a[N - 1], bi, 0u);
  E[N - 1] = madc_hi(a[N - 1], bi, 0u);
  // the even products into O, its carry into E's top word
  O[0] = mad_lo_cc(a[0], bi, O[0]);
  O[1] = madc_hi_cc(a[0], bi, O[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    O[j] = madc_lo_cc(a[j], bi, O[j]);
    O[j + 1] = madc_hi_cc(a[j], bi, O[j + 1]);
  }
  E[N - 1] = addc(E[N - 1], 0u);
  // + m q: the odd words of q into E, the even ones into O
  const uint32_t m = O[0] * N0;
  E[0] = mad_lo_cc(m, qw(1), E[0]);
  E[1] = madc_hi_cc(m, qw(1), E[1]);
#pragma unroll
  for (int j = 2; j < N - 2; j += 2) {
    E[j] = madc_lo_cc(m, qw(j + 1), E[j]);
    E[j + 1] = madc_hi_cc(m, qw(j + 1), E[j + 1]);
  }
  E[N - 2] = madc_lo_cc(m, qw(N - 1), E[N - 2]);
  E[N - 1] = madc_hi(m, qw(N - 1), E[N - 1]);
  O[0] = mad_lo_cc(m, qw(0), O[0]);
  O[1] = madc_hi_cc(m, qw(0), O[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    O[j] = madc_lo_cc(m, qw(j), O[j]);
    O[j + 1] = madc_hi_cc(m, qw(j), O[j + 1]);
  }
  E[N - 1] = addc(E[N - 1], 0u);
}

// a b R^-1 mod q, in [0, 2q) for a, b < 2q
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  uint32_t ev[N], od[N];
#pragma unroll
  for (int k = 0; k < N; ++k) ev[k] = od[k] = 0u;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    row(ev, od, a, b[i]);
    row(od, ev, a, b[i + 1]);
  }
  // (ev >> 32) + od
  r[0] = add_cc(od[0], ev[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(od[k], ev[k + 1]);
  r[N - 1] = addc(od[N - 1], 0u);
}

// One Montgomery reduction row on the split partial sum, no product: as
// `row` with a * bi = 0.  The shift of E by two words rides on the chain of
// the odd words of m q.
__device__ __forceinline__ void redc_row(uint32_t* E, uint32_t* O) {
  O[0] = add_cc(O[0], E[1]);
  const uint32_t m = O[0] * N0;  // no carry instruction: the flag survives
  E[0] = madc_lo_cc(m, qw(1), E[2]);
  E[1] = madc_hi_cc(m, qw(1), E[3]);
#pragma unroll
  for (int j = 2; j < N - 2; j += 2) {
    E[j] = madc_lo_cc(m, qw(j + 1), E[j + 2]);
    E[j + 1] = madc_hi_cc(m, qw(j + 1), E[j + 3]);
  }
  E[N - 2] = madc_lo_cc(m, qw(N - 1), 0u);
  E[N - 1] = madc_hi(m, qw(N - 1), 0u);
  O[0] = mad_lo_cc(m, qw(0), O[0]);
  O[1] = madc_hi_cc(m, qw(0), O[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    O[j] = madc_lo_cc(m, qw(j), O[j]);
    O[j + 1] = madc_hi_cc(m, qw(j), O[j + 1]);
  }
  E[N - 1] = addc(E[N - 1], 0u);
}

// t += a_i (a_j0 2^(32 j0) + a_(j0+2) 2^(32 (j0+2)) + ...) 2^(32 i), j < N:
// one chain of (lo, hi) pairs, its carry into the word above the last pair
__device__ __forceinline__ void cross_chain(uint32_t* t, const fe& a, int i, int j0) {
  t[i + j0] = mad_lo_cc(a[i], a[j0], t[i + j0]);
  t[i + j0 + 1] = madc_hi_cc(a[i], a[j0], t[i + j0 + 1]);
  int j = j0 + 2;
#pragma unroll
  for (; j < N; j += 2) {
    t[i + j] = madc_lo_cc(a[i], a[j], t[i + j]);
    t[i + j + 1] = madc_hi_cc(a[i], a[j], t[i + j + 1]);
  }
  t[i + j] = addc(t[i + j], 0u);
}

// a^2 R^-1 mod q, in [0, 2q) for a < 2q
__device__ __forceinline__ void sqr(fe& r, const fe& a) {
  // cross products a_i a_j (i < j), the word pair (lo, hi) at i + j, i + j + 1:
  // those at even i + j into ev, the others into od, each row of each a chain
  // whose carry goes to the word above its last pair (no chain reaches past
  // word 23: the sums stay below a^2 < 2^768)
  uint32_t ev[2 * N], od[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) ev[k] = od[k] = 0u;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    if (i + 2 < N) cross_chain(ev, a, i, i + 2);  // i + j even
    cross_chain(od, a, i, i + 1);                 // i + j odd
  }
  // t = 2 (ev + od) + the squares a_i^2 at word 2 i
  uint32_t t[2 * N];
  t[0] = add_cc(ev[0], od[0]);
#pragma unroll
  for (int k = 1; k < 2 * N - 1; ++k) t[k] = addc_cc(ev[k], od[k]);
  t[2 * N - 1] = addc(ev[2 * N - 1], od[2 * N - 1]);
#pragma unroll
  for (int k = 2 * N - 1; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] <<= 1;
  t[0] = mad_lo_cc(a[0], a[0], t[0]);
  t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) {
    t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * N - 2] = madc_lo_cc(a[N - 1], a[N - 1], t[2 * N - 2]);
  t[2 * N - 1] = madc_hi(a[N - 1], a[N - 1], t[2 * N - 1]);
  // (t + M q) / R = REDC(low half) + high half, below 2q: twelve reduction
  // rows on the low half as `mul`'s rows run, then the high half added
  uint32_t E[N], O[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    E[k] = 0u;
    O[k] = t[k];
  }
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    redc_row(E, O);
    redc_row(O, E);
  }
  r[0] = add_cc(O[0], E[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(O[k], E[k + 1]);
  r[N - 1] = addc(O[N - 1], 0u);
  r[0] = add_cc(r[0], t[N]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(r[k], t[N + k]);
  r[N - 1] = addc(r[N - 1], t[2 * N - 1]);
}

// --- formulas as programs over slots ---------------------------------------

enum Op : uint8_t { MUL = 0, SQR = 1, ADD = 2, SUB = 3 };

struct alignas(4) Step {
  uint8_t op, d, a, b;  // slot d <- slot a op slot b (SQR reads a only)
};

// The add (add-2007-bl as the plain version orders it), slots 0-2 P, 3-5 Q,
// 6-7 scratch; 16 products.  Results: X3 in 7, Y3 in 0, Z3 in 2; H stays in
// 3 and R in 4 for the special cases.
#define G1_ADD_PROGRAM                                                        \
  {fql::SQR, 6, 2, 0},     /* Z1Z1 = Z1^2 */                                 \
  {fql::SQR, 7, 5, 0},     /* Z2Z2 = Z2^2 */                                 \
  {fql::MUL, 0, 0, 7},     /* U1 = X1 Z2Z2 */                                \
  {fql::MUL, 3, 3, 6},     /* U2 = X2 Z1Z1 */                                \
  {fql::SUB, 3, 3, 0},     /* H = U2 - U1 */                                 \
  {fql::MUL, 7, 5, 7},     /* Z2 Z2Z2 */                                     \
  {fql::MUL, 6, 2, 6},     /* Z1 Z1Z1 */                                     \
  {fql::MUL, 1, 1, 7},     /* S1 = Y1 Z2^3 */                                \
  {fql::MUL, 4, 4, 6},     /* S2 = Y2 Z1^3 */                                \
  {fql::SUB, 4, 4, 1},     /* R = S2 - S1 */                                 \
  {fql::MUL, 2, 2, 5},     /* Z1 Z2 */                                       \
  {fql::MUL, 2, 2, 3},     /* Z3 = Z1 Z2 H */                                \
  {fql::SQR, 5, 3, 0},     /* HH */                                          \
  {fql::MUL, 6, 3, 5},     /* HHH = H HH */                                  \
  {fql::MUL, 0, 0, 5},     /* V = U1 HH */                                   \
  {fql::SQR, 7, 4, 0},     /* R^2 */                                         \
  {fql::SUB, 7, 7, 6},     /* R^2 - HHH */                                   \
  {fql::SUB, 7, 7, 0},                                                        \
  {fql::SUB, 7, 7, 0},     /* X3 = R^2 - HHH - 2 V */                        \
  {fql::SUB, 0, 0, 7},     /* V - X3 */                                      \
  {fql::MUL, 0, 4, 0},     /* R (V - X3) */                                  \
  {fql::MUL, 1, 1, 6},     /* S1 HHH */                                      \
  {fql::SUB, 0, 0, 1}      /* Y3 = R (V - X3) - S1 HHH */

// The doubling (dbl-2009-l), slots 0-2 P, 3-4 scratch; 7 products.
// Results: X3 in 3, Y3 in 0, Z3 in 2.
#define G1_DBL_PROGRAM                                                        \
  {fql::SQR, 3, 0, 0},     /* A = X^2 */                                     \
  {fql::SQR, 4, 1, 0},     /* B = Y^2 */                                     \
  {fql::MUL, 2, 1, 2},     /* Y Z */                                         \
  {fql::ADD, 2, 2, 2},     /* Z3 = 2 Y Z */                                  \
  {fql::SQR, 1, 4, 0},     /* C = B^2 */                                     \
  {fql::ADD, 0, 0, 4},     /* X + B */                                       \
  {fql::SQR, 0, 0, 0},     /* (X + B)^2 */                                   \
  {fql::SUB, 0, 0, 3},                                                        \
  {fql::SUB, 0, 0, 1},     /* (X + B)^2 - A - C */                           \
  {fql::ADD, 0, 0, 0},     /* D */                                           \
  {fql::ADD, 4, 3, 3},                                                        \
  {fql::ADD, 4, 4, 3},     /* E = 3 A */                                     \
  {fql::SQR, 3, 4, 0},     /* F = E^2 */                                     \
  {fql::SUB, 3, 3, 0},                                                        \
  {fql::SUB, 3, 3, 0},     /* X3 = F - 2 D */                                \
  {fql::SUB, 0, 0, 3},     /* D - X3 */                                      \
  {fql::MUL, 0, 4, 0},     /* E (D - X3) */                                  \
  {fql::ADD, 1, 1, 1},                                                        \
  {fql::ADD, 1, 1, 1},                                                        \
  {fql::ADD, 1, 1, 1},     /* 8 C */                                         \
  {fql::SUB, 0, 0, 1}      /* Y3 = E (D - X3) - 8 C */

constexpr int ADD_SLOTS = 8, ADD_X3 = 7, ADD_Y3 = 0, ADD_Z3 = 2, ADD_H = 3, ADD_R = 4;
constexpr int DBL_SLOTS = 5, DBL_X3 = 3, DBL_Y3 = 0, DBL_Z3 = 2;

// Run steps [begin, end) of the program P (P(s) -> Step) on the slots S
// (S.load(fe&, slot), S.store(slot, const fe&)).  One loop, not unrolled:
// each op's code appears once.
template <class Slots, class Prog>
__device__ __forceinline__ void run(const Slots& S, const Prog& P, int begin, int end) {
#pragma unroll 1
  for (int s = begin; s < end; ++s) {
    const Step st = P(s);
    fe x, y, r;
    S.load(x, st.a);
    if (st.op == SQR) {
      sqr(r, x);
    } else {
      S.load(y, st.b);
      if (st.op == MUL) mul(r, x, y);
      else if (st.op == ADD) add(r, x, y);
      else sub(r, x, y);
    }
    S.store(st.d, r);
  }
}

}  // namespace fql
