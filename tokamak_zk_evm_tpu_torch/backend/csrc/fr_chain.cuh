// BLS12-381 Fr Montgomery arithmetic on PTX carry chains, for K3's NTT
// (ntt.cu), K2's Fr inversions (field_inv.cu) and B6's scan (fr_scan.cu,
// on `mul_wide`).
// The same scheme as fq_chain.cuh's Fq arithmetic, whose carry primitives
// it uses, over 8 words:
//
// Values are 8 little-endian 32-bit words, Montgomery form (R = 2^256),
// fully reduced into [0, r) after every operation, so results are
// byte-equal to field.cuh's and to the plain versions'.  The product is CIOS
// with each a * b_i and m * r as two carry chains (the low halves of the
// 32 x 32-bit products into t_j, the high halves into t_(j+1)); r < 2^255
// (top word 0x73eda753 < 2^31 - 1) keeps every intermediate in 9 words, so
// the final reduction is one conditional subtract.  n0 = -r^-1 mod 2^32 is
// 0xffffffff, so m = -t_0.  Every function is __forceinline__ and indexes
// its register arrays with unrolled constants only.
#pragma once

#include "fq_chain.cuh"

namespace frc {

using fqc::add_cc;
using fqc::addc;
using fqc::addc_cc;
using fqc::mad_hi_cc;
using fqc::mad_lo_cc;
using fqc::madc_hi;
using fqc::madc_hi_cc;
using fqc::madc_lo_cc;
using fqc::sub_cc;
using fqc::subc;
using fqc::subc_cc;

constexpr int N = 8;
typedef uint32_t fe[N];

// Word k of r, for unrolled constant k (folds into an immediate operand).
__device__ __forceinline__ constexpr uint32_t rw(int k) {
  return k == 0 ? 0x00000001u : k == 1 ? 0xffffffffu : k == 2 ? 0xfffe5bfeu
       : k == 3 ? 0x53bda402u : k == 4 ? 0x09a1d805u : k == 5 ? 0x3339d808u
       : k == 6 ? 0x299d7d48u : 0x73eda753u;
}

// t < 2r -> t mod r
__device__ __forceinline__ void reduce_once(fe& t) {
  fe d;
  d[0] = sub_cc(t[0], rw(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = subc_cc(t[k], rw(k));
  uint32_t borrow = subc(0u, 0u);  // all ones when t < r
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = borrow ? t[k] : d[k];
}

__device__ __forceinline__ void add(fe& r, const fe& a, const fe& b) {
  fe t;
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) t[k] = addc_cc(a[k], b[k]);
  t[N - 1] = addc(a[N - 1], b[N - 1]);  // a + b < 2r < 2^256: no carry out
  reduce_once(t);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = t[k];
}

__device__ __forceinline__ void sub(fe& r, const fe& a, const fe& b) {
  fe t;
  t[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) t[k] = subc_cc(a[k], b[k]);
  uint32_t mask = subc(0u, 0u);  // all ones when a < b: add r back
  r[0] = add_cc(t[0], rw(0) & mask);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(t[k], rw(k) & mask);
  r[N - 1] = addc(t[N - 1], rw(N - 1) & mask);
}

// a * b * R^-1 mod r for a, b < r
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  uint32_t t[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b[i];
    // t += a * b_i
    t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
    t[N] = addc(t[N], 0u);
    t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
    t[N] = madc_hi(a[N - 1], bi, t[N]);
    // t += m * r with m = -t_0 (n0 = -1), which clears t_0; shift down
    const uint32_t m = 0u - t[0];
    t[0] = mad_lo_cc(m, rw(0), t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, rw(j), t[j]);
    t[N] = addc(t[N], 0u);
    t[1] = mad_hi_cc(m, rw(0), t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(m, rw(j), t[j + 1]);
    t[N] = madc_hi(m, rw(N - 1), t[N]);
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = t[j + 1];
    t[N] = 0u;
  }
  fe o;
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = t[k];
  reduce_once(o);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = o[k];
}

// One CIOS row of `mul_wide` on the split partial sum (g1_lazy.cuh's `row`
// at 8 words).  On entry E and O hold V = (E >> 32) + O (E[0] = 0); adds
// a * bi, then m r with m = -O[0] (n0 = -1) clearing the lowest word; on
// return O (lowest word 0) and E hold (V + a bi + m r) / 2^32 as
// (O >> 32) + E, so the next row is row(O, E, ...).
__device__ __forceinline__ void row(uint32_t* E, uint32_t* O, const fe& a, uint32_t bi) {
  O[0] = add_cc(O[0], E[1]);
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    E[j] = madc_lo_cc(a[j + 1], bi, E[j + 2]);
    E[j + 1] = madc_hi_cc(a[j + 1], bi, E[j + 3]);
  }
  E[N - 2] = madc_lo_cc(a[N - 1], bi, 0u);
  E[N - 1] = madc_hi(a[N - 1], bi, 0u);
  O[0] = mad_lo_cc(a[0], bi, O[0]);
  O[1] = madc_hi_cc(a[0], bi, O[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    O[j] = madc_lo_cc(a[j], bi, O[j]);
    O[j + 1] = madc_hi_cc(a[j], bi, O[j + 1]);
  }
  E[N - 1] = addc(E[N - 1], 0u);
  const uint32_t m = 0u - O[0];
  E[0] = mad_lo_cc(m, rw(1), E[0]);
  E[1] = madc_hi_cc(m, rw(1), E[1]);
#pragma unroll
  for (int j = 2; j < N - 2; j += 2) {
    E[j] = madc_lo_cc(m, rw(j + 1), E[j]);
    E[j + 1] = madc_hi_cc(m, rw(j + 1), E[j + 1]);
  }
  E[N - 2] = madc_lo_cc(m, rw(N - 1), E[N - 2]);
  E[N - 1] = madc_hi(m, rw(N - 1), E[N - 1]);
  O[0] = mad_lo_cc(m, rw(0), O[0]);
  O[1] = madc_hi_cc(m, rw(0), O[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    O[j] = madc_lo_cc(m, rw(j), O[j]);
    O[j + 1] = madc_hi_cc(m, rw(j), O[j + 1]);
  }
  E[N - 1] = addc(E[N - 1], 0u);
}

// a * b * R^-1 mod r for a, b < r, the bytes of `mul`: CIOS with the partial
// sums split into an even and an odd half (the words of a * b_i at even and
// at odd j go to two arrays), so each row is two carry chains whose (lo, hi)
// pairs sit side by side and ptxas fuses each pair into one
// IMAD.WIDE.U32.X.  No word overflows: the top word of E takes at most
// hi(a_7 b_i) + hi(m r_7) + 4 carries <= 2 r_7 + 2 < 2^32, as a < r keeps
// a_7 <= r_7 = 0x73eda753; the sum stays below 2r, so one conditional
// subtract ends it.
__device__ __forceinline__ void mul_wide(fe& r, const fe& a, const fe& b) {
  uint32_t ev[N], od[N];
#pragma unroll
  for (int k = 0; k < N; ++k) ev[k] = od[k] = 0u;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    row(ev, od, a, b[i]);
    row(od, ev, a, b[i + 1]);
  }
  fe t;
  t[0] = add_cc(od[0], ev[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) t[k] = addc_cc(od[k], ev[k + 1]);
  t[N - 1] = addc(od[N - 1], 0u);
  reduce_once(t);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = t[k];
}

}  // namespace frc
