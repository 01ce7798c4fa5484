// BLS12-381 Fq Montgomery arithmetic on PTX carry chains, and the complete
// G1 jacobian formulas over it: the arithmetic of K4's kernels (msm.cu, and
// g1.cu's fixed-base kernel) and of K2's Fq inversions (field_inv.cu).
// fr_chain.cuh builds K2's, B6's and K3's Fr arithmetic on its carry primitives;
// field.cuh stays the arithmetic of K1 and K5.
//
// Values are 12 little-endian 32-bit words, Montgomery form (R = 2^384),
// fully reduced into [0, q) after every operation, so results are
// byte-equal to field.cuh's and to the plain versions'.
//
// The product is CIOS: for each word b_i of b, t += a * b_i and then
// t += m * q with m = t_0 * n0, each as two carry chains (the low halves
// of the 32 x 32-bit products into t_j, the high halves into t_(j+1)) of
// mad.lo.cc / madc.lo.cc / madc.hi.cc, so a carry costs no extra
// instruction.  q < 2^381 keeps t + a b_i + m q below 2^416, so 13 words
// hold every intermediate and the final reduction is one conditional
// subtract.  Every function is __forceinline__ and works on register
// arrays indexed by unrolled constants only, so nothing goes to the stack.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fqc {

constexpr int N = 12;
constexpr uint32_t N0 = 0xfffcfffdu;  // -q^-1 mod 2^32
typedef uint32_t fe[N];

// Word k of q and of R mod q.  Called with unrolled constant k only, so each
// folds into an immediate operand (no constant-memory load, no local array).
__device__ __forceinline__ constexpr uint32_t qw(int k) {
  return k == 0 ? 0xffffaaabu : k == 1 ? 0xb9feffffu : k == 2 ? 0xb153ffffu
       : k == 3 ? 0x1eabfffeu : k == 4 ? 0xf6b0f624u : k == 5 ? 0x6730d2a0u
       : k == 6 ? 0xf38512bfu : k == 7 ? 0x64774b84u : k == 8 ? 0x434bacd7u
       : k == 9 ? 0x4b1ba7b6u : k == 10 ? 0x397fe69au : 0x1a0111eau;
}

__device__ __forceinline__ constexpr uint32_t qone(int k) {
  return k == 0 ? 0x0002fffdu : k == 1 ? 0x76090000u : k == 2 ? 0xc40c0002u
       : k == 3 ? 0xebf4000bu : k == 4 ? 0x53c758bau : k == 5 ? 0x5f489857u
       : k == 6 ? 0x70525745u : k == 7 ? 0x77ce5853u : k == 8 ? 0xa256ec6du
       : k == 9 ? 0x5c071a97u : k == 10 ? 0xfa80e493u : 0x15f65ec3u;
}

// --- carry-chain primitives (PTX; the carry flag runs from one to the next)
// carry-primitives-begin
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// carry-primitives-end

// --- field ---------------------------------------------------------------

__device__ __forceinline__ void set_one(fe& r) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = qone(k);
}

__device__ __forceinline__ void set_zero(fe& r) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = 0u;
}

__device__ __forceinline__ void copy(fe& r, const fe& a) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = a[k];
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  uint32_t acc = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) acc |= a[k];
  return acc == 0u;
}

// t < 2q -> t mod q
__device__ __forceinline__ void reduce_once(fe& t) {
  fe d;
  d[0] = sub_cc(t[0], qw(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = subc_cc(t[k], qw(k));
  uint32_t borrow = subc(0u, 0u);  // all ones when t < q
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = borrow ? t[k] : d[k];
}

__device__ __forceinline__ void add(fe& r, const fe& a, const fe& b) {
  fe t;
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) t[k] = addc_cc(a[k], b[k]);
  t[N - 1] = addc(a[N - 1], b[N - 1]);  // a + b < 2q < 2^384: no carry out
  reduce_once(t);
  copy(r, t);
}

__device__ __forceinline__ void sub(fe& r, const fe& a, const fe& b) {
  fe t;
  t[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) t[k] = subc_cc(a[k], b[k]);
  uint32_t mask = subc(0u, 0u);  // all ones when a < b: add q back
  r[0] = add_cc(t[0], qw(0) & mask);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r[k] = addc_cc(t[k], qw(k) & mask);
  r[N - 1] = addc(t[N - 1], qw(N - 1) & mask);
}

// a * b * R^-1 mod q for a, b < q
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
    // t += m * q, which clears t_0; then shift down one word
    const uint32_t m = t[0] * N0;
    t[0] = mad_lo_cc(m, qw(0), t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, qw(j), t[j]);
    t[N] = addc(t[N], 0u);
    t[1] = mad_hi_cc(m, qw(0), t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(m, qw(j), t[j + 1]);
    t[N] = madc_hi(m, qw(N - 1), t[N]);
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = t[j + 1];
    t[N] = 0u;
  }
  fe o;
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = t[k];
  reduce_once(o);
  copy(r, o);
}

__device__ __forceinline__ void sqr(fe& r, const fe& a) { mul(r, a, a); }

// --- G1 jacobian points (Z = 0 is infinity) ------------------------------

struct Pt {
  fe X, Y, Z;
};

__device__ __forceinline__ void set_inf(Pt& o) {
  set_one(o.X);
  set_one(o.Y);
  set_zero(o.Z);
}

__device__ __forceinline__ bool is_inf(const Pt& p) { return is_zero(p.Z); }

__device__ __forceinline__ void copy_pt(Pt& o, const Pt& p) {
  copy(o.X, p.X);
  copy(o.Y, p.Y);
  copy(o.Z, p.Z);
}

// p <- 2p (dbl-2009-l; Z3 = 2 Y1 Z1 sends Y = 0 or Z = 0 to infinity)
__device__ __forceinline__ void dbl(Pt& p) {
  fe A, B, C, D, E, t;
  sqr(A, p.X);
  sqr(B, p.Y);
  sqr(C, B);
  add(t, p.X, B);
  sqr(t, t);
  sub(t, t, A);
  sub(D, t, C);
  add(D, D, D);
  add(E, A, A);
  add(E, E, A);
  mul(p.Z, p.Y, p.Z);
  add(p.Z, p.Z, p.Z);
  sqr(t, E);
  add(A, D, D);
  sub(p.X, t, A);  // X3 = E^2 - 2 D
  sub(t, D, p.X);
  mul(t, E, t);
  add(C, C, C);
  add(C, C, C);
  add(C, C, C);
  sub(p.Y, t, C);  // Y3 = E (D - X3) - 8 C
}

// p <- p + (qx, qy), the affine point finite: complete (infinity, doubling,
// cancellation).  11 products on the generic path.
__device__ __forceinline__ void add_affine(Pt& p, const fe& qx, const fe& qy) {
  if (is_inf(p)) {
    copy(p.X, qx);
    copy(p.Y, qy);
    set_one(p.Z);
    return;
  }
  fe Z1Z1, H, R, t;
  sqr(Z1Z1, p.Z);
  mul(H, qx, Z1Z1);
  sub(H, H, p.X);  // H = U2 - X1
  mul(t, p.Z, Z1Z1);
  mul(R, qy, t);
  sub(R, R, p.Y);  // R = S2 - Y1
  if (is_zero(H)) {
    if (is_zero(R)) dbl(p);
    else set_inf(p);
    return;
  }
  fe HH, HHH, V;
  sqr(HH, H);
  mul(HHH, H, HH);
  mul(V, p.X, HH);
  mul(p.Z, p.Z, H);
  mul(p.Y, p.Y, HHH);  // Y1 HHH
  sqr(t, R);
  sub(t, t, HHH);
  sub(t, t, V);
  sub(p.X, t, V);  // X3 = R^2 - HHH - 2 V
  sub(t, V, p.X);
  mul(t, R, t);
  sub(p.Y, t, p.Y);  // Y3 = R (V - X3) - Y1 HHH
}

// p <- p + q, both jacobian: complete.  16 products on the generic path.
__device__ __forceinline__ void add_jac(Pt& p, const Pt& q) {
  if (is_inf(q)) return;
  if (is_inf(p)) {
    copy_pt(p, q);
    return;
  }
  fe Z1Z1, Z2Z2, U1, S1, H, R, t;
  sqr(Z1Z1, p.Z);
  sqr(Z2Z2, q.Z);
  mul(U1, p.X, Z2Z2);
  mul(H, q.X, Z1Z1);
  sub(H, H, U1);  // H = U2 - U1
  mul(t, q.Z, Z2Z2);
  mul(S1, p.Y, t);
  mul(t, p.Z, Z1Z1);
  mul(R, q.Y, t);
  sub(R, R, S1);  // R = S2 - S1
  if (is_zero(H)) {
    if (is_zero(R)) dbl(p);
    else set_inf(p);
    return;
  }
  fe HH, HHH;
  mul(p.Z, p.Z, q.Z);
  mul(p.Z, p.Z, H);  // Z3 = Z1 Z2 H
  sqr(HH, H);
  mul(HHH, H, HH);
  mul(U1, U1, HH);  // V = U1 HH
  mul(S1, S1, HHH);
  sqr(t, R);
  sub(t, t, HHH);
  sub(t, t, U1);
  sub(p.X, t, U1);  // X3 = R^2 - HHH - 2 V
  sub(t, U1, p.X);
  mul(t, R, t);
  sub(p.Y, t, S1);  // Y3 = R (V - X3) - S1 HHH
}

// --- point-major packed layout: 12 words a coordinate, 16-byte loads -----

__device__ __forceinline__ void load_fe(fe& r, const uint4* p) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    uint4 v = __ldg(p + k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store_fe(uint4* p, const fe& r) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) p[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// affine point i of a [n, 24]-word array (X then Y)
__device__ __forceinline__ void load_affine(fe& x, fe& y, const uint4* pts, long long i) {
  load_fe(x, pts + 6 * i);
  load_fe(y, pts + 6 * i + 3);
}

// jacobian point i of a [n, 36]-word array (X, Y, Z)
__device__ __forceinline__ void load_jac(Pt& p, const uint4* pts, long long i) {
  load_fe(p.X, pts + 9 * i);
  load_fe(p.Y, pts + 9 * i + 3);
  load_fe(p.Z, pts + 9 * i + 6);
}

__device__ __forceinline__ void store_jac(uint4* pts, long long i, const Pt& p) {
  store_fe(pts + 9 * i, p.X);
  store_fe(pts + 9 * i + 3, p.Y);
  store_fe(pts + 9 * i + 6, p.Z);
}

}  // namespace fqc
