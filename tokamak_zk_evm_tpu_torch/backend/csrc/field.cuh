// BLS12-381 Fr / Fq Montgomery arithmetic of K1 (field_ew.cu) and K5
// (g1_affine.cu): a generic CIOS product on 64-bit integers, one template
// over the field.  K2, K3 and K4 use the carry-chain arithmetic of
// fr_chain.cuh and fq_chain.cuh instead.
//
// Interchange layout (shared with the JAX package and the plain PyTorch
// versions): an array of B field elements is limb-major int32 [L, B] holding
// little-endian 16-bit limbs, L = 16 (Fr) or 24 (Fq), Montgomery form with
// R = 2^256 (Fr) / 2^384 (Fq).  Inside a thread two adjacent 16-bit limbs
// make one 32-bit word (8 words for Fr, 12 for Fq): R is unchanged, only the
// per-word Montgomery constant becomes n0 = -p^-1 mod 2^32.  Every result is
// fully reduced into [0, p), so kernel output is byte-equal to the JAX
// backends' (`_cond_sub_top` in the Pallas kernels guarantees the same).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tzk {

static __constant__ uint32_t FR_MOD[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
static __constant__ uint32_t FQ_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t N0 = 0xffffffffu;
  __device__ __forceinline__ static uint32_t p(int i) { return FR_MOD[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FR_ONE[i]; }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr uint32_t N0 = 0xfffcfffdu;
  __device__ __forceinline__ static uint32_t p(int i) { return FQ_MOD[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FQ_ONE[i]; }
};

// element i of a limb-major [2N, stride] int32 array -> N words
template <class F>
__device__ __forceinline__ void load(uint32_t (&r)[F::N], const int32_t* p,
                                     long long i, long long stride) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint32_t lo = (uint32_t)__ldg(p + (2 * k) * stride + i) & 0xFFFFu;
    uint32_t hi = (uint32_t)__ldg(p + (2 * k + 1) * stride + i) & 0xFFFFu;
    r[k] = lo | (hi << 16);
  }
}

template <class F>
__device__ __forceinline__ void store(int32_t* p, long long i, long long stride,
                                      const uint32_t (&r)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    p[(2 * k) * stride + i] = (int32_t)(r[k] & 0xFFFFu);
    p[(2 * k + 1) * stride + i] = (int32_t)(r[k] >> 16);
  }
}

template <class F>
__device__ __forceinline__ void set_one(uint32_t (&r)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) r[k] = F::one(k);
}

template <class F>
__device__ __forceinline__ void set_zero(uint32_t (&r)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) r[k] = 0u;
}

template <class F>
__device__ __forceinline__ void copy(uint32_t (&r)[F::N], const uint32_t (&a)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) r[k] = a[k];
}

template <class F>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[F::N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) acc |= a[k];
  return acc == 0u;
}

// t (N words plus a carry word `top`) -> t mod p, given t < 2p
template <class F>
__device__ __forceinline__ void cond_sub(uint32_t (&t)[F::N], uint32_t top) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)t[k] - F::p(k) - borrow;
    d[k] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool take = top != 0u || borrow == 0u;
#pragma unroll
  for (int k = 0; k < F::N; ++k) t[k] = take ? d[k] : t[k];
}

template <class F>
__device__ __forceinline__ void add(uint32_t (&r)[F::N], const uint32_t (&a)[F::N],
                                    const uint32_t (&b)[F::N]) {
  uint32_t t[F::N];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)a[k] + b[k] + c;
    t[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  cond_sub<F>(t, c);
  copy<F>(r, t);
}

template <class F>
__device__ __forceinline__ void sub(uint32_t (&r)[F::N], const uint32_t (&a)[F::N],
                                    const uint32_t (&b)[F::N]) {
  uint32_t t[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)a[k] - b[k] - borrow;
    t[k] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t mask = 0u - borrow;  // add p back when a < b
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)t[k] + (F::p(k) & mask) + c;
    r[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

template <class F>
__device__ __forceinline__ void neg(uint32_t (&r)[F::N], const uint32_t (&a)[F::N]) {
  bool z = is_zero<F>(a);
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)F::p(k) - a[k] - borrow;
    r[k] = z ? 0u : (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
}

// CIOS Montgomery product a*b*R^-1 mod p; exact for a < R, b < p.
template <class F>
__device__ __forceinline__ void mul(uint32_t (&r)[F::N], const uint32_t (&a)[F::N],
                                    const uint32_t (&b)[F::N]) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + C;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::N0;
    s = (uint64_t)m * F::p(0) + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[N] + C;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  uint32_t o[N];
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = t[k];
  cond_sub<F>(o, t[N]);
  copy<F>(r, o);
}

}  // namespace tzk

#define TZK_LAUNCH_CHECK() return (int)cudaGetLastError()
