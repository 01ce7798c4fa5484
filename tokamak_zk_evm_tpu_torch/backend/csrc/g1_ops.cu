// B13: the complete jacobian add, the doubling and the to-affine step of
// BLS12-381 G1 points, one kernel each, one thread a lane.
//
// Replaces `g1_add` (824), `g1_dbl` (810) and `g1_to_affine` (867) of
// tokamak_zk_evm_tpu/backend/pallas_kernels.py, which the JAX package
// composes from its Pallas field kernels (`_ew_binop_fn` 267): some 25
// elementwise launches an add and a host-side case split, where these run
// the whole formula in registers (fq_chain.cuh add_jac / dbl, 16 and 7 Fq
// products) and settle every case inside the kernel:
//
//   * add: P + P goes to the doubling, P + (-P) to infinity (1, 1, 0); an
//     infinite P gives Q as it is, else an infinite Q gives P as it is, the
//     same selects in the same order as the plain version (`backend/
//     kernels.py` jac_add), so every output word is equal to it, infinity's
//     representation included.  Q is broadcast as the K1 ops broadcast
//     their second operand: lane i reads Q at i when Bq == B, else at
//     (i / rep) % Bq;
//   * dbl: dbl-2009-l; an infinite P gives (1, 1, 0);
//   * to affine: the wrapper inverts Z with K2's batch inversion (0 -> 0),
//     then g1_affine_kernel writes x = X zi^2, y = Y zi^3 and inf = (Z == 0)
//     in one pass (infinity comes out as (0, 0, 1)).
//
// Bound on the card: operations for the add and the doubling (16 and 7
// products of ~600 operations against 864 and 576 bytes a lane), bytes for
// the to-affine pass (4 products against 580 bytes).  The design is the
// bucket sum's: the lanes' limb-major 16-bit limbs are joined into 32-bit
// words as they are loaded (coalesced, lane i at column i), the products run
// on PTX carry chains, every curve function is inlined (ptxas reports no
// stack frame and no spills) and, like msm.cu's jacobian pass, the add keeps
// two jacobian points live and runs two 128-thread blocks an SM, the
// doubling three.  Each kernel reads and writes each coordinate once.
#include "fq_chain.cuh"

namespace {

using fqc::Pt;

__device__ __forceinline__ void load_limbs(fqc::fe& r, const int32_t* __restrict__ p, long long i,
                                           long long B) {
#pragma unroll
  for (int k = 0; k < fqc::N; ++k)
    r[k] = ((uint32_t)__ldg(p + (2 * k) * B + i) & 0xFFFFu) |
           ((uint32_t)__ldg(p + (2 * k + 1) * B + i) << 16);
}

__device__ __forceinline__ void store_limbs(int32_t* p, long long i, long long B, const fqc::fe& x) {
#pragma unroll
  for (int k = 0; k < fqc::N; ++k) {
    p[(2 * k) * B + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * B + i] = (int32_t)(x[k] >> 16);
  }
}

__device__ __forceinline__ void load_pt(Pt& p, const int32_t* X, const int32_t* Y, const int32_t* Z,
                                        long long i, long long B) {
  load_limbs(p.X, X, i, B);
  load_limbs(p.Y, Y, i, B);
  load_limbs(p.Z, Z, i, B);
}

__device__ __forceinline__ void store_pt(int32_t* X, int32_t* Y, int32_t* Z, long long i, long long B,
                                         const Pt& p) {
  store_limbs(X, i, B, p.X);
  store_limbs(Y, i, B, p.Y);
  store_limbs(Z, i, B, p.Z);
}

__global__ void __launch_bounds__(128, 2)
g1_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
              const int32_t* __restrict__ y2, const int32_t* __restrict__ z2, long long Bq,
              long long rep, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Pt p, q;
  load_pt(p, x1, y1, z1, i, B);
  load_pt(q, x2, y2, z2, Bq == B ? i : (i / rep) % Bq, Bq);
  if (fqc::is_inf(p)) fqc::copy_pt(p, q);
  else fqc::add_jac(p, q);  // returns P as it is when Q is infinite
  store_pt(ox, oy, oz, i, B, p);
}

__global__ void __launch_bounds__(128, 3)
g1_dbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Pt p;
  load_pt(p, x, y, z, i, B);
  if (fqc::is_inf(p)) fqc::set_inf(p);
  else fqc::dbl(p);
  store_pt(ox, oy, oz, i, B, p);
}

__global__ void __launch_bounds__(128)
g1_affine_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, const int32_t* __restrict__ zinv, int32_t* ox,
                 int32_t* oy, int32_t* oinf, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fqc::fe zi, zi2, t, v;
  load_limbs(zi, zinv, i, B);
  fqc::sqr(zi2, zi);
  load_limbs(v, x, i, B);
  fqc::mul(t, v, zi2);
  store_limbs(ox, i, B, t);
  fqc::mul(zi2, zi2, zi);
  load_limbs(v, y, i, B);
  fqc::mul(t, v, zi2);
  store_limbs(oy, i, B, t);
  load_limbs(v, z, i, B);
  oinf[i] = fqc::is_zero(v) ? 1 : 0;
}

unsigned nblocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

}  // namespace

// out[i] = p[i] + q[Bq == B ? i : (i / rep) % Bq] for i < B; every pointer a
// limb-major [24, *] int32 array.
extern "C" int tzk_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, long long Bq, long long rep, void* ox,
                          void* oy, void* oz, long long B, void* stream) {
  if (B <= 0) return 0;
  if (Bq <= 0 || rep <= 0) return (int)cudaErrorInvalidValue;
  const int T = 128;
  g1_add_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, Bq, rep, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, B);
  return (int)cudaGetLastError();
}

extern "C" int tzk_g1_dbl(const void* x, const void* y, const void* z, void* ox, void* oy,
                          void* oz, long long B, void* stream) {
  if (B <= 0) return 0;
  const int T = 128;
  g1_dbl_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, B);
  return (int)cudaGetLastError();
}

// zinv: the batch inverse of z (0 -> 0); oinf: int32 [B].
extern "C" int tzk_g1_affine(const void* x, const void* y, const void* z, const void* zinv,
                             void* ox, void* oy, void* oinf, long long B, void* stream) {
  if (B <= 0) return 0;
  const int T = 128;
  g1_affine_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)zinv, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oinf, B);
  return (int)cudaGetLastError();
}
