// K4: BLS12-381 G1 over Fq -- complete jacobian arithmetic and the
// fixed-base kernel of trusted setup.  (The two device stages of the
// Pippenger MSM, and the complete jacobian add they use, are in msm.cu.)
//
// Replaces, in tokamak_zk_evm_tpu/backend/pallas_kernels.py:
//   * `_jac_add_fused_fn` / `_jac_add_block` (889-993): complete jacobian
//     arithmetic (add-2007-bl with dbl-2009-l and the infinity / double /
//     cancel cases) -> the __device__ functions jac_dbl / mixed_add below and
//     fq_chain.cuh's add_jac;
//   * `_fixed_base_apply_fn` (2177) behind `g1_fixed_base` (2159): 32 windows
//     of 8 bits against the host-built 32 x 256 affine table
//     -> fixed_base_kernel, one thread per scalar.
//
// Every add here is complete.  The TPU merge tree uses incomplete adds that
// assume distinct partial sums (1183-1191); repeated points and witness
// values break that assumption, so a doubling or a cancellation is handled
// wherever it can occur.
//
// Bound on the card: operations.  A mixed add is ~11 Fq Montgomery products
// (~150 32-bit multiply-adds each) against 96 B of point data, far above the
// card's ops-per-byte balance.  Design response: one point per thread with
// all coordinates in registers; loads are coalesced across the limb rows.
#include "field.cuh"

namespace {

using tzk::Fq;
constexpr int N = Fq::N;
typedef uint32_t fq[N];

struct Pt {
  fq X, Y, Z;
};

__device__ __forceinline__ void set_inf(Pt& o) {
  tzk::set_one<Fq>(o.X);
  tzk::set_one<Fq>(o.Y);
  tzk::set_zero<Fq>(o.Z);
}

__device__ __forceinline__ bool is_inf(const Pt& p) { return tzk::is_zero<Fq>(p.Z); }

__device__ __forceinline__ void copy_pt(Pt& o, const Pt& p) {
  tzk::copy<Fq>(o.X, p.X);
  tzk::copy<Fq>(o.Y, p.Y);
  tzk::copy<Fq>(o.Z, p.Z);
}

// dbl-2009-l; Z3 = 2*Y1*Z1 sends Y = 0 or Z = 0 to infinity.
__device__ __noinline__ void jac_dbl(Pt& o, const Pt& p) {
  fq A, B, C, D, E, F, t, D2, C8, YZ;
  tzk::mul<Fq>(A, p.X, p.X);
  tzk::mul<Fq>(B, p.Y, p.Y);
  tzk::mul<Fq>(C, B, B);
  tzk::add<Fq>(t, p.X, B);
  tzk::mul<Fq>(t, t, t);
  tzk::sub<Fq>(t, t, A);
  tzk::sub<Fq>(D, t, C);
  tzk::add<Fq>(D, D, D);
  tzk::add<Fq>(E, A, A);
  tzk::add<Fq>(E, E, A);
  tzk::mul<Fq>(F, E, E);
  Pt r;
  tzk::add<Fq>(D2, D, D);
  tzk::sub<Fq>(r.X, F, D2);
  tzk::add<Fq>(C8, C, C);
  tzk::add<Fq>(C8, C8, C8);
  tzk::add<Fq>(C8, C8, C8);
  tzk::sub<Fq>(t, D, r.X);
  tzk::mul<Fq>(t, E, t);
  tzk::sub<Fq>(r.Y, t, C8);
  tzk::mul<Fq>(YZ, p.Y, p.Z);
  tzk::add<Fq>(r.Z, YZ, YZ);
  copy_pt(o, r);
}

// complete mixed add: p jacobian, (qx, qy) affine and finite
__device__ __noinline__ void mixed_add(Pt& o, const Pt& p, const fq& qx, const fq& qy) {
  if (is_inf(p)) {
    tzk::copy<Fq>(o.X, qx);
    tzk::copy<Fq>(o.Y, qy);
    tzk::set_one<Fq>(o.Z);
    return;
  }
  fq Z1Z1, U2, S2, H, R, t;
  tzk::mul<Fq>(Z1Z1, p.Z, p.Z);
  tzk::mul<Fq>(U2, qx, Z1Z1);
  tzk::mul<Fq>(t, p.Z, Z1Z1);
  tzk::mul<Fq>(S2, qy, t);
  tzk::sub<Fq>(H, U2, p.X);
  tzk::sub<Fq>(R, S2, p.Y);
  if (tzk::is_zero<Fq>(H)) {
    if (tzk::is_zero<Fq>(R)) jac_dbl(o, p);
    else set_inf(o);
    return;
  }
  fq HH, HHH, V, RR, V2, YH3;
  tzk::mul<Fq>(HH, H, H);
  tzk::mul<Fq>(HHH, H, HH);
  tzk::mul<Fq>(V, p.X, HH);
  tzk::mul<Fq>(RR, R, R);
  Pt r;
  tzk::add<Fq>(V2, V, V);
  tzk::sub<Fq>(t, RR, HHH);
  tzk::sub<Fq>(r.X, t, V2);
  tzk::sub<Fq>(t, V, r.X);
  tzk::mul<Fq>(t, R, t);
  tzk::mul<Fq>(YH3, p.Y, HHH);
  tzk::sub<Fq>(r.Y, t, YH3);
  tzk::mul<Fq>(r.Z, p.Z, H);
  copy_pt(o, r);
}

__device__ __forceinline__ void store_pt(int32_t* x, int32_t* y, int32_t* z, long long i,
                                         long long stride, const Pt& p) {
  tzk::store<Fq>(x, i, stride, p.X);
  tzk::store<Fq>(y, i, stride, p.Y);
  tzk::store<Fq>(z, i, stride, p.Z);
}

// out[i] = k_i * G from the [24, 32*256] affine window table (entry wi*256+d
// holds d * 2^(8 wi) * G); scalars canonical [16, B].
__global__ void fixed_base_kernel(const int32_t* __restrict__ sc, const int32_t* __restrict__ tx,
                                  const int32_t* __restrict__ ty,
                                  const int32_t* __restrict__ tinf, int32_t* ox, int32_t* oy,
                                  int32_t* oz, long long B) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long TS = 32 * 256;
  Pt acc;
  set_inf(acc);
  for (int wi = 0; wi < 32; ++wi) {
    uint32_t limb = (uint32_t)__ldg(sc + (wi >> 1) * B + i);
    uint32_t d = (limb >> (8 * (wi & 1))) & 0xFFu;
    if (d == 0u) continue;
    long long e = (long long)wi * 256 + d;
    if (__ldg(tinf + e)) continue;
    fq qx, qy;
    tzk::load<Fq>(qx, tx, e, TS);
    tzk::load<Fq>(qy, ty, e, TS);
    mixed_add(acc, acc, qx, qy);
  }
  store_pt(ox, oy, oz, i, B, acc);
}

inline unsigned nblocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

}  // namespace

extern "C" int tzk_g1_fixed_base(const void* scalars, const void* tx, const void* ty,
                                 const void* tinf, void* ox, void* oy, void* oz, long long B,
                                 void* stream) {
  if (B <= 0) return 0;
  const int T = 128;
  fixed_base_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scalars, (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tinf,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, B);
  TZK_LAUNCH_CHECK();
}
