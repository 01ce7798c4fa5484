// K5: the two halves of a batched complete affine add on BLS12-381 G1.
//
// Replaces, in tokamak_zk_evm_tpu/backend/pallas_kernels.py:
//   * `_aff_pre_fn` (1055-1092) -> aff_pre_kernel: the denominator of each
//     lane's slope, 2 y1 on doubling lanes, x2 - x1 on add lanes, Montgomery
//     one on bypass lanes (either operand infinite, or P + (-P));
//   * `_aff_post_fn` (1096-1153) -> aff_post_kernel: given the inverted
//     denominators, lambda, x3 = lambda^2 - x1 - x2,
//     y3 = lambda (x1 - x3) - y1, then the infinity and cancellation selects.
// Between the two, `g1_aff_add_batch` inverts every denominator with K2's
// batch inversion, so the whole batch shares one field inversion.  A point
// is (x, y) in [24, B] limb-major Montgomery form; (0, 0) is infinity.  The
// denominators are never zero: y != 0 on G1 (no 2-torsion), x2 != x1 on add
// lanes, and every other lane gets one.
//
// The TPU kernels ran over 8192-lane blocks in VMEM; here each thread owns one
// lane, with its four coordinates in registers.  Bound on the card: bytes.
// aff_pre reads four coordinates and writes one (480 B a lane) with no
// products; aff_post reads five and writes two (672 B) for four Fq
// Montgomery products, under the card's ops-per-byte balance.  Neighbouring
// threads read neighbouring addresses of every limb row (coalesced).
#include "field.cuh"

namespace {

using tzk::Fq;
constexpr int N = Fq::N;
typedef uint32_t fq[N];

// What both halves need of a lane: the operands, their differences and the
// case the lane falls in.
struct Lane {
  fq x1, y1, x2, y2, dx, dy;
  bool inf1, inf2, dbl, cancel;
};

__device__ __forceinline__ void classify(Lane& l, const int32_t* x1, const int32_t* y1,
                                         const int32_t* x2, const int32_t* y2,
                                         long long i, long long B) {
  tzk::load<Fq>(l.x1, x1, i, B);
  tzk::load<Fq>(l.y1, y1, i, B);
  tzk::load<Fq>(l.x2, x2, i, B);
  tzk::load<Fq>(l.y2, y2, i, B);
  l.inf1 = tzk::is_zero<Fq>(l.x1) && tzk::is_zero<Fq>(l.y1);
  l.inf2 = tzk::is_zero<Fq>(l.x2) && tzk::is_zero<Fq>(l.y2);
  tzk::sub<Fq>(l.dx, l.x2, l.x1);
  tzk::sub<Fq>(l.dy, l.y2, l.y1);
  bool xeq = tzk::is_zero<Fq>(l.dx), yeq = tzk::is_zero<Fq>(l.dy);
  bool live = !l.inf1 && !l.inf2;
  l.dbl = live && xeq && yeq;
  l.cancel = live && xeq && !yeq;
}

__global__ void aff_pre_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                               const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
                               int32_t* __restrict__ den, long long B) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Lane l;
  classify(l, x1, y1, x2, y2, i, B);
  fq d;
  if (l.inf1 || l.inf2 || l.cancel) {
    tzk::set_one<Fq>(d);
  } else if (l.dbl) {
    tzk::add<Fq>(d, l.y1, l.y1);
  } else {
    tzk::copy<Fq>(d, l.dx);
  }
  tzk::store<Fq>(den, i, B, d);
}

__global__ void aff_post_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                                const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
                                const int32_t* __restrict__ dinv, int32_t* __restrict__ ox,
                                int32_t* __restrict__ oy, long long B) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Lane l;
  classify(l, x1, y1, x2, y2, i, B);
  fq rx, ry;
  if (l.inf1) {
    tzk::copy<Fq>(rx, l.x2);
    tzk::copy<Fq>(ry, l.y2);
  } else if (l.inf2) {
    tzk::copy<Fq>(rx, l.x1);
    tzk::copy<Fq>(ry, l.y1);
  } else if (l.cancel) {
    tzk::set_zero<Fq>(rx);
    tzk::set_zero<Fq>(ry);
  } else {
    fq num, di, lam, t;
    if (l.dbl) {  // 3 x1^2
      tzk::mul<Fq>(t, l.x1, l.x1);
      tzk::add<Fq>(num, t, t);
      tzk::add<Fq>(num, num, t);
    } else {
      tzk::copy<Fq>(num, l.dy);
    }
    tzk::load<Fq>(di, dinv, i, B);
    tzk::mul<Fq>(lam, num, di);
    tzk::mul<Fq>(t, lam, lam);
    tzk::sub<Fq>(t, t, l.x1);
    tzk::sub<Fq>(rx, t, l.x2);
    tzk::sub<Fq>(t, l.x1, rx);
    tzk::mul<Fq>(t, lam, t);
    tzk::sub<Fq>(ry, t, l.y1);
  }
  tzk::store<Fq>(ox, i, B, rx);
  tzk::store<Fq>(oy, i, B, ry);
}

inline unsigned nblocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

}  // namespace

// den[i] = the slope denominator of lane i (see aff_pre_kernel).
extern "C" int tzk_aff_pre(const void* x1, const void* y1, const void* x2, const void* y2,
                           void* den, long long B, void* stream) {
  if (B <= 0) return 0;
  const int T = 128;
  aff_pre_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)x2, (const int32_t*)y2,
      (int32_t*)den, B);
  TZK_LAUNCH_CHECK();
}

// (ox, oy)[i] = (x1, y1)[i] + (x2, y2)[i], given dinv[i] = 1 / den[i].
extern "C" int tzk_aff_post(const void* x1, const void* y1, const void* x2, const void* y2,
                            const void* dinv, void* ox, void* oy, long long B, void* stream) {
  if (B <= 0) return 0;
  const int T = 128;
  aff_post_kernel<<<nblocks(B, T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)x2, (const int32_t*)y2,
      (const int32_t*)dinv, (int32_t*)ox, (int32_t*)oy, B);
  TZK_LAUNCH_CHECK();
}
