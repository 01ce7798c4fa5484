// K3: batched radix-2 NTT over Fr along the last axis of [16, batch, n].
//
// Replaces `_ntt_stage_fn` / `_bf_kernel` driven by `fr_ntt`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:585-689).  Contract, as
// there: natural order in and out, bit-reversal inside, radix-2 DIT stages
// with the twiddle table pows[j] = w^j, and the final scale always applied
// (Montgomery one for a forward transform, n^-1 for an inverse one).
//   1. bitrev_kernel copies data into out in bit-reversed order;
//   2. one stage_kernel launch per stage, in place on out, one thread per
//      butterfly; the last stage multiplies both outputs by the scale.
//
// Bound on the card: bytes.  Every stage reads and writes the whole grid
// (64 B per element) for one Montgomery product per butterfly, so a
// 16384 x 512 grid moves ~15 x 1 GB.  Fusing stages in shared memory is the
// next step; here the stride pattern keeps each warp's limb loads contiguous
// (consecutive threads take consecutive butterflies of one row).
#include "field.cuh"

namespace {

using tzk::Fr;

__global__ void bitrev_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                              long long total, long long n, int logn) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  long long row = e / n;
  unsigned j = (unsigned)(e - row * n);
  unsigned r = __brev(j) >> (32 - logn);
  long long dst = row * n + r;
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k * total + dst] = __ldg(in + k * total + e);
}

__global__ void stage_kernel(int32_t* __restrict__ x, const int32_t* __restrict__ pows,
                             const int32_t* __restrict__ scale, long long total,
                             long long n, long long m, int last) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long half = total >> 1;
  if (t >= half) return;
  long long nh = n >> 1;
  long long row = t / nh;
  long long j = t - row * nh;
  long long grp = j / m;
  long long pos = j - grp * m;
  long long i0 = row * n + grp * 2 * m + pos;
  long long i1 = i0 + m;
  uint32_t lo[8], hi[8], w[8];
  tzk::load<Fr>(lo, x, i0, total);
  tzk::load<Fr>(hi, x, i1, total);
  tzk::load<Fr>(w, pows, pos * (n / (2 * m)), n);
  tzk::mul<Fr>(hi, hi, w);
  uint32_t a[8], b[8];
  tzk::add<Fr>(a, lo, hi);
  tzk::sub<Fr>(b, lo, hi);
  if (last) {
    uint32_t s[8];
    tzk::load<Fr>(s, scale, 0, 1);
    tzk::mul<Fr>(a, a, s);
    tzk::mul<Fr>(b, b, s);
  }
  tzk::store<Fr>(x, i0, total, a);
  tzk::store<Fr>(x, i1, total, b);
}

}  // namespace

// data, out: [16, batch * n] (distinct buffers); pows [16, n]; scale [16, 1].
extern "C" int tzk_ntt(const void* data, void* out, const void* pows, const void* scale,
                       long long batch, long long n, void* stream) {
  long long total = batch * n;
  if (total <= 0 || n < 2) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int logn = 0;
  while ((1ll << logn) < n) ++logn;
  const int T = 256;
  bitrev_kernel<<<(unsigned)((total + T - 1) / T), T, 0, s>>>(
      (const int32_t*)data, (int32_t*)out, total, n, logn);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long half = total >> 1;
  for (long long m = 1; m < n; m <<= 1) {
    int last = (2 * m == n) ? 1 : 0;
    stage_kernel<<<(unsigned)((half + T - 1) / T), T, 0, s>>>(
        (int32_t*)out, (const int32_t*)pows, (const int32_t*)scale, total, n, m, last);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
