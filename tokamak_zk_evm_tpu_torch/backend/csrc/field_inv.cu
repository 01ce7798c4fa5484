// K2: Fermat inversion and Montgomery batch inversion, Fr and Fq; 0 -> 0.
//
// Replaces `_inv_fn` (per-element a^(p-2) with the exponent bits in SMEM) and
// the batch-inversion pair `_binv_fwd_fn` / `_binv_bwd_fn`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:382-563).  The TPU walks
// K=16 groups laid out across its lanes and carries nothing between grid
// steps; here one thread owns one contiguous chunk of `chunk` elements:
//   fwd: exclusive prefix products inside the chunk (zeros skipped) -> pre,
//        and the chunk total -> tot;
//   the caller inverts tot (recursively, or with the Fermat kernel once it is
//        small);
//   bwd: walk the chunk back from its inverted total.
// No order is carried between blocks, so any chunk count runs in one launch.
//
// Bound on the card: operations for the Fermat kernel (~2 x 255 Montgomery
// products per element); bytes for the chunk passes (3 muls per element
// against 4 element reads/writes).  The exponent lives in constant memory,
// read uniformly by the warp.
#include "field.cuh"

namespace {

template <class F>
__global__ void inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                           long long B) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t x[F::N], r[F::N];
  tzk::load<F>(x, a, i, B);
  tzk::inv<F>(r, x);
  tzk::store<F>(out, i, B, r);
}

template <class F>
__global__ void binv_fwd(const int32_t* __restrict__ a, int32_t* __restrict__ pre,
                         int32_t* __restrict__ tot, long long B, int chunk,
                         long long nchunks) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  long long lo = c * chunk;
  long long hi = lo + chunk < B ? lo + chunk : B;
  uint32_t acc[F::N];
  tzk::set_one<F>(acc);
  for (long long i = lo; i < hi; ++i) {
    uint32_t x[F::N];
    tzk::load<F>(x, a, i, B);
    tzk::store<F>(pre, i, B, acc);
    if (!tzk::is_zero<F>(x)) tzk::mul<F>(acc, acc, x);
  }
  tzk::store<F>(tot, c, nchunks, acc);
}

template <class F>
__global__ void binv_bwd(const int32_t* __restrict__ a, const int32_t* __restrict__ pre,
                         const int32_t* __restrict__ tinv, int32_t* __restrict__ out,
                         long long B, int chunk, long long nchunks) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  long long lo = c * chunk;
  long long hi = lo + chunk < B ? lo + chunk : B;
  uint32_t inv[F::N];
  tzk::load<F>(inv, tinv, c, nchunks);
  for (long long i = hi - 1; i >= lo; --i) {
    uint32_t x[F::N], p[F::N], o[F::N];
    tzk::load<F>(x, a, i, B);
    if (tzk::is_zero<F>(x)) {
      tzk::set_zero<F>(o);
    } else {
      tzk::load<F>(p, pre, i, B);
      tzk::mul<F>(o, p, inv);
      tzk::mul<F>(inv, inv, x);
    }
    tzk::store<F>(out, i, B, o);
  }
}

inline unsigned nblocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

}  // namespace

extern "C" int tzk_field_inv(int field, const void* a, void* out, long long B,
                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 128;
  if (field == 0)
    inv_kernel<tzk::Fr><<<nblocks(B, T), T, 0, s>>>((const int32_t*)a, (int32_t*)out, B);
  else
    inv_kernel<tzk::Fq><<<nblocks(B, T), T, 0, s>>>((const int32_t*)a, (int32_t*)out, B);
  TZK_LAUNCH_CHECK();
}

extern "C" int tzk_batch_inv_fwd(int field, const void* a, void* pre, void* tot,
                                 long long B, int chunk, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long nch = (B + chunk - 1) / chunk;
  const int T = 128;
  if (field == 0)
    binv_fwd<tzk::Fr><<<nblocks(nch, T), T, 0, s>>>(
        (const int32_t*)a, (int32_t*)pre, (int32_t*)tot, B, chunk, nch);
  else
    binv_fwd<tzk::Fq><<<nblocks(nch, T), T, 0, s>>>(
        (const int32_t*)a, (int32_t*)pre, (int32_t*)tot, B, chunk, nch);
  TZK_LAUNCH_CHECK();
}

extern "C" int tzk_batch_inv_bwd(int field, const void* a, const void* pre,
                                 const void* tinv, void* out, long long B, int chunk,
                                 void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long nch = (B + chunk - 1) / chunk;
  const int T = 128;
  if (field == 0)
    binv_bwd<tzk::Fr><<<nblocks(nch, T), T, 0, s>>>(
        (const int32_t*)a, (const int32_t*)pre, (const int32_t*)tinv, (int32_t*)out, B,
        chunk, nch);
  else
    binv_bwd<tzk::Fq><<<nblocks(nch, T), T, 0, s>>>(
        (const int32_t*)a, (const int32_t*)pre, (const int32_t*)tinv, (int32_t*)out, B,
        chunk, nch);
  TZK_LAUNCH_CHECK();
}
