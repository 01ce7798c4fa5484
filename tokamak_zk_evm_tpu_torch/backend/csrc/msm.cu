// K4 MSM stages: the device half of a Pippenger MSM over BLS12-381 G1.
//
// Replaces, in tokamak_zk_evm_tpu/backend/pallas_kernels.py, the packed MSM
// merge tree `_pk_fwd_fn` (1254), `_pk_bwd_fn` (1294) and its jacobian add
// `_pk_jac_add_fn` (1408), with the weighted bucket tail (1547), by a
// Pippenger of its own design: the digits and the per-window stable sort
// are tensor ops in the wrapper (`backend/kernels.py`), bucket_sum_kernel
// sums each bucket's sorted points, window_reduce_kernel forms
// sum_b b * B_b per window, and the host finishes with a Horner combine as
// `g1_msm_finish` does (2042-2103).
//
// Every add is complete (fq_chain.cuh): the TPU merge tree's incomplete adds
// assume distinct partial sums (1183-1191), and repeated points and small
// witness scalars that pile into one bucket break that assumption.
//
// Bound on the card: operations.  A mixed add is 11 Fq products of ~300
// 32-bit multiply-adds against 96 B of point data, far above the card's
// ops-per-byte balance, so the design keeps the arithmetic in registers
// and every thread busy:
//
//   * Layout.  Points are point-major 32-bit words (the wrapper packs the
//     limb-major interchange layout once per MSM): an affine point is 24
//     words (X then Y, 96 B), a jacobian one 36 (144 B), so one gather is
//     six or nine 16-byte loads of whole sectors.  Partials and bucket sums
//     stay in that layout, so every pass reads contiguous points.
//   * Registers.  Fq products run on PTX carry chains; every curve function
//     is inlined into the kernel and indexes its arrays with unrolled
//     constants only, and ptxas reports no stack frame and no spills.  The
//     chains are serial, so the kernels are latency-bound and want warps:
//     the affine pass (the hot one) fits in 168 registers, three 128-thread
//     blocks an SM (__launch_bounds__(128, 3)), faster than two or four;
//     the jacobian pass and the window reduce, with two or three
//     jacobian points live, spill at 168 and keep two blocks (255).
//   * Balanced warps.  bucket_sum_kernel takes chunks of at most 32 sorted
//     entries of one bucket; the wrapper hands the chunks to threads in
//     order of decreasing length, so a warp's 32 threads run chunks of
//     nearly equal length on a uniform draw and on a skewed one alike (a
//     hot bucket is many full chunks).  The plan has already dropped
//     entries of infinite points and zero digits, so no entry is skipped.
//   * The window reduce fills the card without a double-and-add.  A thread
//     owns a segment of `seg` consecutive buckets (16 on the main path: 2^16
//     threads for 16 windows x 2^16 buckets, two waves of the card's
//     resident blocks, and one level fewer above than 8 would leave) and
//     forms, by a descending
//     running sum, R = sum (b - lo) B_b and S = sum B_b.  Since lo = s seg,
//     sum_b b B_b = sum_s R_s + sum_s s (seg S_s): the same problem again on
//     the segment totals scaled by seg (log2 seg doublings of S per thread),
//     plus the R's with weight one.  The wrapper launches the kernel again on
//     the scaled totals, and each level adds the level below's R of its
//     segments into its own R, so the last level, one segment a window,
//     leaves sum_b b B_b.  No thread multiplies by a segment's base digit.
//     The levels above the first hold few points and wait on one thread's
//     chain of dependent adds, so they take 2 totals a thread: more, shorter
//     levels (`chip_smoke.py` phase 6 times 16/2 beside 8/2).
//   * Buckets are read sparse: the sorted bucket sums with their keys and,
//     per segment, the offset of its first entry; no dense bucket array.
#include "fq_chain.cuh"

namespace {

using fqc::Pt;

// Chunk order[t] sums entries [start, start + len) of the finite affine
// points idx[e] of `pts` ([n, 24] words) into jacobian point order[t] of
// `out`.  The hot pass (one entry per point and window): three blocks an SM.
__global__ void __launch_bounds__(128, 3)
bucket_sum_kernel_affine(const uint4* __restrict__ pts, const long long* __restrict__ idx,
                         const long long* __restrict__ start, const long long* __restrict__ len,
                         const long long* __restrict__ order, long long nchunks, uint4* out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nchunks) return;
  const long long c = order[t];
  const long long lo = start[c];
  const long long hi = lo + len[c];
  Pt acc;
  fqc::load_affine(acc.X, acc.Y, pts, idx[lo]);
  fqc::set_one(acc.Z);
  for (long long e = lo + 1; e < hi; ++e) {
    fqc::fe qx, qy;
    fqc::load_affine(qx, qy, pts, idx[e]);
    fqc::add_affine(acc, qx, qy);
  }
  fqc::store_jac(out, c, acc);
}

// The same over the jacobian points e of `pts` ([n, 36] words): the passes
// over chunk partials, whose two jacobian operands need more registers.
__global__ void __launch_bounds__(128, 2)
bucket_sum_kernel_jacobian(const uint4* __restrict__ pts, const long long* __restrict__ start,
                           const long long* __restrict__ len,
                           const long long* __restrict__ order, long long nchunks, uint4* out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nchunks) return;
  const long long c = order[t];
  const long long lo = start[c];
  const long long hi = lo + len[c];
  Pt acc;
  fqc::load_jac(acc, pts, lo);
  for (long long e = lo + 1; e < hi; ++e) {
    Pt q;
    fqc::load_jac(q, pts, e);
    fqc::add_jac(acc, q);
  }
  fqc::store_jac(out, c, acc);
}

// Segment t covers keys [t * seg, (t + 1) * seg) (key = window * nb + digit,
// seg divides nb); its bucket sums are entries [off[t], off[t + 1]) of
// (keys, sums), keys ascending.  Writes
//   R[t] = sum_e rsum[e] + sum_b (b - t * seg) B_b  (rsum when given),
//   S[t] = 2^shift * sum_b B_b.
__global__ void __launch_bounds__(128, 2)
window_reduce_kernel(const uint4* __restrict__ sums, const uint4* __restrict__ rsum,
                     const long long* __restrict__ keys, const long long* __restrict__ off,
                     long long nseg, int seg, int shift, uint4* out_r, uint4* out_s) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nseg) return;
  const long long base = t * seg;
  const long long e0 = off[t];
  const long long e1 = off[t + 1];
  long long e = e1 - 1;
  Pt run, tot, q;
  fqc::set_inf(run);
  fqc::set_inf(tot);
  for (int r = seg - 1; r >= 1; --r) {
    if (e >= e0 && keys[e] == base + r) {
      fqc::load_jac(q, sums, e);
      fqc::add_jac(run, q);
      --e;
    }
    fqc::add_jac(tot, run);
  }
  if (e >= e0) {  // digit base itself: weight 0 in R, still part of S
    fqc::load_jac(q, sums, e);
    fqc::add_jac(run, q);
  }
  for (int k = 0; k < shift; ++k) fqc::dbl(run);
  fqc::store_jac(out_s, t, run);
  if (rsum != nullptr) {
    for (long long f = e0; f < e1; ++f) {
      fqc::load_jac(q, rsum, f);
      fqc::add_jac(tot, q);
    }
  }
  fqc::store_jac(out_r, t, tot);
}

inline unsigned nblocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

}  // namespace

extern "C" int tzk_msm_bucket_sum(int mode, const void* pts, const void* idx, const void* start,
                                  const void* len, const void* order, long long nchunks,
                                  void* out, void* stream) {
  if (nchunks <= 0) return 0;
  const int T = 128;
  if (mode == 0)
    bucket_sum_kernel_affine<<<nblocks(nchunks, T), T, 0, (cudaStream_t)stream>>>(
        (const uint4*)pts, (const long long*)idx, (const long long*)start,
        (const long long*)len, (const long long*)order, nchunks, (uint4*)out);
  else
    bucket_sum_kernel_jacobian<<<nblocks(nchunks, T), T, 0, (cudaStream_t)stream>>>(
        (const uint4*)pts, (const long long*)start, (const long long*)len,
        (const long long*)order, nchunks, (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int tzk_msm_window_reduce(const void* sums, const void* rsum, const void* keys,
                                     const void* off, long long nseg, int seg, int shift,
                                     void* out_r, void* out_s, void* stream) {
  if (nseg <= 0) return 0;
  const int T = 128;
  window_reduce_kernel<<<nblocks(nseg, T), T, 0, (cudaStream_t)stream>>>(
      (const uint4*)sums, (const uint4*)rsum, (const long long*)keys, (const long long*)off,
      nseg, seg, shift, (uint4*)out_r, (uint4*)out_s);
  return (int)cudaGetLastError();
}
