// K3: NTT over Fr along one axis of a limb-major grid, stages fused in
// shared memory.
//
// Replaces `_ntt_stage_fn` / `_bf_kernel` driven by `fr_ntt`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:585-689).  Contract, as
// there: natural order in and out and twiddles pows[j] = w^j; here the
// transform is
//     out[k] = s * sum_j x[j] * w^(jk)
// with the scale s (an inverse transform's n^-1) optional and applied as
// the output is stored.
//
// The grid is [16, A, n, C] int32 limbs (element (a, j, c) at
// (a n + j) C + c of each limb plane): C = 1 for a transform along the
// last axis (rows), A = 1 for one along axis 1 of [16, X, Y] (columns).
//
// Bound on the card: Montgomery products, once the grid makes at most two
// round trips through device memory (64 B an element each way).  Design:
//
//   * One block holds a tile of R sub-transforms of m = 2^logm points in
//     shared memory (R m <= TILE), 8 words an element, word-major with one
//     pad word every 32 slots, and runs every radix-2 DIT stage of them
//     between __syncthreads, on Fr products on PTX carry chains
//     (fr_chain.cuh).  The bit reversal is folded into the load index, the
//     stage twiddles w^(n/m)^k sit in shared memory, and the first stage
//     (all twiddles one) multiplies nothing.
//   * n <= TILE (rows) or n <= TILE / min(C, COLS) (columns): one pass, one
//     launch.
//     Above, up to TILE^2 = 2^22 points: the four-step split n = n1 n2 in
//     two launches (a column tile spans fewer columns where COLS would not
//     reach n).  Longer transforms would take a third pass and are
//     refused.  Pass A runs the n1-point transforms over j1 of
//     x[n2 j1 + j2] (stride n2) and multiplies output k1 by w^(j2 k1) as
//     it stores it in place of j1; pass B runs the n2-point transforms of the contiguous segments k1 and
//     stores element k2 at k1 + n1 k2, so the transpose costs no pass.
//   * In place.  A block reads every element of its tile before it writes
//     any, and no other block touches them, so one pass may write over its
//     input; two passes go through a scratch grid.
//   * Coalescing.  A tile is R sub-transforms whose first elements are
//     adjacent in memory (R columns, or R segments at stride n2) and whose
//     loads walk r fastest ("interleaved"), or R whole rows walked along i
//     ("blocked": a row pass, and pass B's contiguous segments).
#include <algorithm>

#include "fr_chain.cuh"

namespace {

constexpr int TILE = 2048;    // elements of one block's shared tile (64 KB)
constexpr int THREADS = 256;
constexpr int COLS = 16;      // columns a column tile spans (64 B a limb row)

// Element i of sub-transform (u, v) lies at u bu + v bv + i s of a limb
// plane; on pass A's output side, u eu + v ev is the sub-transform's j2.
struct Side {
  long long bu, bv, s, eu, ev;
};

struct Pass {
  int logm, logr;      // m = 2^logm points, R = 2^logr sub-transforms a block
  long long U, V;      // sub-transforms (u, v), u < U, v < V
  Side in, out;
  long long n, total;  // full length (table stride); limb-plane stride
  const int32_t* scale;  // nullable [16, 1]: multiplies every output
  int twiddle;         // pass A of two: multiply output k1 by w^(j2 k1)
};

__device__ __forceinline__ void load_g(frc::fe& x, const int32_t* p, long long i,
                                       long long stride) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) {
    uint32_t lo = (uint32_t)__ldg(p + (2 * k) * stride + i) & 0xFFFFu;
    uint32_t hi = (uint32_t)__ldg(p + (2 * k + 1) * stride + i) & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store_g(int32_t* p, long long i, long long stride,
                                        const frc::fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) {
    p[(2 * k) * stride + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * stride + i] = (int32_t)(x[k] >> 16);
  }
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

__device__ __forceinline__ void load_s(frc::fe& x, const uint32_t* sm, int plane, int p) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = sm[k * plane + p];
}

__device__ __forceinline__ void store_s(uint32_t* sm, int plane, int p, const frc::fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) sm[k * plane + p] = x[k];
}

__global__ void __launch_bounds__(THREADS, 2)
ntt_pass_kernel(const int32_t* src, int32_t* dst, const int32_t* __restrict__ pows,
                const Pass P) {
  extern __shared__ uint32_t sm[];
  const int logm = P.logm, logr = P.logr;
  const int m = 1 << logm, R = 1 << logr, half = m >> 1, cells = R << logm;
  const int plane = pad(cells);  // words between two word planes of the tile
  uint32_t* tw = sm + frc::N * plane;  // stage twiddles, word-major [8][m / 2]
  const long long vblocks = (P.V + R - 1) >> logr;
  const long long u = blockIdx.x / vblocks;
  const long long v0 = (blockIdx.x - u * vblocks) << logr;
  const int live = (int)min((long long)R, P.V - v0);
  const long long step = P.n >> logm;  // w_m = w^(n / m)

  for (int k = threadIdx.x; k < half; k += THREADS) {
    frc::fe w;
    load_g(w, pows, k * step, P.n);
#pragma unroll
    for (int q = 0; q < frc::N; ++q) tw[q * half + k] = w[q];
  }

  // load: element i of sub-transform r -> slot bitrev(i) R + r
  const bool blocked_in = P.in.bv != 1;
  const long long base_in = u * P.in.bu + v0 * P.in.bv;
  for (int e = threadIdx.x; e < cells; e += THREADS) {
    const int r = blocked_in ? e >> logm : e & (R - 1);
    const int i = blocked_in ? e & (m - 1) : e >> logr;
    if (r >= live) continue;
    frc::fe x;
    load_g(x, src, base_in + r * P.in.bv + i * P.in.s, P.total);
    store_s(sm, plane, pad(((int)(__brev((unsigned)i) >> (32 - logm)) << logr) + r), x);
  }
  __syncthreads();

  // radix-2 DIT stages: butterfly (i0, i0 + h) of sub-transform r
  for (int h = 1; h < m; h <<= 1) {
    for (int b = threadIdx.x; b < (R << (logm - 1)); b += THREADS) {
      const int r = b & (R - 1);
      if (r >= live) continue;
      const int bb = b >> logr;
      const int pos = bb & (h - 1);
      const int i0 = ((bb - pos) << 1) + pos;
      const int p0 = pad((i0 << logr) + r), p1 = pad(((i0 + h) << logr) + r);
      frc::fe lo, hi;
      load_s(lo, sm, plane, p0);
      load_s(hi, sm, plane, p1);
      if (h > 1) {  // twiddle w_m^(pos m / 2h); one on the first stage
        frc::fe w;
        load_s(w, tw, half, pos * (half / h));
        frc::mul(hi, hi, w);
      }
      frc::fe a;
      frc::add(a, lo, hi);
      frc::sub(hi, lo, hi);
      store_s(sm, plane, p0, a);
      store_s(sm, plane, p1, hi);
    }
    __syncthreads();
  }

  // store: slot i R + r -> element i of sub-transform r
  frc::fe scale;
  if (P.scale != nullptr) load_g(scale, P.scale, 0, 1);
  const bool blocked_out = P.out.bv != 1;
  const long long base_out = u * P.out.bu + v0 * P.out.bv;
  for (int e = threadIdx.x; e < cells; e += THREADS) {
    const int r = blocked_out ? e >> logm : e & (R - 1);
    const int i = blocked_out ? e & (m - 1) : e >> logr;
    if (r >= live) continue;
    frc::fe x;
    load_s(x, sm, plane, pad((i << logr) + r));
    const long long off = u * P.out.eu + (v0 + r) * P.out.ev;
    if (P.twiddle) {
      frc::fe w;
      load_g(w, pows, off * i, P.n);
      frc::mul(x, x, w);
    }
    if (P.scale != nullptr) frc::mul(x, x, scale);
    store_g(dst, base_out + r * P.out.bv + i * P.out.s, P.total, x);
  }
}

int log2i(long long v) {
  int k = 0;
  while ((1ll << k) < v) ++k;
  return k;
}

// log2 of the sub-transforms a block takes: as many as fit the tile, at most
// the next power of two of V.
int tile_logr(int logm, long long V) { return std::min(log2i(TILE) - logm, log2i(V)); }

// The lengths (n1, n2) of a transform's passes (n2 = 1: one pass), or
// (0, 0) above TILE^2 points.  A column tile spans `cols` adjacent columns,
// COLS where two passes of TILE / COLS points reach n, else fewer.
void split(long long n, long long C, long long* n1, long long* n2) {
  *n1 = *n2 = 0;
  if (n > (long long)TILE * TILE) return;
  long long cols = C == 1 ? 1 : std::min<long long>(COLS, 1ll << log2i(C));
  while (cols > 1 && n > (TILE / cols) * (TILE / cols)) cols >>= 1;
  const long long most = TILE / cols;  // longest sub-transform of a tile
  *n1 = n;
  *n2 = 1;
  if (n <= most) return;
  // rows: pass B stores at least 8 segments a block side by side
  *n2 = C == 1 ? std::max<long long>(256, n / TILE) : most;
  *n1 = n / *n2;
}

int launch(const int32_t* src, int32_t* dst, const int32_t* pows, Pass P, cudaStream_t s) {
  const int smem = (int)(sizeof(uint32_t) * frc::N * ((TILE + TILE / 32) + TILE / 2));
  static bool once = false;
  if (!once) {
    int err = (int)cudaFuncSetAttribute(ntt_pass_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    once = true;
  }
  const int cells = 1 << (P.logm + P.logr);
  const int need = (int)(sizeof(uint32_t) * frc::N * ((cells + (cells >> 5)) + (1 << P.logm) / 2));
  const long long blocks = P.U * ((P.V + (1ll << P.logr) - 1) >> P.logr);
  ntt_pass_kernel<<<(unsigned)blocks, THREADS, need, s>>>(src, dst, pows, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches a transform of length n over a [16, A, n, C] grid takes: 1 or 2,
// or 0 above TILE^2 points.
extern "C" int tzk_ntt_passes(long long n, long long C) {
  long long n1, n2;
  split(n, C, &n1, &n2);
  return n1 == 0 ? 0 : n2 == 1 ? 1 : 2;
}

// data, out: [16, A * n * C] (out may be data); tmp: a third buffer of the
// same size when the transform takes two passes, else unused; pows [16, n];
// scale nullable [16, 1].  A = 1 when C > 1.
extern "C" int tzk_ntt(const void* data, void* out, void* tmp, const void* pows,
                       const void* scale, long long A, long long n, long long C,
                       void* stream) {
  const long long total = A * n * C;
  if (total <= 0 || n < 2) return 0;
  long long n1, n2;
  split(n, C, &n1, &n2);
  if (n1 == 0 || (C > 1 && A != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Pass P{};
  P.n = n;
  P.total = total;
  const int32_t* src = (const int32_t*)data;
  const int32_t* tw = (const int32_t*)pows;
  if (n2 == 1) {  // one pass
    P.logm = log2i(n);
    P.scale = (const int32_t*)scale;
    if (C == 1) {  // A rows, a block takes whole rows
      P.U = 1, P.V = A;
      P.in = P.out = Side{0, n, 1};
    } else {  // C columns, a block takes adjacent ones
      P.U = 1, P.V = C;
      P.in = P.out = Side{0, 1, C};
    }
    P.logr = tile_logr(P.logm, P.V);
    return launch(src, (int32_t*)out, tw, P, s);
  }
  // pass A: x[n2 j1 + j2] -> tmp[n2 k1 + j2] * w^(j2 k1)
  Pass pa = P;
  pa.logm = log2i(n1);
  pa.twiddle = 1;
  // pass B: tmp[n2 k1 + j2] -> out[k1 + n1 k2], scale on the way out
  Pass pb = P;
  pb.logm = log2i(n2);
  pb.scale = (const int32_t*)scale;
  if (C == 1) {  // (u, v) = (row, j2) and (row, k1)
    pa.U = pb.U = A;
    pa.V = n2;
    pa.in = pa.out = Side{n, 1, n2, 0, 1};
    pb.V = n1;
    pb.in = Side{n, n2, 1};
    pb.out = Side{n, 1, n1};
  } else {  // (u, v) = (j2, column) and (k1, column)
    pa.U = n2;
    pb.U = n1;
    pa.V = pb.V = C;
    pa.in = pa.out = Side{C, 1, n2 * C, 1, 0};
    pb.in = Side{n2 * C, 1, C};
    pb.out = Side{C, 1, n1 * C};
  }
  pa.logr = tile_logr(pa.logm, pa.V);
  pb.logr = tile_logr(pb.logm, pb.V);
  int err = launch(src, (int32_t*)tmp, tw, pa, s);
  if (err) return err;
  return launch((const int32_t*)tmp, (int32_t*)out, tw, pb, s);
}
