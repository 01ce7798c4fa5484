// B6: the inclusive Fr product scan along the batch axis, prefix or suffix.
//
// Replaces `fr_prefix_prod` / `fr_suffix_prod`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:571-576), which the JAX
// package builds as `jax.lax.associative_scan` over its Pallas Fr product
// (`_ew_binop_fn`, :267/279).  Values are limb-major [16, B] int32 (16-bit
// limbs, Montgomery form); output i is the product of elements 0..i
// (prefix) or i..B-1 (suffix).  Products are fr_chain.cuh's carry-chain
// ones, every result fully reduced; the product is commutative, so the
// bytes equal the plain version's whatever association the scan uses.
// Zeros take part: a zero makes every later output zero.
//
// Scan order: position s of the scan is element s (prefix) or B-1-s
// (suffix), so the suffix scan needs no flip.  Tiles of TILE = THREADS x K
// positions; thread t owns positions t K .. t K + K-1 of its tile,
// contiguous in scan order.
//   * scan_tile: the tile is staged through shared memory (word-major, one
//     pad word every 32 slots: the coalesced limb-major loads and the
//     threads' strided reads hit distinct banks), each thread scans its K
//     positions in place, the thread totals go up a product tree and back
//     down it as exclusive prefixes (heap order, node 1 seeded with the
//     product of every earlier tile, or one), and each thread multiplies
//     its K prefixes by its own before the tile is stored back, coalesced.
//   * Up to TILE elements: scan_tile alone, one launch.  Above, three:
//     scan_up (each tile's total: one product an element, the tile's
//     elements read coalesced in any order, a tree), scan_top (one block
//     scans the tile totals in place, TILE at a time, each run seeded with
//     the last one's end), and scan_tile over every tile, seeded with the
//     totals' prefix of the tiles before it.
//
// Bound on the card: the array read and written once (64 B an element each
// way); about two products an element for a work-efficient scan.  This one
// does about three (one in scan_up, two in scan_tile) and reads the array
// twice; the K products of a thread are one dependent chain.
#include "fr_chain.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int K = 8;                       // positions a thread owns
constexpr int TILE = THREADS * K;          // positions a block scans
constexpr int ROW = TILE + TILE / 32;      // a word's row in the staged tile

using frc::fe;

__device__ __forceinline__ constexpr uint32_t one_w(int k) {  // R mod r
  return k == 0 ? 0xfffffffeu : k == 1 ? 0x00000001u : k == 2 ? 0x00034802u
       : k == 3 ? 0x5884b7fau : k == 4 ? 0xecbc4ff5u : k == 5 ? 0x998c4fefu
       : k == 6 ? 0xacc5056fu : 0x1824b159u;
}

__device__ __forceinline__ void set_one(fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = one_w(k);
}

// element i of a limb-major [16, stride] array <-> 8 words
__device__ __forceinline__ void gload(fe& x, const int32_t* p, long long i, long long stride) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) {
    const uint32_t lo = (uint32_t)p[(2 * k) * stride + i] & 0xFFFFu;
    const uint32_t hi = (uint32_t)p[(2 * k + 1) * stride + i] & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void gstore(int32_t* p, long long i, long long stride, const fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) {
    p[(2 * k) * stride + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * stride + i] = (int32_t)(x[k] >> 16);
  }
}

// the element at scan position s
__device__ __forceinline__ long long elem(long long s, long long B, bool rev) {
  return rev ? B - 1 - s : s;
}

// staged tile: word k of position s at k ROW + s + s / 32
__device__ __forceinline__ void sget(fe& x, const uint32_t* st, int s) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = st[k * ROW + s + (s >> 5)];
}

__device__ __forceinline__ void sput(uint32_t* st, int s, const fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) st[k * ROW + s + (s >> 5)] = x[k];
}

// product tree, word-major: word k of node h at k 2 THREADS + h
__device__ __forceinline__ void tree_put(uint32_t* tr, int h, const fe& x) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) tr[k * 2 * THREADS + h] = x[k];
}

__device__ __forceinline__ void tree_get(fe& x, const uint32_t* tr, int h) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = tr[k * 2 * THREADS + h];
}

// leaves THREADS + t hold the thread totals -> node h = node 2h * node 2h+1
__device__ __forceinline__ void tree_up(uint32_t* tr) {
  for (int s = THREADS >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < s) {
      const int h = s + threadIdx.x;
      fe a, b;
      tree_get(a, tr, 2 * h);
      tree_get(b, tr, 2 * h + 1);
      frc::mul(a, a, b);
      tree_put(tr, h, a);
    }
  }
  __syncthreads();
}

// node 1 holds the product of everything before the tile -> leaf
// THREADS + t holds the product of everything before thread t's positions
// (a left child's prefix is its parent's; a right child's, that times its
// left sibling's product)
__device__ __forceinline__ void tree_down(uint32_t* tr) {
  for (int s = 1; s < THREADS; s <<= 1) {
    __syncthreads();
    if ((int)threadIdx.x < s) {
      const int h = s + threadIdx.x;
      fe p, l;
      tree_get(p, tr, h);
      tree_get(l, tr, 2 * h);
      tree_put(tr, 2 * h, p);
      frc::mul(l, p, l);
      tree_put(tr, 2 * h + 1, l);
    }
  }
  __syncthreads();
}

// Scan positions [base, base + n) of a (n <= TILE) into out, seeded with
// element c of seed ([16, cstride]) or with one when seed is null.  out may
// be a: the tile is staged before anything is stored.
__device__ __forceinline__ void tile_scan(const int32_t* a, int32_t* out, long long B, bool rev,
                                          long long base, int n, const int32_t* seed,
                                          long long c, long long cstride, uint32_t* st,
                                          uint32_t* tr) {
  const int t = threadIdx.x;
  for (int s = t; s < n; s += THREADS) {
    fe x;
    gload(x, a, elem(base + s, B, rev), B);
    sput(st, s, x);
  }
  __syncthreads();
  fe acc, x;
  set_one(acc);
  for (int j = 0; j < K; ++j) {
    const int s = t * K + j;
    if (s >= n) break;
    sget(x, st, s);
    frc::mul(acc, acc, x);
    sput(st, s, acc);
  }
  tree_put(tr, THREADS + t, acc);
  tree_up(tr);
  if (t == 0) {
    if (seed != nullptr)
      gload(acc, seed, c, cstride);
    else
      set_one(acc);
    tree_put(tr, 1, acc);
  }
  tree_down(tr);
  tree_get(acc, tr, THREADS + t);
  for (int j = 0; j < K; ++j) {
    const int s = t * K + j;
    if (s >= n) break;
    sget(x, st, s);
    frc::mul(x, x, acc);
    sput(st, s, x);
  }
  __syncthreads();
  for (int s = t; s < n; s += THREADS) {
    sget(x, st, s);
    gstore(out, elem(base + s, B, rev), B, x);
  }
}

__device__ __forceinline__ int tile_len(long long base, long long B) {
  return (int)min((long long)TILE, B - base);
}

// tot[:, b] = the product of tile b's elements (tiles in scan order)
__global__ void __launch_bounds__(THREADS) scan_up(const int32_t* __restrict__ a, int32_t* tot,
                                                   long long B, int rev, int ntiles) {
  __shared__ uint32_t tr[frc::N * 2 * THREADS];
  const long long base = (long long)blockIdx.x * TILE;
  const int n = tile_len(base, B);
  fe acc, x;
  set_one(acc);
  for (int s = threadIdx.x; s < n; s += THREADS) {
    gload(x, a, elem(base + s, B, rev != 0), B);
    frc::mul(acc, acc, x);
  }
  tree_put(tr, THREADS + threadIdx.x, acc);
  tree_up(tr);
  if (threadIdx.x == 0) {
    tree_get(acc, tr, 1);
    gstore(tot, blockIdx.x, ntiles, acc);
  }
}

// one block: tot [16, ntiles] <- its inclusive prefix products, in place
__global__ void __launch_bounds__(THREADS) scan_top(int32_t* tot, int ntiles) {
  __shared__ uint32_t st[frc::N * ROW];
  __shared__ uint32_t tr[frc::N * 2 * THREADS];
  for (long long base = 0; base < ntiles; base += TILE) {
    tile_scan(tot, tot, ntiles, false, base, tile_len(base, ntiles),
              base > 0 ? tot : nullptr, base - 1, ntiles, st, tr);
    __syncthreads();  // the run's stores (and its last, the next seed) are seen
  }
}

// tile b of a, seeded with pre[:, b - 1] (the product of tiles 0..b-1), or
// with one for b = 0 or a null pre
__global__ void __launch_bounds__(THREADS) scan_tile(const int32_t* __restrict__ a,
                                                     int32_t* out,
                                                     const int32_t* __restrict__ pre,
                                                     long long B, int rev, int ntiles) {
  __shared__ uint32_t st[frc::N * ROW];
  __shared__ uint32_t tr[frc::N * 2 * THREADS];
  const long long base = (long long)blockIdx.x * TILE;
  tile_scan(a, out, B, rev != 0, base, tile_len(base, B),
            blockIdx.x > 0 ? pre : nullptr, (long long)blockIdx.x - 1, ntiles, st, tr);
}

}  // namespace

extern "C" int tzk_fr_scan_tile() { return TILE; }

// tile totals of a [16, B] into tot [16, ceil(B / TILE)]
extern "C" int tzk_fr_scan_up(const void* a, void* tot, long long B, int rev, void* stream) {
  if (B <= 0) return 0;
  const int nt = (int)((B + TILE - 1) / TILE);
  scan_up<<<nt, THREADS, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)tot, B, rev,
                                                    nt);
  return (int)cudaGetLastError();
}

// tot [16, ntiles] <- its inclusive prefix products
extern "C" int tzk_fr_scan_top(void* tot, int ntiles, void* stream) {
  if (ntiles <= 0) return 0;
  scan_top<<<1, THREADS, 0, (cudaStream_t)stream>>>((int32_t*)tot, ntiles);
  return (int)cudaGetLastError();
}

// out <- the scan of a, tile b seeded with pre[:, b - 1]; pre is null when
// a is one tile
extern "C" int tzk_fr_scan_tiles(const void* a, void* out, const void* pre, long long B, int rev,
                                 void* stream) {
  if (B <= 0) return 0;
  const int nt = (int)((B + TILE - 1) / TILE);
  scan_tile<<<nt, THREADS, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)out,
                                                      (const int32_t*)pre, B, rev, nt);
  return (int)cudaGetLastError();
}
