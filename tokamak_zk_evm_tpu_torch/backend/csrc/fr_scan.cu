// B6: the inclusive Fr product scan along the batch axis, prefix or suffix,
// in one pass with a decoupled look-back.
//
// Replaces `fr_prefix_prod` / `fr_suffix_prod`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:571-576), which the JAX
// package builds as `jax.lax.associative_scan` over its Pallas Fr product
// (`_ew_binop_fn`, :267/279).  Values are limb-major [16, B] int32 (16-bit
// limbs, Montgomery form); output i is the product of elements 0..i
// (prefix) or i..B-1 (suffix).  Products are fr_chain.cuh's carry-chain
// `mul_wide`, every result fully reduced; the product is commutative, so the
// bytes equal the plain version's whatever association the scan uses.
// Zeros take part: a zero makes every later output zero.
//
// Bound on the card: the array read once and written once, 128 B an element
// (64 each way; 0.040 ms at [16, 2^20] and 3.35 TB/s), and about two
// products an element for a work-efficient scan (0.034 ms at the integer
// multipliers' rate).  This kernel reads and writes the array once, in one
// launch at every width, and does (2K + 6) / K products an element plus
// about ten a tile: at that count its products take longer than its bytes.
//
//   * Scan position s is element s (prefix) or B-1-s (suffix): no flip.
//     Tiles of TILE = THREADS x K positions; thread t owns positions
//     t K .. t K + K-1 of its tile, contiguous in scan order.  A block takes
//     its tile from a counter (atomicAdd), not from blockIdx, so every tile
//     it waits for belongs to a block that is already running.
//   * The tile is staged through shared memory, coalesced (word-major, one
//     pad word every 32 slots: the limb-major loads and the threads' strided
//     reads of K contiguous positions hit distinct banks).
//   * Each thread scans its K positions in place (K - 1 products); the
//     thread totals are scanned within each warp by shuffles (5 levels), the
//     warp totals by warp 0.  No barrier tree, no idle half.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", 2016) on two levels.  A product is a
//     chain of ~150 dependent instructions, so one level over tiles passes
//     the prefix on only a window of tiles per window's latency (L2 reads
//     and five products): that chain, not the work, set the time at 2^20
//     elements.  Tiles form groups of GROUP.  A tile publishes its aggregate; warp 0 then
//     multiplies the aggregates of the tiles before it in its group (e: one
//     lane a tile, a warp product of ceil(log2 q) levels) and, for the
//     groups before, reads the flags of the WINDOW groups before its own at
//     once, waits until each group up to the nearest one with a prefix has
//     published its aggregate, multiplies those values and moves the window
//     back while none has a prefix (x).  A group's last tile publishes the
//     group's aggregate (e times its own), then its prefix (x times that).
//   * Status records: a flag (NONE, AGGREGATE, PREFIX) and 8 words each.
//     One thread writes a record's words, then its flag with st.release.gpu;
//     readers load the flag with ld.acquire.gpu, then the words from L2.
//     Only the flag says a value is there: zero is an aggregate like any
//     other.
//   * Each thread multiplies its K positions by its exclusive prefix (x e
//     times its warp's and its own within the tile) and the tile is stored
//     back through shared memory, coalesced.
//
// The counter and the status records are scratch that the wrapper
// allocates zeroed for each call (`status`: the counter; a flag and 8
// aggregate words a tile; a flag, 8 aggregate and 8 prefix words a group),
// so no call reads another's.
#include "fr_chain.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int K = 8;                       // positions a thread owns
constexpr int TILE = THREADS * K;          // positions a block scans
constexpr int ROW = TILE + TILE / 32;      // a word's row in the staged tile
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 32;                  // tiles a group, a lane each
constexpr int WINDOW = 32;                 // groups a look-back step reads, a lane each
constexpr uint32_t FULL = 0xffffffffu;
constexpr uint32_t NONE = 0, AGGREGATE = 1, PREFIX = 2;  // a status record's flag

static_assert(THREADS % 32 == 0 && WARPS <= 32, "whole warps, at most 32");
static_assert(frc::N * ROW * 4 <= 48 * 1024, "the staged tile fits static shared memory");

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
__device__ __forceinline__ void gload(fe& x, const int32_t* __restrict__ p, long long i,
                                      long long stride) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) {
    const uint32_t lo = (uint32_t)p[(2 * k) * stride + i] & 0xFFFFu;
    const uint32_t hi = (uint32_t)p[(2 * k + 1) * stride + i] & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void gstore(int32_t* __restrict__ p, long long i, long long stride,
                                       const fe& x) {
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

__device__ __forceinline__ void shfl_up(fe& y, const fe& x, int d) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) y[k] = __shfl_up_sync(FULL, x[k], d);
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// one thread: x into a status record's words, then its flag
__device__ __forceinline__ void publish(uint32_t* words, uint32_t* flag, const fe& x,
                                        uint32_t state) {
#pragma unroll
  for (int k = 0; k < frc::N; ++k) __stcg(words + k, x[k]);
  st_release(flag, state);
}

// every lane: x <- the product of x over lanes 0 .. last (last < 32; the
// lanes above it hold one), in ceil(log2(last + 1)) products
__device__ __forceinline__ void warp_product(fe& x, int last) {
  for (int d = 1; d <= last; d <<= 1) {
    fe y;
#pragma unroll
    for (int k = 0; k < frc::N; ++k) y[k] = __shfl_xor_sync(FULL, x[k], d);
    frc::mul_wide(x, x, y);
  }
#pragma unroll
  for (int k = 0; k < frc::N; ++k) x[k] = __shfl_sync(FULL, x[k], 0);
}

// Warp 0, every lane: e <- the product of the aggregates of tiles first ..
// first + q - 1 (q < GROUP), once each has published its own.
__device__ __forceinline__ void group_exclusive(fe& e, const uint32_t* flag, const uint32_t* agg,
                                                long long first, int q) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < q;
  uint32_t f;
  do {
    f = mine ? ld_acquire(flag + first + lane) : AGGREGATE;
  } while (__any_sync(FULL, f == NONE));
  if (mine) {
#pragma unroll
    for (int k = 0; k < frc::N; ++k) e[k] = __ldcg(agg + (first + lane) * frc::N + k);
  } else {
    set_one(e);
  }
  warp_product(e, q - 1);
}

// Warp 0, every lane: pre <- the product of groups 0 .. g-1 (g >= 1) from
// their status records.  Lane l reads group top - l of the window ending at
// top; a group before 0 counts as a prefix of one.
__device__ __forceinline__ void look_back(fe& pre, const uint32_t* flag, const uint32_t* agg,
                                          const uint32_t* incl, long long g) {
  const int lane = threadIdx.x & 31;
  set_one(pre);
  for (long long top = g - 1;; top -= WINDOW) {
    const long long i = top - lane;
    uint32_t f, found;
    int last;
    for (;;) {
      f = i >= 0 ? ld_acquire(flag + i) : PREFIX;
      found = __ballot_sync(FULL, f == PREFIX);
      last = found ? __ffs(found) - 1 : WINDOW - 1;  // lanes 0 .. last are needed
      if ((__ballot_sync(FULL, f == NONE) & (FULL >> (31 - last))) == 0) break;
    }
    fe x;
    if (lane > last || i < 0) {
      set_one(x);
    } else {
      const uint32_t* w = (f == PREFIX ? incl : agg) + i * frc::N;
#pragma unroll
      for (int k = 0; k < frc::N; ++k) x[k] = __ldcg(w + k);
    }
    warp_product(x, last);
    frc::mul_wide(pre, pre, x);
    if (found) return;
  }
}

__global__ void __launch_bounds__(THREADS) scan_kernel(const int32_t* __restrict__ a,
                                                       int32_t* __restrict__ out,
                                                       uint32_t* __restrict__ status,
                                                       long long B, int rev) {
  __shared__ uint32_t st[frc::N * ROW];
  __shared__ uint32_t wp[frc::N * WARPS];  // warp totals, then warp prefixes
  __shared__ long long tile;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long ntiles = (B + TILE - 1) / TILE;
  const long long ngroups = (ntiles + GROUP - 1) / GROUP;
  uint32_t* tflag = status + 1;
  uint32_t* tagg = tflag + ntiles;
  uint32_t* gflag = tagg + frc::N * ntiles;
  uint32_t* gagg = gflag + ngroups;
  uint32_t* gincl = gagg + frc::N * ngroups;

  if (t == 0) tile = atomicAdd(status, 1u);
  __syncthreads();
  const long long j = tile;
  const long long base = j * TILE;
  const int n = (int)min((long long)TILE, B - base);
  const long long g = j / GROUP;
  const int q = (int)(j % GROUP);
  const bool closes = q == GROUP - 1 || j == ntiles - 1;  // the group's last tile

#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int p = t + r * THREADS;
    if (p < n) {
      fe v;
      gload(v, a, elem(base + p, B, rev != 0), B);
      sput(st, p, v);
    }
  }
  __syncthreads();

  // this thread's positions, scanned in place; acc = their product
  const int s0 = t * K;
  const int m = max(0, min(K, n - s0));
  fe acc, x;
  if (m > 0) {
    sget(acc, st, s0);
    for (int r = 1; r < m; ++r) {
      sget(x, st, s0 + r);
      frc::mul_wide(acc, acc, x);
      sput(st, s0 + r, acc);
    }
  } else {
    set_one(acc);
  }
  // inclusive scan of the thread totals within the warp, then the exclusive
  // one (ex) by a shift
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    fe y;
    shfl_up(y, acc, d);
    if (lane >= d) frc::mul_wide(acc, y, acc);
  }
  fe ex;
  shfl_up(ex, acc, 1);
  if (lane == 0) set_one(ex);
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < frc::N; ++k) wp[k * WARPS + w] = acc[k];
  }
  __syncthreads();

  if (w == 0) {
    // the warp totals' scan: lane l < WARPS ends with warp l's exclusive
    // prefix within the tile (y), every lane with the tile's aggregate
    fe v, y, tot, e;
    if (lane < WARPS) {
#pragma unroll
      for (int k = 0; k < frc::N; ++k) v[k] = wp[k * WARPS + lane];
    } else {
      set_one(v);
    }
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      shfl_up(y, v, d);
      if (lane >= d) frc::mul_wide(v, y, v);
    }
#pragma unroll
    for (int k = 0; k < frc::N; ++k) tot[k] = __shfl_sync(FULL, v[k], WARPS - 1);
    shfl_up(y, v, 1);
    if (lane == 0) set_one(y);
    // the tile's exclusive prefix, x e: e the product of the tiles before it
    // in its group, x that of the groups before its group; the group's last
    // tile publishes the group's aggregate, then its prefix
    if (!closes && lane == 0) publish(tagg + j * frc::N, tflag + j, tot, AGGREGATE);
    group_exclusive(e, tflag, tagg, g * GROUP, q);
    if (closes) {
      frc::mul_wide(tot, e, tot);
      if (g == 0) {
        set_one(x);
        if (lane == 0) publish(gincl, gflag, tot, PREFIX);
      } else {
        if (lane == 0) publish(gagg + g * frc::N, gflag + g, tot, AGGREGATE);
        look_back(x, gflag, gagg, gincl, g);
        if (lane == 0) {
          frc::mul_wide(tot, x, tot);
          publish(gincl + g * frc::N, gflag + g, tot, PREFIX);
        }
      }
    } else if (g == 0) {
      set_one(x);
    } else {
      look_back(x, gflag, gagg, gincl, g);
    }
    frc::mul_wide(e, x, e);
    if (lane < WARPS) {
      frc::mul_wide(y, e, y);
#pragma unroll
      for (int k = 0; k < frc::N; ++k) wp[k * WARPS + lane] = y[k];
    }
  }
  __syncthreads();

  // every position times this thread's exclusive prefix
#pragma unroll
  for (int k = 0; k < frc::N; ++k) acc[k] = wp[k * WARPS + w];
  frc::mul_wide(acc, acc, ex);
  for (int r = 0; r < m; ++r) {
    sget(x, st, s0 + r);
    frc::mul_wide(x, acc, x);
    sput(st, s0 + r, x);
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int p = t + r * THREADS;
    if (p < n) {
      sget(x, st, p);
      gstore(out, elem(base + p, B, rev != 0), B, x);
    }
  }
}

}  // namespace

extern "C" int tzk_fr_scan_tile() { return TILE; }

// out <- the scan of a [16, B] (rev: suffix); status: `words` zeroed words,
// at least 1 + 9 nt + 17 ceil(nt / GROUP) for nt = ceil(B / TILE) tiles
extern "C" int tzk_fr_scan(const void* a, void* out, void* status, long long words, long long B,
                           int rev, void* stream) {
  if (B <= 0) return 0;
  const long long nt = (B + TILE - 1) / TILE;
  const long long ng = (nt + GROUP - 1) / GROUP;
  if (words < 1 + (1 + frc::N) * nt + (1 + 2 * frc::N) * ng || nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)nt, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, (uint32_t*)status, B, rev);
  return (int)cudaGetLastError();
}
