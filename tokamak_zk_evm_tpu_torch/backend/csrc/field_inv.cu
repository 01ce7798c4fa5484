// K2: field inversion and Montgomery batch inversion, Fr and Fq; 0 -> 0.
//
// Replaces `_inv_fn` (per-element a^(p-2)) and the batch-inversion pair
// `_binv_fwd_fn` / `_binv_bwd_fn`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:382-563).  Values are
// limb-major [2N, B] int32 (16-bit limbs, Montgomery form), N = 8 words for
// Fr and 12 for Fq; the products are the carry-chain ones of fr_chain.cuh
// and fq_chain.cuh, every result fully reduced, so the output is byte-equal
// to the plain versions'.
//
// One inversion, `inv_mont`: a variable-time Bernstein-Yang (safegcd)
// extended gcd on signed 30-bit limbs, in batches of 30 divsteps whose 2x2
// transition matrix is found on 32-bit words alone (a count of trailing
// zeros halves g at once; a Newton inverse of f mod 2^6 cancels up to six
// low bits of g) and then applied to (f, g) and to (d, e) mod p with
// 32 x 32 -> 64-bit products.  No field product inside the loop.  The
// input is aR; the gcd gives (aR)^-1, and one Montgomery product with
// R^3 mod p gives a^-1 R.  At most MAX_BATCHES batches: the divstep bound
// floor((49 d + 57) / 17) for d-bit inputs (Bernstein and Yang, 2019) over
// 30, 25 for Fr and 37 for Fq (about 18 and 27 are typical).
//
// Batch inversion.  Up to kernels.BINV_EACH elements, `inv_kernel` inverts
// each element with its own gcd (one thread an element): on one H100 that
// beats Montgomery's trick below ~2^17 elements, where the trick's chains
// of dependent products, not the card's throughput, set the time.  Wider
// batches run the trick over tiles of THREADS x K elements (K chosen by the
// wrapper, 1-32).  Thread t of a tile owns elements base + j THREADS + t,
// so a warp's loads and stores of one limb touch 32 adjacent words.
//   * binv_up: each thread walks its elements, stores the exclusive prefix
//     product of its nonzero ones in place of each (zeros are skipped), and
//     its total into a product tree in shared memory (heap order, leaves
//     THREADS + t); the tile total (node 1) goes to tot.
//   * the tile totals (never zero: products of nonzero elements, or one)
//     go through `inv_kernel`.
//   * binv_down: the tree is rebuilt from each thread's last prefix (one
//     product a thread), the tile's inverse goes down it (inv(left) =
//     inv(parent) right, inv(right) = inv(parent) left) to each thread's,
//     and each thread walks its elements back: out = prefix * inv,
//     inv *= a.
// The prefixes go through `out`, so nothing but the totals is scratch.
//
// Bound on the card: the IMAD rate for wide batches (three products an
// element, plus 5 / K for the trees, against two element transfers and two
// more for the prefixes); the latency of one gcd (and of the trick's
// product chains) for narrow ones.
#include "fr_chain.cuh"

namespace {

constexpr int THREADS = 256;  // threads of a tile block
constexpr int32_t M30 = 0x3fffffff;

// Per-field constants, each folded into an immediate for an unrolled
// constant index: p in signed 30-bit limbs, p^-1 mod 2^30, R mod p and
// R^3 mod p in 32-bit words.
struct FrF {
  static constexpr int N = 8, S = 9, MAX_BATCHES = 25;
  static constexpr uint32_t PINV30 = 0x1u;
  __device__ __forceinline__ static constexpr int32_t p30(int k) {
    return k == 0 ? 0x1 : k == 1 ? 0x3ffffffc : k == 2 ? 0x3fe5bfef : k == 3 ? 0x2f6900bf
         : k == 4 ? 0x21d80553 : k == 5 ? 0x27602026 : k == 6 ? 0x17d48333
         : k == 7 ? 0x29d4ca67 : 0x73ed;
  }
  __device__ __forceinline__ static constexpr uint32_t one(int k) {
    return k == 0 ? 0xfffffffeu : k == 1 ? 0x00000001u : k == 2 ? 0x00034802u
         : k == 3 ? 0x5884b7fau : k == 4 ? 0xecbc4ff5u : k == 5 ? 0x998c4fefu
         : k == 6 ? 0xacc5056fu : 0x1824b159u;
  }
  __device__ __forceinline__ static constexpr uint32_t r3(int k) {
    return k == 0 ? 0x439b73afu : k == 1 ? 0xc62c1807u : k == 2 ? 0x8cf06990u
         : k == 3 ? 0x1b3e0d18u : k == 4 ? 0xc7b5f418u : k == 5 ? 0x73d13c71u
         : k == 6 ? 0xc8db33e9u : 0x6e2a5bb9u;
  }
  __device__ __forceinline__ static void mul(frc::fe& r, const frc::fe& a, const frc::fe& b) {
    frc::mul(r, a, b);
  }
};

struct FqF {
  static constexpr int N = 12, S = 13, MAX_BATCHES = 37;
  static constexpr uint32_t PINV30 = 0x30003u;
  __device__ __forceinline__ static constexpr int32_t p30(int k) {
    return k == 0 ? 0x3fffaaab : k == 1 ? 0x27fbffff : k == 2 ? 0x153ffffb
         : k == 3 ? 0x2affffac : k == 4 ? 0x30f6241e : k == 5 ? 0x034a83da
         : k == 6 ? 0x112bf673 : k == 7 ? 0x12e13ce1 : k == 8 ? 0x2cd76477
         : k == 9 ? 0x1ed90d2e : k == 10 ? 0x29a4b1ba : k == 11 ? 0x3a8e5ff9 : 0x1a0111;
  }
  __device__ __forceinline__ static constexpr uint32_t one(int k) { return fqc::qone(k); }
  __device__ __forceinline__ static constexpr uint32_t r3(int k) {
    return k == 0 ? 0xd94ca1e0u : k == 1 ? 0xed48ac6bu : k == 2 ? 0x03a7adf8u
         : k == 3 ? 0x315f831eu : k == 4 ? 0x615e29ddu : k == 5 ? 0x9a53352au
         : k == 6 ? 0x921e1761u : k == 7 ? 0x34c04e5eu : k == 8 ? 0x65724728u
         : k == 9 ? 0x2512d435u : k == 10 ? 0x91755d4du : 0x0aa63460u;
  }
  __device__ __forceinline__ static void mul(fqc::fe& r, const fqc::fe& a, const fqc::fe& b) {
    fqc::mul(r, a, b);
  }
};

// --- elements ---------------------------------------------------------------

// element i of a limb-major [2N, stride] array <-> N words
template <int N>
__device__ __forceinline__ void load(uint32_t (&x)[N], const int32_t* p, long long i,
                                     long long stride) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t lo = (uint32_t)p[(2 * k) * stride + i] & 0xFFFFu;
    const uint32_t hi = (uint32_t)p[(2 * k + 1) * stride + i] & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void store(int32_t* p, long long i, long long stride,
                                      const uint32_t (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[(2 * k) * stride + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * stride + i] = (int32_t)(x[k] >> 16);
  }
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t (&x)[N]) {
  uint32_t acc = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) acc |= x[k];
  return acc == 0u;
}

template <class F>
__device__ __forceinline__ void set_one(uint32_t (&x)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) x[k] = F::one(k);
}

// --- one inversion: safegcd on signed 30-bit limbs ---------------------------

// words (value < p) -> S limbs of 30 bits
template <class F>
__device__ __forceinline__ void to30(int32_t (&l)[F::S], const uint32_t (&w)[F::N]) {
#pragma unroll
  for (int i = 0; i < F::S; ++i) {
    const int k = (30 * i) >> 5, s = (30 * i) & 31;
    uint64_t t = w[k];
    if (k + 1 < F::N) t |= (uint64_t)w[k + 1] << 32;
    l[i] = (int32_t)((t >> s) & M30);
  }
}

// S limbs of a value in [0, p) -> words
template <class F>
__device__ __forceinline__ void from30(uint32_t (&w)[F::N], const int32_t (&l)[F::S]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    const int i = (32 * k) / 30, s = (32 * k) % 30;  // s <= 28: two limbs cover a word
    uint64_t t = (uint32_t)l[i];
    if (i + 1 < F::S) t |= (uint64_t)(uint32_t)l[i + 1] << 30;
    w[k] = (uint32_t)(t >> s);
  }
}

// 30 divsteps on the low words of f (odd) and g, eta = -delta.  Returns the
// new eta and the transition matrix [u v; q r], scaled by 2^30:
// 2^30 (f', g') = (u f + v g, q f + r g).
__device__ __forceinline__ int divsteps_30(int eta, uint32_t f, uint32_t g, int32_t (&t)[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    // every trailing zero of g is one divstep that halves g (a sentinel bit
    // stops the count at the i left)
    const int zeros = __ffs((int)(g | (0xffffffffu << i))) - 1;
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {  // delta > 0 and g odd: (f, g) <- (g, -f)
      uint32_t x = f;
      eta = -eta;
      f = g;
      g = 0u - x;
      x = u;
      u = q;
      q = 0u - x;
      x = v;
      v = r;
      r = 0u - x;
    }
    // add the multiple of f that clears the low min(eta + 1, i, 6) bits of
    // g: -f^-1 mod 2^6 = f (f^2 - 2) for odd f
    const int limit = min(eta + 1, i);
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 63u;
    const uint32_t w = (g * f * (f * f - 2u)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me chosen to clear the low
// 30 bits; keeps d and e in (-2p, p).
template <class F>
__device__ __forceinline__ void update_de(int32_t (&d)[F::S], int32_t (&e)[F::S],
                                          const int32_t (&t)[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[F::S - 1] >> 31, se = e[F::S - 1] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((F::PINV30 * (uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)((F::PINV30 * (uint32_t)ce + (uint32_t)me) & M30);
  cd += (int64_t)F::p30(0) * md;
  ce += (int64_t)F::p30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < F::S; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)F::p30(i) * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)F::p30(i) * me;
    d[i - 1] = (int32_t)(cd & M30);
    cd >>= 30;
    e[i - 1] = (int32_t)(ce & M30);
    ce >>= 30;
  }
  d[F::S - 1] = (int32_t)cd;
  e[F::S - 1] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30 (exact: the divsteps cleared the low 30 bits)
template <class F>
__device__ __forceinline__ void update_fg(int32_t (&f)[F::S], int32_t (&g)[F::S],
                                          const int32_t (&t)[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < F::S; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)(cf & M30);
    cf >>= 30;
    g[i - 1] = (int32_t)(cg & M30);
    cg >>= 30;
  }
  f[F::S - 1] = (int32_t)cf;
  g[F::S - 1] = (int32_t)cg;
}

// d += p where mask is all ones
template <class F>
__device__ __forceinline__ void add_p(int32_t (&d)[F::S], int32_t mask) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < F::S - 1; ++i) {
    c += d[i] + (F::p30(i) & mask);
    d[i] = c & M30;
    c >>= 30;
  }
  d[F::S - 1] += (F::p30(F::S - 1) & mask) + c;
}

// d in (-2p, p), f = +-1 -> d f mod p in [0, p)
template <class F>
__device__ __forceinline__ void normalize(int32_t (&d)[F::S], int32_t f_top) {
  add_p<F>(d, d[F::S - 1] >> 31);
  const int32_t neg = f_top >> 31;
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < F::S - 1; ++i) {
    c += (d[i] ^ neg) - neg;
    d[i] = c & M30;
    c >>= 30;
  }
  d[F::S - 1] = ((d[F::S - 1] ^ neg) - neg) + c;
  add_p<F>(d, d[F::S - 1] >> 31);
}

// x = aR (Montgomery form, reduced) -> r = a^-1 R; 0 -> 0.  r may be x.
template <class F>
__device__ __forceinline__ void inv_mont(uint32_t (&r)[F::N], const uint32_t (&x)[F::N]) {
  int32_t d[F::S], e[F::S], f[F::S], g[F::S];
#pragma unroll
  for (int i = 0; i < F::S; ++i) {
    d[i] = 0;
    e[i] = i == 0;
    f[i] = F::p30(i);
  }
  to30<F>(g, x);
  int eta = -1;
#pragma unroll 1
  for (int b = 0; b < F::MAX_BATCHES; ++b) {
    int32_t t[4];
    eta = divsteps_30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de<F>(d, e, t);
    update_fg<F>(f, g, t);
    int32_t any = g[0];
#pragma unroll
    for (int i = 1; i < F::S; ++i) any |= g[i];
    if (any == 0) break;
  }
  // g = 0, f = +-gcd = +-1, d = +-x^-1
  normalize<F>(d, f[F::S - 1]);
  uint32_t y[F::N], c[F::N];
  from30<F>(y, d);
#pragma unroll
  for (int k = 0; k < F::N; ++k) c[k] = F::r3(k);
  F::mul(r, y, c);
}

// --- the tile schedule -------------------------------------------------------

// product tree in shared memory, word-major: word k of node h at k 2 THREADS + h
template <class F>
__device__ __forceinline__ void tree_put(uint32_t* tr, int h, const uint32_t (&x)[F::N]) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) tr[k * 2 * THREADS + h] = x[k];
}

template <class F>
__device__ __forceinline__ void tree_get(uint32_t (&x)[F::N], const uint32_t* tr, int h) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) x[k] = tr[k * 2 * THREADS + h];
}

// leaves T + t hold the thread totals -> node h = node 2h * node 2h+1; the
// block total at node 1.  T = blockDim.x, a power of two.
template <class F>
__device__ __forceinline__ void tree_up(uint32_t* tr, int T) {
  for (int s = T >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < s) {
      const int h = s + threadIdx.x;
      uint32_t a[F::N], b[F::N];
      tree_get<F>(a, tr, 2 * h);
      tree_get<F>(b, tr, 2 * h + 1);
      F::mul(a, a, b);
      tree_put<F>(tr, h, a);
    }
  }
  __syncthreads();
}

// node 1 holds the inverse of the block total -> leaf T + t holds the inverse
// of thread t's total
template <class F>
__device__ __forceinline__ void tree_down(uint32_t* tr, int T) {
  for (int s = 1; s < T; s <<= 1) {
    __syncthreads();
    if ((int)threadIdx.x < s) {
      const int h = s + threadIdx.x;
      uint32_t inv[F::N], l[F::N], r[F::N], il[F::N];
      tree_get<F>(inv, tr, h);
      tree_get<F>(l, tr, 2 * h);
      tree_get<F>(r, tr, 2 * h + 1);
      F::mul(il, inv, r);
      F::mul(r, inv, l);
      tree_put<F>(tr, 2 * h, il);
      tree_put<F>(tr, 2 * h + 1, r);
    }
  }
  __syncthreads();
}

// Thread t of a block of T owns elements base + j T + t, j < K, of the n in
// its tile: pre[i] = product of its nonzero elements before i; s = all of them.
template <class F>
__device__ __forceinline__ void thread_up(const int32_t* __restrict__ a, int32_t* pre,
                                          long long B, long long base, int n, int T, int K,
                                          uint32_t (&s)[F::N]) {
  set_one<F>(s);
  for (int j = 0; j < K; ++j) {
    const int i = j * T + threadIdx.x;
    if (i >= n) break;
    uint32_t x[F::N];
    load(x, a, base + i, B);
    store(pre, base + i, B, s);
    if (!is_zero(x)) F::mul(s, s, x);
  }
}

// the walk back from inv = the inverse of the thread's total: out[i] =
// pre[i] inv, inv *= a[i] (zeros give 0 and leave inv); out holds pre
template <class F>
__device__ __forceinline__ void thread_down(const int32_t* __restrict__ a, int32_t* out,
                                            long long B, long long base, int n, int T, int K,
                                            uint32_t (&inv)[F::N]) {
  for (int j = K - 1; j >= 0; --j) {
    const int i = j * T + threadIdx.x;
    if (i >= n) continue;
    uint32_t x[F::N], o[F::N];
    load(x, a, base + i, B);
    if (is_zero(x)) {
#pragma unroll
      for (int k = 0; k < F::N; ++k) o[k] = 0u;
    } else {
      load(o, out, base + i, B);
      F::mul(o, o, inv);
      F::mul(inv, inv, x);
    }
    store(out, base + i, B, o);
  }
}

// Up: block b takes tile [b THREADS K, (b + 1) THREADS K) of a, writes the
// thread prefixes to pre and the tile total to tot[:, b].
template <class F>
__device__ __forceinline__ void binv_up(const int32_t* __restrict__ a, int32_t* pre,
                                        int32_t* tot, long long B, int K, int ntiles) {
  __shared__ uint32_t tr[F::N * 2 * THREADS];
  const long long base = (long long)blockIdx.x * THREADS * K;
  const int n = (int)min((long long)THREADS * K, B - base), t = threadIdx.x;
  uint32_t s[F::N];
  thread_up<F>(a, pre, B, base, n, THREADS, K, s);
  tree_put<F>(tr, THREADS + t, s);
  tree_up<F>(tr, THREADS);
  if (t == 0) {
    tree_get<F>(s, tr, 1);
    store(tot, blockIdx.x, ntiles, s);
  }
}

// Down: rebuild the tile's tree from each thread's last prefix, send the
// tile inverse tinv[:, b] down it, walk every thread's elements back.
template <class F>
__device__ __forceinline__ void binv_down(const int32_t* __restrict__ a, int32_t* out,
                                          const int32_t* __restrict__ tinv, long long B,
                                          int K, int ntiles) {
  __shared__ uint32_t tr[F::N * 2 * THREADS];
  const long long base = (long long)blockIdx.x * THREADS * K;
  const int n = (int)min((long long)THREADS * K, B - base), t = threadIdx.x;
  uint32_t s[F::N];
  set_one<F>(s);
  if (t < n) {
    const int last = t + (n - 1 - t) / THREADS * THREADS;
    uint32_t x[F::N];
    load(x, a, base + last, B);
    load(s, out, base + last, B);
    if (!is_zero(x)) F::mul(s, s, x);
  }
  tree_put<F>(tr, THREADS + t, s);
  tree_up<F>(tr, THREADS);
  if (t == 0) {
    load(s, tinv, blockIdx.x, ntiles);
    tree_put<F>(tr, 1, s);
  }
  tree_down<F>(tr, THREADS);
  tree_get<F>(s, tr, THREADS + t);
  thread_down<F>(a, out, B, base, n, THREADS, K, s);
}

// one thread an element
template <class F>
__device__ __forceinline__ void inv_each(const int32_t* __restrict__ a, int32_t* out,
                                         long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t x[F::N];
  load(x, a, i, B);
  if (!is_zero(x)) inv_mont<F>(x, x);
  store(out, i, B, x);
}

// The kernels, one name per field (ptxas reports each by name).
#define K2_KERNELS(F, sfx)                                                                  \
  __global__ void __launch_bounds__(THREADS) inv_kernel_##sfx(                              \
      const int32_t* __restrict__ a, int32_t* out, long long B) {                           \
    inv_each<F>(a, out, B);                                                                 \
  }                                                                                         \
  __global__ void __launch_bounds__(THREADS) binv_up_##sfx(                                 \
      const int32_t* __restrict__ a, int32_t* pre, int32_t* tot, long long B, int K,        \
      int ntiles) {                                                                         \
    binv_up<F>(a, pre, tot, B, K, ntiles);                                                  \
  }                                                                                         \
  __global__ void __launch_bounds__(THREADS) binv_down_##sfx(                               \
      const int32_t* __restrict__ a, int32_t* out, const int32_t* __restrict__ tinv,        \
      long long B, int K, int ntiles) {                                                     \
    binv_down<F>(a, out, tinv, B, K, ntiles);                                               \
  }

K2_KERNELS(FrF, fr)
K2_KERNELS(FqF, fq)

inline int ntiles(long long B, int K) { return (int)((B + THREADS * K - 1) / (THREADS * K)); }

}  // namespace

extern "C" int tzk_field_inv(int field, const void* a, void* out, long long B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 128;
  const unsigned blocks = (unsigned)((B + T - 1) / T);
  if (field == 0)
    inv_kernel_fr<<<blocks, T, 0, s>>>((const int32_t*)a, (int32_t*)out, B);
  else
    inv_kernel_fq<<<blocks, T, 0, s>>>((const int32_t*)a, (int32_t*)out, B);
  return (int)cudaGetLastError();
}

// Up over tiles of THREADS x K: prefixes into out, tile totals into tot
// ([2N, ntiles]).
extern "C" int tzk_batch_inv_up(int field, const void* a, void* out, void* tot, long long B,
                                int K, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = ntiles(B, K);
  if (field == 0)
    binv_up_fr<<<nt, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, (int32_t*)tot, B, K,
                                      nt);
  else
    binv_up_fq<<<nt, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, (int32_t*)tot, B, K,
                                      nt);
  return (int)cudaGetLastError();
}

// Down over the same tiles: out (holding the prefixes) <- the inverses, from
// the inverted tile totals tinv.
extern "C" int tzk_batch_inv_down(int field, const void* a, void* out, const void* tinv,
                                  long long B, int K, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = ntiles(B, K);
  if (field == 0)
    binv_down_fr<<<nt, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out,
                                        (const int32_t*)tinv, B, K, nt);
  else
    binv_down_fq<<<nt, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out,
                                        (const int32_t*)tinv, B, K, nt);
  return (int)cudaGetLastError();
}
