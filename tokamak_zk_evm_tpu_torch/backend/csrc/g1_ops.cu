// B13: the complete jacobian add, the doubling and the to-affine step of
// BLS12-381 G1 points, one kernel each, one thread a lane.
//
// Replaces `g1_add` (824), `g1_dbl` (810) and `g1_to_affine` (867) of
// tokamak_zk_evm_tpu/backend/pallas_kernels.py, which the JAX package
// composes from its Pallas field kernels (`_ew_binop_fn` 267): some 25
// elementwise launches an add and a host-side case split, where these run
// the whole formula on the card and settle every case inside the kernel:
//
//   * add: an infinite P gives Q as it is, else an infinite Q gives P as it
//     is; P + P goes to the doubling, P + (-P) to infinity (1, 1, 0); the
//     same cases in the same order as the plain version (`backend/
//     kernels.py` jac_add), so every output word is equal to it, infinity's
//     representation included.  Q is broadcast as the K1 ops broadcast
//     their second operand: lane i reads Q at i when Bq == B, else at
//     (i / rep) % Bq (32-bit division when every size is below 2^31);
//   * dbl: dbl-2009-l; an infinite P gives (1, 1, 0);
//   * to affine: the wrapper inverts Z with K2's batch inversion (0 -> 0),
//     then g1_affine_kernel writes x = X zi^2, y = Y zi^3 and inf = (Z == 0)
//     in one pass (infinity comes out as (0, 0, 1)).
//
// Bound on the card: the IMAD units for the add and the doubling (16 and 7
// products of ~600 operations against 864 and 576 bytes a lane), bytes for
// the to-affine pass (4 products against 580 bytes).
//
// Design of the add and the doubling.  One inlined formula a thread ran at
// 5.0x and 3.9x the IMAD bound at 2^22 lanes (12.0 / 4.04 ms on an H100
// 80GB HBM3 at 700 W).  utils/bench_g1.py split that time with two probes
// (below): the loads and stores alone took 1.24 / 0.86 ms, the arithmetic
// alone on points in registers 5.08 / 2.15 ms, far less than the kernels.
// The whole formula was inlined (29,928 SASS instructions for the add,
// 9,640 for the doubling: ~480 / 154 KB of code), so warps that drift apart
// on their loads miss the instruction cache.  So:
//
//   * the formula is a program (g1_lazy.cuh: G1_ADD_PROGRAM, G1_DBL_PROGRAM)
//     over field slots in shared memory, interpreted by one loop: the code of
//     a product and of a squaring exists once a kernel (3,648 and 1,864 SASS
//     instructions).  A thread's slots are its own (word k of slot s at
//     (s 12 + k) T + t: a warp reads 32 consecutive words, no bank
//     conflicts, no barrier); 8 slots for the add (48 KB a block of 128) and
//     5 for the doubling;
//   * the arithmetic is g1_lazy.cuh's: values in [0, 2q) between steps (no
//     final subtract in a product, adds and subtracts modulo 2q), one
//     reduction as a coordinate leaves, products as two independent carry
//     chains a row whose (lo, hi) pairs ptxas fuses into IMAD.WIDE.U32.X, and
//     a dedicated squaring built the same way (4 of the add's 16 products
//     and 5 of the doubling's 7);
//   * with the points out of registers a thread needs at most 128 registers
//     (the doubling 89), so the add runs four blocks an SM and the doubling
//     five (T, ADD_BLOCKS and DBL_BLOCKS below); a sweep of block sizes
//     64-256 and of 2-10 blocks an SM, timed with utils/bench_g1.py on an
//     H100, stayed within 5% of these.  The loads are staged into the slots at
//     the start, coalesced (lane i at column i), and not overlapped by hand:
//     the SM's other warps cover them (the add 2.67 ms against 2.49 ms of
//     arithmetic alone and 1.26 ms of loads and stores alone, the doubling
//     1.22 against 1.11 and 0.87: 1.11x and 1.16x the IMAD bound);
//   * the cases: an infinite operand copies the other's limbs as they are
//     from device memory; H == R == 0 (mod q) loads P again and runs the
//     doubling's program through the same loop.
//
// Tensor cores are not used: no Hopper MMA mode gives the 32 x 32 -> 64-bit
// products with carries that a 381-bit Montgomery product needs.
#include "g1_lazy.cuh"

extern __shared__ uint32_t sm[];

namespace {

using fqc::fe;
using fqc::N;

constexpr int T = 128;         // threads (lanes) a block
constexpr int ADD_BLOCKS = 4;  // blocks an SM: the add's launch bounds (128 registers)
constexpr int DBL_BLOCKS = 5;  // the doubling's (89 registers)
constexpr fql::Step kAddSteps[] = {G1_ADD_PROGRAM};
constexpr fql::Step kDblSteps[] = {G1_DBL_PROGRAM};
constexpr int ADD_STEPS = sizeof(kAddSteps) / sizeof(fql::Step);
constexpr int DBL_STEPS = sizeof(kDblSteps) / sizeof(fql::Step);
constexpr int ADD_SMEM = fql::ADD_SLOTS * N * T * 4;  // bytes a block
constexpr int DBL_SMEM = fql::DBL_SLOTS * N * T * 4;
// within the 48 KB a launch may take without opting in
static_assert(ADD_SMEM <= 48 * 1024 && DBL_SMEM <= 48 * 1024, "slots past 48 KB a block");

// the add's program, then the doubling's at ADD_STEPS
__constant__ fql::Step kProg[ADD_STEPS + DBL_STEPS] = {G1_ADD_PROGRAM, G1_DBL_PROGRAM};

struct ConstProg {
  __device__ __forceinline__ fql::Step operator()(int s) const { return kProg[s]; }
};

// The slots of thread t: word k of slot s at p[(s N + k) T].
struct SmemSlots {
  uint32_t* p;
  __device__ __forceinline__ void load(fe& r, int s) const {
    const uint32_t* q = p + s * (N * T);
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = q[k * T];
  }
  __device__ __forceinline__ void store(int s, const fe& v) const {
    uint32_t* q = p + s * (N * T);
#pragma unroll
    for (int k = 0; k < N; ++k) q[k * T] = v[k];
  }
};

__device__ __forceinline__ void load_limbs(fe& r, const int32_t* __restrict__ p, long long i,
                                           long long B) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    r[k] = ((uint32_t)__ldg(p + (2 * k) * B + i) & 0xFFFFu) |
           ((uint32_t)__ldg(p + (2 * k + 1) * B + i) << 16);
}

__device__ __forceinline__ void store_limbs(int32_t* p, long long i, long long B, const fe& x) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[(2 * k) * B + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * B + i] = (int32_t)(x[k] >> 16);
  }
}

// lane i's coordinates (x, y, z) -> slots s, s + 1, s + 2
__device__ __forceinline__ void stage(const SmemSlots& S, int s, const int32_t* x,
                                      const int32_t* y, const int32_t* z, long long i,
                                      long long B) {
  fe w;
  load_limbs(w, x, i, B);
  S.store(s, w);
  load_limbs(w, y, i, B);
  S.store(s + 1, w);
  load_limbs(w, z, i, B);
  S.store(s + 2, w);
}

// slots sx, sy, sz, reduced into [0, q) -> lane i of the outputs
__device__ __forceinline__ void put(const SmemSlots& S, int sx, int sy, int sz, int32_t* ox,
                                    int32_t* oy, int32_t* oz, long long i, long long B) {
  fe v, w;
  S.load(v, sx);
  fql::reduce(w, v);
  store_limbs(ox, i, B, w);
  S.load(v, sy);
  fql::reduce(w, v);
  store_limbs(oy, i, B, w);
  S.load(v, sz);
  fql::reduce(w, v);
  store_limbs(oz, i, B, w);
}

__device__ __forceinline__ void put_inf(int32_t* ox, int32_t* oy, int32_t* oz, long long i,
                                        long long B) {
  fe one, zero;
  fqc::set_one(one);
  fqc::set_zero(zero);
  store_limbs(ox, i, B, one);
  store_limbs(oy, i, B, one);
  store_limbs(oz, i, B, zero);
}

// lane j of a [24, Bc] coordinate, its limbs as they are -> lane i of o
__device__ __forceinline__ void copy_limbs(int32_t* o, long long i, long long B,
                                           const int32_t* __restrict__ c, long long j,
                                           long long Bc) {
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) o[k * B + i] = __ldg(c + k * Bc + j);
}

// p, which the compiler may not prove equal to p: addresses computed from it
// again are not the ones kept from the staging, which would stay live
// (spilled) across the whole program
__device__ __forceinline__ const int32_t* fresh(const int32_t* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ bool zero_slot(const SmemSlots& S, int s) {
  fe v;
  S.load(v, s);
  return fqc::is_zero(v);
}

// the lane of Q that lane i reads
__device__ __forceinline__ long long q_lane(long long i, long long B, long long Bq,
                                            long long rep) {
  if (Bq == B) return i;
  if ((B | Bq | rep) <= 0x7fffffffLL)
    return (long long)(((uint32_t)i / (uint32_t)rep) % (uint32_t)Bq);
  return (i / rep) % Bq;
}

__global__ void __launch_bounds__(T, ADD_BLOCKS)
g1_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
              const int32_t* __restrict__ y2, const int32_t* __restrict__ z2, long long Bq,
              long long rep, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const long long j = q_lane(i, B, Bq, rep);
  const SmemSlots S{sm + threadIdx.x};
  stage(S, 0, x1, y1, z1, i, B);
  stage(S, 3, x2, y2, z2, j, Bq);
  if (zero_slot(S, 2)) {  // P infinite: Q
    copy_limbs(ox, i, B, fresh(x2), j, Bq);
    copy_limbs(oy, i, B, fresh(y2), j, Bq);
    copy_limbs(oz, i, B, fresh(z2), j, Bq);
    return;
  }
  if (zero_slot(S, 5)) {  // Q infinite: P
    copy_limbs(ox, i, B, fresh(x1), i, B);
    copy_limbs(oy, i, B, fresh(y1), i, B);
    copy_limbs(oz, i, B, fresh(z1), i, B);
    return;
  }
  // the add's program; on H == R == 0 the doubling's, through the same loop
  int begin = 0, end = ADD_STEPS;
  int sx = fql::ADD_X3, sy = fql::ADD_Y3, sz = fql::ADD_Z3;
#pragma unroll 1
  for (;;) {
    fql::run(S, ConstProg{}, begin, end);
    if (begin != 0) break;
    fe h;
    S.load(h, fql::ADD_H);
    if (!fql::is_zero_mod(h)) break;
    S.load(h, fql::ADD_R);
    if (!fql::is_zero_mod(h)) {  // P + (-P)
      put_inf(ox, oy, oz, i, B);
      return;
    }
    stage(S, 0, fresh(x1), fresh(y1), fresh(z1), i, B);  // P + P
    begin = ADD_STEPS;
    end = ADD_STEPS + DBL_STEPS;
    sx = fql::DBL_X3, sy = fql::DBL_Y3, sz = fql::DBL_Z3;
  }
  put(S, sx, sy, sz, ox, oy, oz, i, B);
}

__global__ void __launch_bounds__(T, DBL_BLOCKS)
g1_dbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const SmemSlots S{sm + threadIdx.x};
  stage(S, 0, x, y, z, i, B);
  if (zero_slot(S, 2)) {
    put_inf(ox, oy, oz, i, B);
    return;
  }
  fql::run(S, ConstProg{}, ADD_STEPS, ADD_STEPS + DBL_STEPS);
  put(S, fql::DBL_X3, fql::DBL_Y3, fql::DBL_Z3, ox, oy, oz, i, B);
}

__global__ void __launch_bounds__(128)
g1_affine_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, const int32_t* __restrict__ zinv, int32_t* ox,
                 int32_t* oy, int32_t* oinf, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fe zi, zi2, t, v;
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

// --- probes: the decomposition of the add's and the doubling's time ------
// (utils/bench_g1.py only; no op calls them)
//   g1_probe_io_add: the add's staging and stores alone (P ^ Q, word by
//     word, out through the same slots);
//   g1_probe_io_dbl: the doubling's (P staged and stored back);
//   g1_probe_math_add / _dbl: the kernels' programs alone on points made in
//     the slots from the lane index (no loads; Z != 0 and H != 0, so every
//     lane takes the generic formula), one word stored a lane.

__global__ void __launch_bounds__(T, ADD_BLOCKS)
g1_probe_io_add(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                const int32_t* __restrict__ y2, const int32_t* __restrict__ z2, long long Bq,
                long long rep, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const SmemSlots S{sm + threadIdx.x};
  stage(S, 0, x1, y1, z1, i, B);
  stage(S, 3, x2, y2, z2, q_lane(i, B, Bq, rep), Bq);
  int32_t* out[3] = {ox, oy, oz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fe u, v;
    S.load(u, c);
    S.load(v, c + 3);
#pragma unroll
    for (int k = 0; k < N; ++k) u[k] ^= v[k];
    store_limbs(out[c], i, B, u);
  }
}

__global__ void __launch_bounds__(T, DBL_BLOCKS)
g1_probe_io_dbl(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                const int32_t* __restrict__ z, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const SmemSlots S{sm + threadIdx.x};
  stage(S, 0, x, y, z, i, B);
  int32_t* out[3] = {ox, oy, oz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fe u;
    S.load(u, c);
    store_limbs(out[c], i, B, u);
  }
}

// a point's words below q (top word < 2^28) into slots s..s+2, from a linear
// congruential sequence
__device__ __forceinline__ void lane_pt(const SmemSlots& S, int s, uint32_t seed) {
  uint32_t r = seed * 0x9e3779b9u + 0x7f4a7c15u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fe v;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = (r = r * 1664525u + 1013904223u);
    v[0] |= 1u;
    v[N - 1] &= 0x0fffffffu;
    S.store(s + c, v);
  }
}

__device__ __forceinline__ uint32_t fold(const SmemSlots& S, int sx, int sy, int sz) {
  uint32_t h = 0u;
  const int s3[3] = {sx, sy, sz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fe v, w;
    S.load(v, s3[c]);
    fql::reduce(w, v);
#pragma unroll
    for (int k = 0; k < N; ++k) h ^= w[k];
  }
  return h;
}

__global__ void __launch_bounds__(T, ADD_BLOCKS) g1_probe_math_add(int32_t* out, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const SmemSlots S{sm + threadIdx.x};
  lane_pt(S, 0, (uint32_t)i);
  lane_pt(S, 3, (uint32_t)i ^ 0x5bd1e995u);
  fql::run(S, ConstProg{}, 0, ADD_STEPS);
  out[i] = (int32_t)fold(S, fql::ADD_X3, fql::ADD_Y3, fql::ADD_Z3);
}

__global__ void __launch_bounds__(T, DBL_BLOCKS) g1_probe_math_dbl(int32_t* out, long long B) {
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= B) return;
  const SmemSlots S{sm + threadIdx.x};
  lane_pt(S, 0, (uint32_t)i);
  fql::run(S, ConstProg{}, ADD_STEPS, ADD_STEPS + DBL_STEPS);
  out[i] = (int32_t)fold(S, fql::DBL_X3, fql::DBL_Y3, fql::DBL_Z3);
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
  g1_add_kernel<<<nblocks(B, T), T, ADD_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, Bq, rep, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, B);
  return (int)cudaGetLastError();
}

extern "C" int tzk_g1_dbl(const void* x, const void* y, const void* z, void* ox, void* oy,
                          void* oz, long long B, void* stream) {
  if (B <= 0) return 0;
  g1_dbl_kernel<<<nblocks(B, T), T, DBL_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, B);
  return (int)cudaGetLastError();
}

// zinv: the batch inverse of z (0 -> 0); oinf: int32 [B].
extern "C" int tzk_g1_affine(const void* x, const void* y, const void* z, const void* zinv,
                             void* ox, void* oy, void* oinf, long long B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  g1_affine_kernel<<<nblocks(B, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)zinv, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oinf, B);
  return (int)cudaGetLastError();
}

// utils/bench_g1.py's probes (see above): which 0 the add's loads and stores
// (the add's arguments), 1 the doubling's (x, y, z -> ox, oy, oz), 2 the
// add's arithmetic and 3 the doubling's (one int32 a lane into ox).
extern "C" int tzk_g1_probe(int which, const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2, long long Bq,
                            long long rep, void* ox, void* oy, void* oz, long long B,
                            void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = nblocks(B, T);
  if (which == 0)
    g1_probe_io_add<<<g, T, ADD_SMEM, st>>>(
        (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
        (const int32_t*)y2, (const int32_t*)z2, Bq, rep, (int32_t*)ox, (int32_t*)oy,
        (int32_t*)oz, B);
  else if (which == 1)
    g1_probe_io_dbl<<<g, T, DBL_SMEM, st>>>((const int32_t*)x1, (const int32_t*)y1,
                                            (const int32_t*)z1, (int32_t*)ox, (int32_t*)oy,
                                            (int32_t*)oz, B);
  else if (which == 2)
    g1_probe_math_add<<<g, T, ADD_SMEM, st>>>((int32_t*)ox, B);
  else if (which == 3)
    g1_probe_math_dbl<<<g, T, DBL_SMEM, st>>>((int32_t*)ox, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
