// K4: the fixed-base kernel of trusted setup, k_i * G from a window table
// of G.  (The two device stages of the Pippenger MSM are in msm.cu.)
//
// Replaces `_fixed_base_apply_fn` (2177) behind `g1_fixed_base` (2159) in
// tokamak_zk_evm_tpu/backend/pallas_kernels.py, whose adds are
// `_jac_add_fused_fn` (961): 32 windows of 8 bits against a 32 x 256 affine
// table.  Here the window is `bits` wide: 12 on the main path (22 windows
// cover r < 2^255, so 22 adds a scalar, not 32), against a 22 x 4096 table
// that the wrapper builds on the card with this kernel at 8 bits
// (`backend/kernels.py` fixed_base_table).
//
// Every add is complete (fq_chain.cuh add_affine): digits repeat across
// scalars, and a partial sum can equal the table point it meets.
//
// Bound on the card: operations.  A mixed add is 11 Fq products of ~300
// 32-bit multiply-adds against 96 B of table point, so the design keeps the
// arithmetic in registers and the warps busy, as the bucket sum's affine
// pass does with the same add: one thread per scalar, products on PTX carry
// chains, every curve function inlined (no stack frame, no spills), three
// 128-thread blocks an SM; a table point is six 16-byte loads of an
// L2-resident table (8.6 MB at 12 bits).  A digit is read from the scalar's
// limbs as its window comes (two 4-byte loads), which keeps eight words of
// scalar out of the registers the add needs.
#include "fq_chain.cuh"

namespace {

using fqc::Pt;

__device__ __forceinline__ void store_limbs(int32_t* p, long long i, long long B, const fqc::fe& x) {
#pragma unroll
  for (int k = 0; k < fqc::N; ++k) {
    p[(2 * k) * B + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * B + i] = (int32_t)(x[k] >> 16);
  }
}

// out[i] = k_i * G (jacobian, limb-major [24, B] each) for canonical scalars
// [16, B]; table: [nwin << bits, 24] words, entry (w << bits) + d holds
// d 2^(bits w) G affine (d = 0 is never read).
__global__ void __launch_bounds__(128, 3)
fixed_base_kernel(const int32_t* __restrict__ sc, const uint4* __restrict__ table, int bits,
                  int nwin, int32_t* ox, int32_t* oy, int32_t* oz, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t mask = (1u << bits) - 1u;
  Pt acc;
  fqc::set_inf(acc);
#pragma unroll 1
  for (int w = 0; w < nwin; ++w) {
    const int o = w * bits, l = o >> 4;  // digit: bits [o, o + bits), limbs l and l + 1
    uint32_t v = (uint32_t)__ldg(sc + l * B + i) & 0xFFFFu;
    if (l + 1 < 16) v |= ((uint32_t)__ldg(sc + (l + 1) * B + i) & 0xFFFFu) << 16;
    const uint32_t d = (v >> (o & 15)) & mask;
    if (d == 0u) continue;
    fqc::fe qx, qy;
    fqc::load_affine(qx, qy, table, ((long long)w << bits) + d);
    fqc::add_affine(acc, qx, qy);
  }
  store_limbs(ox, i, B, acc.X);
  store_limbs(oy, i, B, acc.Y);
  store_limbs(oz, i, B, acc.Z);
}

}  // namespace

// bits <= 16: windows of `bits` bits, ceil(255 / bits) of them.
extern "C" int tzk_g1_fixed_base(const void* scalars, const void* table, int bits, void* ox,
                                 void* oy, void* oz, long long B, void* stream) {
  if (B <= 0) return 0;
  if (bits < 1 || bits > 16) return (int)cudaErrorInvalidValue;
  const int T = 128;
  fixed_base_kernel<<<(unsigned)((B + T - 1) / T), T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scalars, (const uint4*)table, bits, (255 + bits - 1) / bits,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, B);
  return (int)cudaGetLastError();
}
