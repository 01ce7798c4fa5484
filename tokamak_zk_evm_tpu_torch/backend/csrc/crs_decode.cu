// The rkyv CRS decode: G1 entries of a `combined_sigma.rkyv` or
// `sigma_preprocess.rkyv` section, as the file holds them, straight into a
// device family's limb columns in Montgomery form.
//
// Replaces no TPU kernel: the JAX package decodes these sections on the host
// (`tokamak_zk_evm_tpu/io/rkyv_crs.py` `_g1_family_from_section`: numpy byte
// shuffles to [24, n] limb columns, then one Fq product by R^2 on the device).
// Here the file's bytes cross the bus once (96 B a point, not 192 B of int32
// limbs) and one pass does the rest.
//
// An entry is 96 bytes: x then y, each 48 little-endian bytes (12 words);
// all zero is the point at infinity.  One thread decodes one entry: six
// 16-byte loads, two Fq products by R^2 (fq_chain.cuh, R^2 as the first
// operand, so any 384-bit word pattern in the file gives x R mod q fully
// reduced, as the plain version does), and the x and y limb columns and the
// infinity flag written at column `off + i` of the family, each limb row
// coalesced across the warp.
//
// Bound on the card: bytes.  96 B read and 2 x 96 B of limbs + a 4-byte flag
// written a point (292 B) against two products (~600 multiply-adds), far
// under the card's ops-per-byte balance; the file's reading and its copy
// over PCIe, which the wrapper's caller overlaps, take ~100 times longer.
#include "fq_chain.cuh"

namespace {

// Word k of R^2 mod q (R = 2^384).  Called with unrolled constant k only.
__device__ __forceinline__ constexpr uint32_t r2w(int k) {
  return k == 0 ? 0x1c341746u : k == 1 ? 0xf4df1f34u : k == 2 ? 0x09d104f1u
       : k == 3 ? 0x0a76e6a6u : k == 4 ? 0x4c95b6d5u : k == 5 ? 0x8de5476cu
       : k == 6 ? 0x939d83c0u : k == 7 ? 0x67eb88a9u : k == 8 ? 0xb519952du
       : k == 9 ? 0x9a793e85u : k == 10 ? 0x92cae3aau : 0x11988fe5u;
}

__device__ __forceinline__ void store_limbs(int32_t* p, long long i, long long B, const fqc::fe& x) {
#pragma unroll
  for (int k = 0; k < fqc::N; ++k) {
    p[(2 * k) * B + i] = (int32_t)(x[k] & 0xFFFFu);
    p[(2 * k + 1) * B + i] = (int32_t)(x[k] >> 16);
  }
}

// Entries i < n of `raw` (16-byte aligned) -> columns off + i of ox, oy
// ([24, B] limb-major) and oinf ([B]).
__global__ void __launch_bounds__(256)
crs_decode_kernel(const uint4* __restrict__ raw, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oinf, long long n,
                  long long off, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fqc::fe x, y, r2;
  fqc::load_fe(x, raw + 6 * i);
  fqc::load_fe(y, raw + 6 * i + 3);
  const bool inf = fqc::is_zero(x) && fqc::is_zero(y);
#pragma unroll
  for (int k = 0; k < fqc::N; ++k) r2[k] = r2w(k);
  fqc::mul(x, r2, x);
  fqc::mul(y, r2, y);
  store_limbs(ox, off + i, B, x);
  store_limbs(oy, off + i, B, y);
  oinf[off + i] = inf ? 1 : 0;
}

}  // namespace

// Decode n entries of raw into columns [off, off + n) of a family of width B.
extern "C" int tzk_crs_decode(const void* raw, void* ox, void* oy, void* oinf, long long n,
                              long long off, long long B, void* stream) {
  if (n <= 0) return 0;
  if (off < 0 || off + n > B) return (int)cudaErrorInvalidValue;
  const int T = 256;
  crs_decode_kernel<<<(unsigned)((n + T - 1) / T), T, 0, (cudaStream_t)stream>>>(
      (const uint4*)raw, (int32_t*)ox, (int32_t*)oy, (int32_t*)oinf, n, off, B);
  return (int)cudaGetLastError();
}
