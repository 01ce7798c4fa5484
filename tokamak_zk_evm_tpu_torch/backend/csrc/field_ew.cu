// K1: elementwise Fr / Fq add, sub, Montgomery mul and negation.
//
// Replaces `_ew_binop_fn` / `_ew_kernel` and `_ew_unop_fn` / `_un_kernel`
// (tokamak_zk_evm_tpu/backend/pallas_kernels.py:212-313): one thread per
// element, operands in the [L, B] 16-bit-limb interchange layout.  b is read
// at (i / rep) % Bb, which covers the equal-shape case, a scalar b (Bb == 1),
// cyclic suffix tiling (rep == 1) and block broadcast (rep == inner extent),
// the same stride model as the TPU kernel's scalar/`rep` broadcast.
//
// Bound on the card: bytes.  An add moves 3 x 64 B (Fr) per element for a few
// dozen integer ops; even the Fq mul (~300 32-bit multiply-adds) stays under
// the memory roofline at 3.35 TB/s.  Neighbouring threads read neighbouring
// addresses of every limb row, so each warp load is one coalesced 128 B line.
#include "field.cuh"

namespace {

enum Op { ADD = 0, SUB = 1, MUL = 2, NEG = 3 };

template <class F, int OP>
__global__ void ew_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                          int32_t* __restrict__ out, long long Ba, long long Bb,
                          long long rep) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ba) return;
  uint32_t x[F::N], r[F::N];
  tzk::load<F>(x, a, i, Ba);
  if (OP == NEG) {
    tzk::neg<F>(r, x);
  } else {
    long long ib = (Bb == Ba) ? i : (i / rep) % Bb;
    uint32_t y[F::N];
    tzk::load<F>(y, b, ib, Bb);
    if (OP == ADD) tzk::add<F>(r, x, y);
    else if (OP == SUB) tzk::sub<F>(r, x, y);
    else tzk::mul<F>(r, x, y);
  }
  tzk::store<F>(out, i, Ba, r);
}

template <class F>
void launch(int op, const int32_t* a, const int32_t* b, int32_t* out, long long Ba,
            long long Bb, long long rep, cudaStream_t s) {
  const int T = 256;
  unsigned blocks = (unsigned)((Ba + T - 1) / T);
  switch (op) {
    case ADD: ew_kernel<F, ADD><<<blocks, T, 0, s>>>(a, b, out, Ba, Bb, rep); break;
    case SUB: ew_kernel<F, SUB><<<blocks, T, 0, s>>>(a, b, out, Ba, Bb, rep); break;
    case MUL: ew_kernel<F, MUL><<<blocks, T, 0, s>>>(a, b, out, Ba, Bb, rep); break;
    default: ew_kernel<F, NEG><<<blocks, T, 0, s>>>(a, b, out, Ba, Bb, rep); break;
  }
}

}  // namespace

// field: 0 = Fr, 1 = Fq.  op: 0 add, 1 sub, 2 mul, 3 neg (b unused).
extern "C" int tzk_field_ew(int field, int op, const void* a, const void* b, void* out,
                            long long Ba, long long Bb, long long rep, void* stream) {
  if (Ba <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  if (field == 0) launch<tzk::Fr>(op, pa, pb, po, Ba, Bb, rep, s);
  else launch<tzk::Fq>(op, pa, pb, po, Ba, Bb, rep, s);
  TZK_LAUNCH_CHECK();
}
