"""Port field layer vs the JAX package: byte-equal limbs, every op.

Inputs are numpy limb arrays made from a seed (reduced values plus 0, 1,
p-1, the Montgomery one and its negation); both packages get the same arrays
and the outputs must agree byte for byte.  Tolerance: exact, everywhere.
The JAX side runs its native CPU backend; the port runs the plain PyTorch
versions of its kernels (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokamak_zk_evm_tpu.ops import field as JF
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import FQ, FR
from tokamak_zk_evm_tpu_torch.ops import field as TF

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

SPECS = {"fr": FR, "fq": FQ}


def rand_limbs(spec, shape, seed):
    """Reduced elements [L, *shape]; the first five hold 0, 1, p-1, R, -R."""
    rng = np.random.default_rng(seed)
    L = spec.n_limbs
    n = int(np.prod(shape))
    lim = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    lim[L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=n)
    p = spec.modulus
    for k, v in enumerate((0, 1, p - 1, spec.R_mod, (p - spec.R_mod) % p)[:n]):
        lim[:, k] = spec.to_limbs(v)
    return lim.reshape((L,) + tuple(shape)).astype(np.uint32)


def jax_out(x):
    return np.asarray(x).astype(np.uint32)


def port_out(t):
    assert t.dtype == torch.int32
    return t.numpy().astype(np.uint32)


def to_port(a):
    return torch.as_tensor(a.astype(np.int32))


BROADCASTS = {
    "equal": ((6, 5), (6, 5)),
    "scalar": ((6, 5), ()),
    "cyclic": ((6, 5), (5,)),
    "block": ((6, 5), (6,)),
    "square_suffix": ((4, 4), (4,)),
    "left_scalar": ((), (6, 5)),
}


@pytest.mark.parametrize("bname", sorted(BROADCASTS))
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_binop_matches_jax(field, op, bname):
    spec = SPECS[field]
    sa, sb = BROADCASTS[bname]
    a = rand_limbs(spec, sa, 1)
    b = rand_limbs(spec, sb, 2)
    want = jax_out(getattr(JF, f"{field}_{op}")(jnp.asarray(a), jnp.asarray(b)))
    got = port_out(getattr(TF, f"{field}_{op}")(to_port(a), to_port(b)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "inv"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_unop_matches_jax(field, op):
    spec = SPECS[field]
    a = rand_limbs(spec, (3, 7), 3)
    want = jax_out(getattr(JF, f"{field}_{op}")(jnp.asarray(a)))
    got = port_out(getattr(TF, f"{field}_{op}")(to_port(a)))
    assert np.array_equal(got, want)


def test_fr_batch_inv_with_zeros_matches_jax():
    a = rand_limbs(FR, (37,), 4)
    a[:, [7, 8, 30]] = 0
    want = jax_out(JF.fr_batch_inv(jnp.asarray(a)))
    got = port_out(TF.fr_batch_inv(to_port(a)))
    assert np.array_equal(got, want)


def test_fq_batch_inv_with_zeros_matches_host():
    """JAX keeps Fq batch inversion inside g1_to_affine; hold the port's
    against exact host inverses (0 -> 0)."""
    a = rand_limbs(FQ, (21,), 5)
    a[:, [4, 20]] = 0
    got = TF.unpack_fq(K.fq_batch_inv(to_port(a)))
    vals = TF.unpack_fq(to_port(a))
    want = [pow(int(v), -1, FQ.modulus) if v else 0 for v in vals]
    assert [int(v) for v in got] == want


@pytest.mark.parametrize("which", ["prefix", "suffix"])
def test_scan_products_match_jax(which):
    a = rand_limbs(FR, (5, 7), 6)
    want = jax_out(getattr(JF, f"fr_{which}_prod")(jnp.asarray(a)))
    got = port_out(getattr(TF, f"fr_{which}_prod")(to_port(a)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("which", ["sum", "suffix_sum"])
def test_sums_match_jax(which, axis):
    a = rand_limbs(FR, (5, 6), 7)
    want = jax_out(getattr(JF, f"fr_{which}")(jnp.asarray(a), axis=axis))
    got = port_out(getattr(TF, f"fr_{which}")(to_port(a), axis=axis))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mont", [True, False])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_pack_unpack_match_jax(field, mont):
    spec = SPECS[field]
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(12)]
    vals += [0, 1, spec.modulus - 1]
    jp = getattr(JF, f"pack_{field}")(vals, mont=mont)
    tp = getattr(TF, f"pack_{field}")(vals, mont=mont)
    assert np.array_equal(tp.astype(np.uint32), jp.astype(np.uint32))
    back = getattr(TF, f"unpack_{field}")(torch.as_tensor(tp), mont=mont)
    assert [int(v) for v in back] == vals


def test_constant_tables_match_jax():
    assert np.array_equal(TF.fr_powers(5, 33).astype(np.uint32),
                          JF.fr_powers(5, 33).astype(np.uint32))
    assert np.array_equal(TF.fr_mont(12345).astype(np.uint32),
                          JF.fr_mont(12345).astype(np.uint32))


def test_wrapper_rejects_other_devices():
    a = torch.zeros((16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.fr_add(a, a)


def test_wrapper_rejects_bad_layout():
    with pytest.raises(ValueError):
        K.fr_mul(torch.zeros((16, 4), dtype=torch.int64), torch.zeros((16, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        K.fq_add(torch.zeros((16, 4), dtype=torch.int32), torch.zeros((16, 4), dtype=torch.int32))
