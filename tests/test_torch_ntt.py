"""Port NTT vs the JAX package: byte-equal grids.

`ntt_batched` and `bintt` on grids (8, 4), (256, 32) and (64, 1024), on
grids whose transforms cross the kernel's one-pass tile ((4096, 2),
(2, 4096), (8192, 4)), and with n = 2 and n = 4, with and without cosets,
forward and inverse; the inverse undoes the forward.  `ntt_axis` (`fr_ntt`
with `ops.ntt`'s tables, a coset as one Fr product) along either axis
against the JAX transform of the same axis.  Inputs are numpy limb arrays
from a seed.  Tolerance: exact.  `fr_ntt` takes transforms of any length:
the four-step split it runs on the card past the kernel's two passes
(`ntt_split`) is held to the plain version and to JAX at small n.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokamak_zk_evm_tpu.ops import ntt as JN
from tokamak_zk_evm_tpu_torch.backend import kernels as TK
from tokamak_zk_evm_tpu_torch.fields import FR
from tokamak_zk_evm_tpu_torch.ops import ntt as TN

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

GRIDS = [(8, 4), (256, 32), (64, 1024), (4096, 2), (2, 4096), (8192, 4), (2, 4), (4, 2)]
COSETS = {"plain": (None, None), "coset": (7, 5)}


def rand_grid(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    lim = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    lim[15] = rng.integers(0, FR.modulus >> 240, size=n)
    lim[:, 0] = 0
    lim[:, 1] = FR.to_limbs(FR.modulus - 1)
    return lim.reshape((16,) + shape).astype(np.uint32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("cname", sorted(COSETS))
@pytest.mark.parametrize("shape", GRIDS)
def test_bintt_matches_jax(shape, cname, inverse):
    cx, cy = COSETS[cname]
    g = rand_grid(shape, sum(shape))
    want = np.asarray(JN.bintt(jnp.asarray(g), inverse=inverse, coset_x=cx, coset_y=cy))
    got = TN.bintt(torch.as_tensor(g.astype(np.int32)), inverse=inverse, coset_x=cx,
                   coset_y=cy)
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("cname", sorted(COSETS))
@pytest.mark.parametrize("shape", GRIDS)
def test_bintt_inverse_undoes_forward(shape, cname):
    cx, cy = COSETS[cname]
    g = torch.as_tensor(rand_grid(shape, 3).astype(np.int32))
    back = TN.bintt(TN.bintt(g, coset_x=cx, coset_y=cy), inverse=True, coset_x=cx,
                    coset_y=cy)
    assert torch.equal(back, g)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batched_matches_jax(inverse):
    g = rand_grid((3, 2, 16), 4)
    want = np.asarray(JN.ntt_batched(jnp.asarray(g), inverse=inverse, coset=11))
    got = TN.ntt_batched(torch.as_tensor(g.astype(np.int32)), inverse=inverse, coset=11)
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))


def test_ntt_of_length_one_is_identity():
    g = torch.as_tensor(rand_grid((5, 1), 5).astype(np.int32))
    assert TN.ntt_batched(g) is g


@pytest.mark.parametrize("coset", [None, 7])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", [1, 2])
def test_fr_ntt_axis_matches_jax(axis, inverse, coset):
    """`fr_ntt` along `axis`, through `ops.ntt.ntt_axis` (its twiddle and
    n^-1 tables, and the coset's c^j before or c^-j after it) == the JAX
    package's `ntt_batched` of that axis."""
    g = rand_grid((32, 16), 6 + axis)
    n = g.shape[axis]
    moved = np.moveaxis(g, axis, -1)
    want = np.moveaxis(np.asarray(JN.ntt_batched(jnp.asarray(moved), inverse=inverse,
                                                 coset=coset)), -1, axis)
    got = TN.ntt_axis(torch.as_tensor(g.astype(np.int32)), axis, inverse, coset)
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("axis", [1, 2])
def test_fr_ntt_refuses_transforms_past_two_passes(axis, monkeypatch):
    """The ceiling is gone: with `NTT_MAX_N` lowered to 16, a 64-point
    transform along either axis is no longer refused; the CPU route takes
    the plain version at any length (on the card, longer transforms run as
    `ntt_split`), and it equals the JAX transform."""
    assert TK.NTT_MAX_N == 1 << 22
    monkeypatch.setattr(TK, "NTT_MAX_N", 16)
    g = rand_grid((64, 3) if axis == 1 else (3, 64), 20 + axis)
    pows, scale = TN._tables.__wrapped__(64, True, torch.device("cpu"))
    got = TK.fr_ntt(torch.as_tensor(g.astype(np.int32)), pows, scale, axis)
    moved = np.moveaxis(g, axis, -1)
    want = np.moveaxis(np.asarray(JN.ntt_batched(jnp.asarray(moved), inverse=True)), -1, axis)
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("shape,n1", [((1024, 1), 32), ((1024, 3), 32), ((256, 2), 4),
                                      ((4, 2), 2)])
def test_ntt_split_matches_plain_and_jax(shape, n1, axis, inverse):
    """The four-step split `fr_ntt` takes past `NTT_MAX_N` on the card,
    called directly at small n (2^10 as 2^5 x 2^5, 2^8 as 2^6 x 2^2, 2^2 as
    2 x 2) along either axis: == `plain_ntt` == the JAX transform, exact."""
    if axis == 2:
        shape = shape[::-1]
    g = rand_grid(shape, 30 + shape[0] + axis)
    n = g.shape[axis]
    pows, scale = TN._tables.__wrapped__(n, inverse, torch.device("cpu"))
    data = torch.as_tensor(g.astype(np.int32))
    got = TK.ntt_split(data, pows, scale, axis, n1)
    assert torch.equal(got, TK.plain_ntt(data, pows, scale, axis))
    moved = np.moveaxis(g, axis, -1)
    want = np.moveaxis(np.asarray(JN.ntt_batched(jnp.asarray(moved), inverse=inverse)), -1, axis)
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))
