"""Port NTT vs the JAX package: byte-equal grids.

`ntt_batched` and `bintt` on grids (8, 4), (256, 32) and (64, 1024), on
grids whose transforms cross the kernel's one-pass tile ((4096, 2),
(2, 4096), (8192, 4)), and with n = 2 and n = 4, with and without cosets,
forward and inverse; the inverse undoes the forward.  `ntt_axis` (`fr_ntt`
with `ops.ntt`'s tables, a coset as one Fr product) along either axis
against the JAX transform of the same axis.  Inputs are numpy limb arrays
from a seed.  Tolerance: exact.  `fr_ntt` refuses a transform longer than
its kernel's two passes hold, on either route.
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
def test_fr_ntt_refuses_transforms_past_two_passes(axis):
    """n = 2^23 along either axis: `fr_ntt` names its ceiling, 2^22 points
    (an expanded view, so no grid is allocated)."""
    shape = [16, 1, 1]
    shape[axis] = 1 << 23
    grid = torch.zeros((16, 1, 1), dtype=torch.int32).expand(shape)
    pows = torch.zeros((16, 1), dtype=torch.int32).expand(16, 1 << 23)
    with pytest.raises(ValueError, match=r"NTT_MAX_N = 2\^22"):
        TK.fr_ntt(grid, pows, axis=axis)
    assert TK.NTT_MAX_N == 1 << 22
