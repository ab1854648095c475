"""platinum_tpu_torch.ops.threefry vs jax.random: PRNGKey, fold_in and
uniform bitwise equal (the partitionable threefry layout, JAX's default),
for several keys and for draws of 1, 513 and 262,144 values."""

import jax
import numpy as np
import pytest

from platinum_tpu_torch.ops import threefry

SEEDS = (0, 1, 42, 2**31 - 1)


def _key(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    assert threefry.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))
    jk, pk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for data in (0, 3, 12_345, 2**31 - 1):
        jk, pk = jax.random.fold_in(jk, data), threefry.fold_in(pk, data)
        assert pk == _key(jk), (seed, data)


@pytest.mark.parametrize("n", [1, 513, 262_144])
def test_uniform_bitwise(n):
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), 7), 2)
        pk = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(seed), 7), 2)
        ref = np.asarray(jax.random.uniform(jk, (n,)), np.float32)
        got = threefry.uniform(pk, n).numpy()
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_random_bits_bitwise():
    jk = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.bits(jk, (1000,), dtype=np.uint32))
    got = threefry.random_bits(threefry.PRNGKey(5), 1000).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
