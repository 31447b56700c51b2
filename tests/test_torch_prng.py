"""The port's threefry2x32 (``repro_torch.prng``) against ``jax.random`` as
this tree runs it (``jax_threefry_partitionable=True``, 32-bit mode): every
key, split, fold-in and draw must be bit-exact, over several seeds and 1-D,
2-D and odd shapes. Batched keys must equal JAX's ``vmap`` over the keys.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import key as bridge_key
from repro_torch import prng
from repro_torch.interop import key_from_numpy

SEEDS = [0, 1, 42, 2 ** 31 - 1, -7]
SHAPES = [(1,), (5,), (17,), (3, 7), (16, 100), (4, 3, 5)]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_threefry_partitionable_is_the_mode_ported():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2 ** 32 + 5])
def test_prngkey(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7, 40])
def test_split(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    assert tuple(got.shape) == (num, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  _u32(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 + 3])
def test_fold_in(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(got.numpy(),
                                  _u32(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits(seed, shape):
    got = prng.bits(prng.PRNGKey(seed), shape)
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _u32(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(16,), (3, 7), (4, 3, 5)])
@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 6000), (-5, 17), (0, 100_000), (3, 3)])
def test_randint(seed, shape, lo, hi):
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_keys_match_vmap():
    jkeys = jax.random.split(jax.random.PRNGKey(3), 5)
    keys = prng.split(prng.PRNGKey(3), 5)
    np.testing.assert_array_equal(prng.split(keys, 3).numpy(),
                                  _u32(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)))
    np.testing.assert_array_equal(
        prng.randint(keys, (16,), 0, 256).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (16,), 0, 256))(jkeys)))
    np.testing.assert_array_equal(
        prng.bits(keys, (2, 3)).numpy(),
        _u32(jax.vmap(lambda k: jax.random.bits(k, (2, 3), jnp.uint32))(jkeys)))
    np.testing.assert_array_equal(
        prng.fold_in(keys, 9).numpy(),
        _u32(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jkeys)))


def test_key_crosses_the_bridge():
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    k = bridge_key(jk)
    np.testing.assert_array_equal(prng.split(k, 3).numpy(), _u32(jax.random.split(jk, 3)))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))


def test_threefry_on_ints_equals_on_tensors():
    """The hash takes Python ints (one key, few counters) and tensors alike."""
    ints = [prng.threefry2x32(7, 2 ** 32 - 1, 0, i) for i in range(5)]
    t1, t2 = prng.threefry2x32(7, 2 ** 32 - 1, 0, torch.arange(5, dtype=torch.int64))
    assert [p[0] for p in ints] == t1.tolist()
    assert [p[1] for p in ints] == t2.tolist()
