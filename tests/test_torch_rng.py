"""Counted RNG of the PyTorch port against ``jax.random``, bit for bit.

Everything else in the port's parity tests rests on this: the same key must
give the same uniforms.  Exact tolerance (raw float bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import rng  # noqa: E402
from repro_torch.core.select import rejection_randoms  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 123456, -1, 2**31 - 1])
def test_prng_key_words(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(rng.PRNGKey(seed), ref)


@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("data", [0, 1, 2, 39, 2**31 - 1])
def test_fold_in_words(seed, data):
    ref = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    np.testing.assert_array_equal(rng.fold_in(rng.PRNGKey(seed), data), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("data", [0, 1, 2, 39])
@pytest.mark.parametrize("n", [1, 7, 128, 4099])
def test_uniform_bits(seed, data, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    ref = jax.random.uniform(key, (n,), dtype=jnp.float32)
    got = rng.uniform(rng.fold_in(rng.PRNGKey(seed), data), (n,), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_key_from_jax_array_and_uniform_many():
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    key = rng.key_from_array(np.asarray(jax.random.key_data(jkey)))
    keys = np.stack([rng.fold_in(key, t) for t in range(3)])
    many = rng.uniform_many(keys, 33, device="cpu")
    for t in range(3):
        ref = jax.random.uniform(jax.random.fold_in(jkey, t), (33,), dtype=jnp.float32)
        np.testing.assert_array_equal(_bits(many[t].numpy()), _bits(ref))


def test_uniform_rejects_multi_dim_shapes():
    with pytest.raises(ValueError):
        rng.uniform(rng.PRNGKey(0), (2, 3))


@pytest.mark.parametrize("w", [1, 37])
def test_rejection_randoms_layout(w):
    from repro.core import select as jsel

    jkey = jax.random.PRNGKey(9)
    ref = jsel.rejection_randoms(jkey, (w,))
    got = rejection_randoms(rng.key_from_array(jax.random.key_data(jkey)), (w,), device="cpu")
    assert got.shape == (w, 8, 2) and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
