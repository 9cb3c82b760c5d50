"""Counted RNG of the PyTorch port against ``jax.random``, bit for bit.

Everything else in the port's parity tests rests on this: the same key must
give the same uniforms.  Exact tolerance (raw float bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels.ref import rejection_randoms  # noqa: E402


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


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [(37, 1), (37, 1, 1), (37, 8), (5, 32, 8)])
def test_multi_dim_uniform_bits(seed, shape):
    """Element i of the row-major order hashes counter i, whatever the shape."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    ref = jax.random.uniform(key, shape, dtype=jnp.float32)
    got = rng.uniform(rng.fold_in(rng.PRNGKey(seed), 3), shape, device="cpu")
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("seed", [0, 123456])
@pytest.mark.parametrize("num", [2, 5])
def test_split_words(seed, num):
    ref = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), num)))
    np.testing.assert_array_equal(rng.split(rng.PRNGKey(seed), num), ref)


@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 7), (0, 257), (5, 17), (0, 65_535), (0, 65_536), (0, 70_001),
    (0, 1 << 21), (0, 2_097_157), (0, 2**31 - 1), (3, 3),
])
def test_randint_values(lo, hi):
    """``randint`` equals ``jax.random.randint`` for spans below and above
    2^16, where JAX's uint32 products wrap."""
    key = jax.random.fold_in(jax.random.PRNGKey(lo + hi), 1)
    ref = np.asarray(jax.random.randint(key, (513,), lo, hi))
    got = rng.randint(rng.key_from_array(jax.random.key_data(key)), (513,), lo, hi, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w", [1, 37])
def test_rejection_randoms_layout(w):
    from repro.core import select as jsel

    jkey = jax.random.PRNGKey(9)
    ref = jsel.rejection_randoms(jkey, (w,))
    got = rejection_randoms(rng.key_from_array(jax.random.key_data(jkey)), (w,), device="cpu")
    assert got.shape == (w, 8, 2) and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n", [1, 37, 4099])
def test_uniform_at_equals_sliced_uniform(seed, n):
    """The counter-subset draw is the full draw's slice, bit for bit, for
    any subset and order of counters (the ITS and alias tails hash only
    their walkers)."""
    key = rng.fold_in(rng.PRNGKey(seed), 1)
    full = rng.uniform(key, (n,), device="cpu")
    idx = torch.from_numpy(np.random.default_rng(seed).permutation(n)[: max(1, n // 3)])
    got = rng.uniform_at(key, idx)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(full[idx].numpy()))
    ref = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), 1), (n,))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(ref)[idx.numpy()]))


def test_hash_uniform_on_cpu_equals_uniform_many():
    """The device hash's entry point, on CPU tensors, is the plain hash:
    the 16 round keys of a rejection step over W counters."""
    from repro_torch.kernels.threefry import hash_uniform

    kb = rng.fold_in(rng.PRNGKey(3), 2)
    keys = np.stack([rng.fold_in(kb, t) for t in range(16)])
    got = hash_uniform(keys, torch.arange(301, dtype=torch.int64))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(rng.uniform_many(keys, 301, device="cpu").numpy()))
    assert hash_uniform.launches == 0


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("lo,hi", [(-3.0, 7.5), (0.1, 0.2), (-1e3, 1e-3), (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_range_bits(seed, lo, hi):
    """``jax.random.uniform`` with ``minval``/``maxval``: XLA fuses the
    scale and shift into one multiply-add, which the port rounds once."""
    key = jax.random.PRNGKey(seed)
    ref = jax.random.uniform(key, (333, 17), minval=lo, maxval=hi)
    got = rng.uniform_range(np.asarray(jax.random.key_data(key)), (333, 17), lo, hi)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(7,), (16, 100), (3, 8, 37), (600, 513)])
def test_gumbel_bits(shape):
    key = jax.random.PRNGKey(sum(shape))
    ref = jax.random.gumbel(key, shape, dtype=jnp.float32)
    got = rng.gumbel(np.asarray(jax.random.key_data(key)), shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_xla_log_bits():
    """XLA-CPU's f32 ``log`` (where ``torch.log`` rounds otherwise for
    about 7 % of inputs), on [0, 4), on powers of two down to the smallest
    normal, on large values and on the special values."""
    r = np.random.default_rng(0)
    x = np.concatenate([
        r.random(400_000) * 4, 2.0 ** -r.uniform(0, 126, 100_000), r.random(100_000) * 1e30,
        [0.0, -0.0, 1.0, np.inf, -1.0, 1e-40, np.finfo(np.float32).tiny, np.nan, 3e38],
    ]).astype(np.float32)
    ref = np.asarray(jnp.log(jnp.asarray(x)))
    got = rng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert (_bits(torch.log(torch.from_numpy(x)).numpy()) != _bits(ref)).sum() > 1000


@pytest.mark.parametrize("fn", ["uniform", "gumbel", "many"])
def test_offset_draws_are_the_batch_draws(fn):
    """A draw at ``offset`` is the slice of the larger draw: a block of rows
    of a batch draws exactly its share of the batch's bits."""
    key = rng.PRNGKey(9)
    if fn == "many":
        keys = np.stack([rng.fold_in(key, t) for t in range(3)])
        whole, part = rng.uniform_many(keys, 500), rng.uniform_many(keys, 120, offset=300)
        np.testing.assert_array_equal(_bits(part), _bits(whole[:, 300:420]))
        return
    draw = rng.uniform if fn == "uniform" else rng.gumbel
    whole = draw(key, (40, 25))
    part = draw(key, (6, 25), offset=17 * 25)
    np.testing.assert_array_equal(_bits(part), _bits(whole[17:23]))
