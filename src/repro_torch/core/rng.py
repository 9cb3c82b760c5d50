"""Counted RNG: ``jax.random``'s threefry2x32 bits, in PyTorch.

The JAX package's contract is bit identity under counted RNG: the same key
gives the same uniforms, hence the same picks and the same walks.  This
module reproduces ``jax.random`` (threefry2x32, partitionable bit layout)
bit for bit, so a port walk equals the reference walk for the same key.

- A key is a ``uint32[2]`` numpy array, the layout of ``jax.random.key_data``.
  Key derivation (:func:`PRNGKey`, :func:`fold_in`) runs on the host on
  Python ints; only the per-element hashing of :func:`uniform` runs on the
  tensor's device.  A batch of rows with a key each carries
  :class:`RowKeys`, and a batch of queue entries at their own depths
  :class:`EntryKeys` (their keys derived on the device); every draw here
  takes either.
- The hash itself (threefry2x32, the counter layout, the bits-to-float
  step) lives in ``kernels.threefry``, beside the walk-step kernels that run
  it per walker; this module re-exports it, with the draws built on it:
  uniforms in a range (:func:`uniform_range`) and Gumbel noise
  (:func:`gumbel`, on XLA-CPU's ``log``, :func:`xla_log`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.threefry import (  # noqa: F401 — the counted RNG's public names
    BatchKeys,
    EntryKeys,
    RowKeys,
    fold_in,
    gumbel,
    random_bits,
    threefry2x32,
    uniform,
    uniform_at,
    uniform_many,
    uniform_range,
    xla_log,
)

_MASK = 0xFFFFFFFF


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — jax.random's name
    """Key from an integer seed, as ``jax.random.PRNGKey`` (32-bit seeds
    give ``[0, seed & 0xffffffff]``)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _MASK
    return np.array([hi, seed & _MASK], dtype=np.uint32)


def key_from_array(key) -> np.ndarray:
    """A key given as its raw words (``jax.random.key_data`` as numpy)."""
    key = np.asarray(key, dtype=np.uint32).reshape(2)
    return key.copy()


def split(key, num: int = 2):
    """``(num, 2)`` keys, as ``jax.random.split(key, num)``'s raw words
    (for :class:`BatchKeys`, a list of ``num`` of them)."""
    if isinstance(key, BatchKeys):
        return [key.fold_in(i) for i in range(int(num))]
    return np.stack([fold_in(key, i) for i in range(int(num))])


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """int32 integers in ``[minval, maxval)``, as ``jax.random.randint``.

    Two 32-bit draws per element (keys ``split(key)``), combined modulo
    the span: ``(hi % span · m + lo % span) % span`` with
    ``m = (2^16 % span)^2 % span``.  JAX does these products in uint32 and
    lets them wrap, so every product here is masked back to 32 bits (for a
    span of ``2^16`` or more, ``m`` itself wraps: at ``2^21`` it is 0).
    """
    k_hi, k_lo = split(key)
    span = max(int(maxval) - int(minval), 1)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    hi = random_bits(k_hi, shape, device) % span
    lo = random_bits(k_lo, shape, device) % span
    off = ((((hi * mult) & _MASK) + lo) & _MASK) % span
    return (off + int(minval)).to(torch.int32)


