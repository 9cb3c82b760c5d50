"""Counted RNG: ``jax.random``'s threefry2x32 bits, in PyTorch.

The JAX package's contract is bit identity under counted RNG: the same key
gives the same uniforms, hence the same picks and the same walks.  This
module reproduces ``jax.random`` (threefry2x32, partitionable bit layout)
bit for bit, so a port walk equals the reference walk for the same key.

- A key is a ``uint32[2]`` numpy array, the layout of ``jax.random.key_data``.
  Key derivation (:func:`PRNGKey`, :func:`fold_in`) runs on the host on
  Python ints; only the per-element hashing of :func:`uniform` runs on the
  tensor's device.
- Element ``i`` of a draw hashes the counter ``(i >> 32, i & 0xffffffff)``;
  the two output words are XORed into 32 random bits, and the float is
  ``(bits >> 9 | 0x3f800000) - 1`` (23 mantissa bits in ``[0, 1)``).
- The arithmetic is unsigned 32-bit, done in int64 and masked to 32 bits
  after every add and shift, so the same code runs on Python ints and on
  int64 tensors of any device.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counters ``(x0, x1)`` under key
    ``(k0, k1)``.  Operands are Python ints or int64 tensors holding
    unsigned 32-bit values; they broadcast like any tensor operands."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


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


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """New key from ``key`` and an integer, as ``jax.random.fold_in``."""
    k0, k1 = (int(k) for k in key)
    a, b = threefry2x32(k0, k1, 0, int(data) & _MASK)
    return np.array([a, b], dtype=np.uint32)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform(key: np.ndarray, shape, device="cpu") -> torch.Tensor:
    """f32 uniforms in ``[0, 1)`` with ``jax.random.uniform(key, shape)``'s
    bits (1-D draws; element ``i`` hashes counter ``i``)."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    if len(shape) != 1:
        raise ValueError(f"uniform draws 1-D shapes only, got {shape}")
    return uniform_many(key[None, :], shape[0], device)[0]


def uniform_many(keys: np.ndarray, n: int, device="cpu") -> torch.Tensor:
    """``(K, n)`` f32 uniforms: row ``k`` equals ``uniform(keys[k], (n,))``.

    One hash over all K rows at once (the keys broadcast against the
    counters), so K draws cost one pass of tensor operations, not K."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    k = torch.as_tensor(keys.astype(np.int64), device=device)
    i = torch.arange(int(n), dtype=torch.int64, device=device)
    a, b = threefry2x32(k[:, 0:1], k[:, 1:2], i >> 32, i & _MASK)
    return _bits_to_unit_float(a ^ b)
