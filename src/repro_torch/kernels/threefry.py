"""The counted-RNG hash: ``jax.random``'s threefry2x32 bits, in PyTorch.

The JAX package's contract is bit identity under counted RNG: the same key
gives the same uniforms, hence the same picks and the same walks.  This
module reproduces ``jax.random`` (threefry2x32, partitionable bit layout)
bit for bit.  It is the plain version of the hash that the walk-step
kernels run per walker (``counted_uniform`` in ``csrc/walk_kernels.cu``),
and ``core.rng`` builds the counted RNG's public functions on it.  It sits
among the kernels so that both ``kernels.ref`` and ``core`` import it
without a cycle.

- A key is a ``uint32[2]`` numpy array, the layout of ``jax.random.key_data``.
  Key derivation (:func:`fold_in`) runs on the host on Python ints; only
  the per-element hashing runs on the tensor's device.
- A batch of R rows with a key each (``random_walk_segments``: R requests
  in one launch) carries :class:`RowKeys` instead: ``fold_in`` extends its
  path on the host, and the rows' keys are derived on the device
  (:func:`derive_keys`) when a draw needs them.  Under :class:`RowKeys`
  walker ``b`` of the flattened ``(R·width,)`` batch draws under row
  ``b // width``'s key at its index in the row, as ``jax.vmap`` over the
  rows draws.  A batch of queue entries that each carry their own depth
  and instance (the sharded drain) carries :class:`EntryKeys`: entry ``b``
  draws under the walk's key at its depth, at its instance.  Every draw
  here takes any of these keys.
- Element ``i`` of a draw hashes the counter ``(i >> 32, i & 0xffffffff)``;
  the two output words are XORed into 32 random bits, and the float is
  ``(bits >> 9 | 0x3f800000) - 1`` (23 mantissa bits in ``[0, 1)``).
- The arithmetic is unsigned 32-bit, done in int64 and masked to 32 bits
  after every add and shift, so the same code runs on Python ints and on
  int64 tensors of any device.

:func:`hash_uniform` runs the kernels' device hash alone, so that a test can
hold it against :func:`uniform_many` bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

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


#: the most keys and fold_ins a row that one :func:`derive_keys` launch derives
#: (``kMaxKeyPaths``, ``kMaxKeyDepth`` in ``csrc/walk_kernels.cu``)
MAX_KEY_PATHS, MAX_KEY_DEPTH = 16, 8


class BatchKeys:
    """Keys of a batch of walkers that do not share one key: a device table
    ``base`` of R keys, and the ``fold_in`` data ``path`` applied to every
    one of them since.  :meth:`fold_in` extends the path on the host and
    derives nothing; :meth:`table` derives the keys of the path and its
    suffixes on the device in one :func:`derive_keys` launch.  A subclass
    says, by :meth:`lanes`, under which of the R keys and at which counter
    each walker of the batch draws: :class:`RowKeys` and
    :class:`EntryKeys`."""

    def __init__(self, base: torch.Tensor, path: tuple = ()):
        self.base = base
        self.path = tuple(int(d) & _MASK for d in path)

    @property
    def rows(self) -> int:
        return self.base.shape[0]

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def size(self) -> int:
        """The walkers of the batch."""
        raise NotImplementedError

    def fold_in(self, data: int) -> "BatchKeys":
        raise NotImplementedError

    def lanes(self, idx: torch.Tensor | None = None):
        """``(row, counter)`` int64 of walkers ``idx`` of the batch (all of
        them by default): the key table's row each draws under, and its
        counter."""
        raise NotImplementedError

    def table(self, *suffixes) -> torch.Tensor:
        """``(R, n, 2)`` int32: each key at ``path + suffix`` for each of
        the n suffixes (tuples of ``fold_in`` data)."""
        return derive_keys(self.base, [self.path + tuple(s) for s in suffixes])

    def words(self) -> torch.Tensor:
        """``(R, 2)`` int64: each key at ``path``, as unsigned words."""
        keys = self.table(())[:, 0] if self.path else self.base
        return keys.to(torch.int64) & _MASK


class RowKeys(BatchKeys):
    """The keys of a batch of R rows of ``width`` walkers, one key a row,
    as ``jax.vmap`` over the rows of a walk holds them.

    ``base`` is the rows' keys as an ``(R, 2)`` int32 tensor (the uint32
    words' bits) on the batch's device.  Walker ``b`` of the flattened
    ``(R·width,)`` batch belongs to row ``b // width`` and draws at counter
    ``b % width``.
    """

    def __init__(self, base: torch.Tensor, width: int, path: tuple = ()):
        super().__init__(base, path)
        self.width = int(width)

    @property
    def size(self) -> int:
        return self.rows * self.width

    def fold_in(self, data: int) -> "RowKeys":
        return RowKeys(self.base, self.width, self.path + (data,))

    def lanes(self, idx: torch.Tensor | None = None):
        b = (torch.arange(self.size, dtype=torch.int64, device=self.device) if idx is None
             else idx.to(torch.int64))
        row = torch.div(b, self.width, rounding_mode="floor")
        return row, b - row * self.width


class EntryKeys(BatchKeys):
    """The keys of a batch of queue entries that each carry their own depth
    and instance (the sharded drain's batches, where entries of several
    depths meet).

    ``base`` is an ``(S, 2)`` int32 table whose row ``d`` is the walk's key
    at depth ``d`` (``fold_in(key, d)``); ``depth`` and ``inst`` are the
    entries' ``(B,)`` int32 depths and instances.  Entry ``b`` draws under
    row ``depth[b]`` at counter ``inst[b]``: ``draw(fold_in(key,
    depth[b]))[inst[b]]``, what the single-device walk draws for that
    walker at that depth, wherever and whenever the entry is popped.
    Entries with a negative depth or instance (empty slots) draw at row and
    counter 0.  The derived tables are cached across :meth:`fold_in` and
    :meth:`with_entries`, so a walk derives each suffix's table once.
    """

    def __init__(self, base: torch.Tensor, depth: torch.Tensor, inst: torch.Tensor,
                 path: tuple = (), cache: dict | None = None):
        super().__init__(base, path)
        self.depth, self.inst = depth, inst
        self._cache = {} if cache is None else cache

    @property
    def size(self) -> int:
        return self.depth.shape[0]

    def fold_in(self, data: int) -> "EntryKeys":
        return EntryKeys(self.base, self.depth, self.inst, self.path + (data,), self._cache)

    def with_entries(self, depth: torch.Tensor, inst: torch.Tensor) -> "EntryKeys":
        """The same keys (and cache) for another batch of entries."""
        return EntryKeys(self.base, depth, inst, self.path, self._cache)

    def lanes(self, idx: torch.Tensor | None = None):
        d, i = (self.depth, self.inst) if idx is None else (self.depth[idx], self.inst[idx])
        return torch.clamp(d, min=0).to(torch.int64), torch.clamp(i, min=0).to(torch.int64)

    def entry_operands(self):
        """The entries' depths and instances as contiguous int32 tensors,
        for the step kernels."""
        return (self.depth.to(torch.int32).contiguous(),
                self.inst.to(torch.int32).contiguous())

    def table(self, *suffixes) -> torch.Tensor:
        paths = tuple(self.path + tuple(s) for s in suffixes)
        if paths not in self._cache:
            self._cache[paths] = derive_keys(self.base, [list(p) for p in paths])
        return self._cache[paths]


def fold_in(key, data: int):
    """New key from ``key`` and an integer, as ``jax.random.fold_in``
    (for :class:`BatchKeys`, every key of the table, derived when it is
    used)."""
    if isinstance(key, BatchKeys):
        return key.fold_in(data)
    k0, k1 = (int(k) for k in key)
    a, b = threefry2x32(k0, k1, 0, int(data) & _MASK)
    return np.array([a, b], dtype=np.uint32)


def _batch_bits(key: "BatchKeys", idx, per: int) -> torch.Tensor:
    """``(n, per)`` random bits of walkers ``idx`` (all by default) of a
    batch under :class:`BatchKeys`: walker ``b``'s ``per`` elements hash
    counters ``per·c .. per·c + per - 1`` under its row's key, ``c`` its
    counter (the layout of a ``(W, per)`` draw, row ``c``)."""
    row, ctr = key.lanes(idx)
    words = key.words()[row]
    c = ctr[:, None] * per + torch.arange(per, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(words[:, :1], words[:, 1:], c >> 32, c & _MASK)
    return a ^ b


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def bits_at(key: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    """32 random bits (in int64) for each int64 counter."""
    k0, k1 = (int(k) for k in key)
    a, b = threefry2x32(k0, k1, counters >> 32, counters & _MASK)
    return a ^ b


def random_bits(key, shape, device="cpu", offset: int = 0) -> torch.Tensor:
    """32 random bits per element (in int64), as ``jax.random.bits``.

    ``offset`` shifts the counters: the result is the elements ``offset``
    onward of a larger draw of the same key (the layout is partitionable),
    so a block of rows of a batch draws exactly its share of the batch's
    bits.  Under :class:`BatchKeys` the shape's leading axis is the batch:
    each walker's slice is its row of a draw of its own key, at its counter
    (one hash over every ``(key, counter)`` pair; ``offset`` 0, the keys'
    device)."""
    shape = tuple(int(d) for d in shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    n = int(np.prod(shape))
    if isinstance(key, BatchKeys):
        if offset or not shape or shape[0] != key.size:
            raise ValueError(f"a draw under the keys of a batch of {key.size} walkers needs a "
                             f"leading axis of {key.size} and no offset, got {shape}, "
                             f"offset {offset}")
        return _batch_bits(key, None, n // key.size).reshape(shape)
    i = torch.arange(int(offset), int(offset) + n, dtype=torch.int64, device=device)
    return bits_at(key, i).reshape(shape)


def uniform(key, shape, device="cpu", offset: int = 0) -> torch.Tensor:
    """f32 uniforms in ``[0, 1)`` with ``jax.random.uniform(key, shape)``'s
    bits, for any shape (element ``i`` of the row-major order hashes
    counter ``i``; ``offset`` as in :func:`random_bits`)."""
    return bits_to_unit_float(random_bits(key, shape, device, offset))


def uniform_range(key, shape, minval: float, maxval: float,
                  device="cpu", offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``:
    ``max(minval, u * (maxval - minval) + minval)`` in f32, the bounds
    rounded to f32 first as JAX converts them, and the multiply-add fused
    as XLA-CPU fuses it (:func:`_fma`)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    u = uniform(key, shape, device, offset)
    return torch.clamp(_fma(u, float(hi - lo), float(lo)), min=float(lo))


def uniform_at(key, counters: torch.Tensor) -> torch.Tensor:
    """The uniforms of the given counters only: ``uniform(key, (W,))[counters]``
    for any ``W`` above them, at the cost of ``len(counters)`` hashes.  Under
    :class:`BatchKeys` the counters index the batch, and each walker hashes
    its own counter under its own key (:meth:`BatchKeys.lanes`)."""
    counters = counters.to(torch.int64)
    if isinstance(key, BatchKeys):
        return bits_to_unit_float(_batch_bits(key, counters, 1).reshape(-1))
    return bits_to_unit_float(bits_at(key, counters))


def uniform_many(keys: np.ndarray, n: int, device="cpu", offset: int = 0) -> torch.Tensor:
    """``(K, n)`` f32 uniforms: row ``k`` equals ``uniform(keys[k], (n,))``
    (``offset`` as in :func:`random_bits`).

    One hash over all K rows at once (the keys broadcast against the
    counters), so K draws cost one pass of tensor operations, not K."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    k = torch.as_tensor(keys.astype(np.int64), device=device)
    i = torch.arange(int(offset), int(offset) + int(n), dtype=torch.int64, device=device)
    a, b = threefry2x32(k[:, 0:1], k[:, 1:2], i >> 32, i & _MASK)
    return bits_to_unit_float(a ^ b)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    of two f32 values is exact in f64, so only the f64 sum rounds before
    the f32 result (a second rounding that can differ from one fused
    rounding only when the f64 sum falls exactly on an f32 tie)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


#: XLA-CPU's f32 log polynomial (Cephes ``logf``), coefficients in f32
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of f32 ``x`` with XLA-CPU's bits (``jnp.log``), on any
    device.

    XLA-CPU evaluates Cephes' ``logf``: the mantissa ``m`` in
    ``[sqrt(1/2), sqrt(2))`` shifted by -1, three interleaved Horner chains
    over ``x, x^3``, the exponent added back in two parts, with every
    multiply-add fused (LLVM contracts them).  ``torch.log`` is rounded
    otherwise (1 ulp apart for about 7 % of inputs).  Written as separate
    tensor operations with the fused ones through :func:`_fma`, so every
    device rounds alike.
    """
    x = x.to(torch.float32)
    xc = torch.clamp(x, min=_MIN_NORMAL)
    bits = xc.view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    z = t * t
    t3 = z * t
    p = _LOG_P
    a = _fma(_fma(t, p[0], p[1]), t, p[2])
    b = _fma(_fma(t, p[3], p[4]), t, p[5])
    c = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(a, t3, b), t3, c)
    y = _fma(y, t3, _LOG_Q1 * e)
    r = _fma(torch.full_like(z, -0.5), z, t) + y
    r = _fma(torch.full_like(e, _LOG_Q2), e, r)
    # XLA-CPU flushes subnormal inputs to zero, and its NaN has every bit set
    r = torch.where(x < _MIN_NORMAL, float("-inf"), r)
    r = torch.where(x == float("inf"), float("inf"), r)
    nan = torch.tensor(-1, dtype=torch.int32, device=x.device).view(torch.float32)
    return torch.where(x >= 0, r, nan)


def gumbel(key, shape, device="cpu", offset: int = 0) -> torch.Tensor:
    """f32 Gumbel noise with ``jax.random.gumbel(key, shape)``'s bits:
    ``-log(-log(u))`` for ``u`` uniform in ``[tiny, 1)``, by
    :func:`xla_log` (``offset`` as in :func:`random_bits`)."""
    u = uniform_range(key, shape, _MIN_NORMAL, 1.0, device, offset)
    return -xla_log(-xla_log(u))


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64, as int32 tensors of the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def derive_keys_ref(base: torch.Tensor, paths) -> torch.Tensor:
    """Plain version of :func:`derive_keys`: the fold_ins of each path over
    every row at once, in int64 tensor arithmetic."""
    k = base.to(torch.int64) & _MASK
    out = []
    for path in paths:
        k0, k1 = k[:, 0], k[:, 1]
        for d in path:
            k0, k1 = threefry2x32(k0, k1, 0, int(d) & _MASK)
        out.append(torch.stack([k0, k1], dim=-1))
    return _as_int32(torch.stack(out, dim=1))


def derive_keys(base: torch.Tensor, paths) -> torch.Tensor:
    """The keys at the given paths of every row: ``(R, n, 2)`` int32, entry
    ``[r, p]`` the key ``base[r]`` after ``fold_in`` of each word of
    ``paths[p]`` in turn (``jax.random.fold_in``).  ``base`` is ``(R, 2)``
    int32 (the words' bits); at most :data:`MAX_KEY_PATHS` paths of at most
    :data:`MAX_KEY_DEPTH` words.  On a CUDA tensor one launch of
    ``derive_keys_kernel`` derives them all; on a CPU tensor
    :func:`derive_keys_ref` runs.  ``derive_keys.launches`` counts the
    kernel's launches."""
    paths = [tuple(int(d) & _MASK for d in p) for p in paths]
    if not 1 <= len(paths) <= MAX_KEY_PATHS or any(len(p) > MAX_KEY_DEPTH for p in paths):
        raise ValueError(f"derive_keys takes 1 to {MAX_KEY_PATHS} paths of at most "
                         f"{MAX_KEY_DEPTH} words, got {[len(p) for p in paths]}")
    if base.dim() != 2 or base.shape[1] != 2:
        raise ValueError(f"derive_keys: base keys must be (R, 2), got {tuple(base.shape)}")
    if base.device.type == "cpu":
        return derive_keys_ref(base, paths)
    _build.require_cuda("derive_keys", ((base, torch.int32),), ())
    out = torch.empty((base.shape[0], len(paths), 2), dtype=torch.int32, device=base.device)
    if base.shape[0] == 0:
        return out
    depth = (ctypes.c_int * MAX_KEY_PATHS)(*(len(p) for p in paths))
    data = (ctypes.c_uint32 * (MAX_KEY_PATHS * MAX_KEY_DEPTH))()
    for j, p in enumerate(paths):
        for d, word in enumerate(p):
            data[j * MAX_KEY_DEPTH + d] = word
    lib = _build.load()
    code = lib.derive_keys_launch(base.data_ptr(), out.data_ptr(), base.shape[0], len(paths),
                                  depth, data, _build.stream_handle(base))
    _build.check(lib, code, "derive_keys")
    derive_keys.launches += 1
    return out


derive_keys.launches = 0


def hash_uniform(keys: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    """``(K, n)`` f32 uniforms of the ``n`` int64 ``counters`` under each of
    the K keys: on a CUDA tensor by the kernels' device hash, on a CPU
    tensor by :func:`uniform_at`.  A check of the hash, not a step of any
    walk: ``hash_uniform.launches`` counts its kernel's launches."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    if counters.device.type == "cpu":
        return torch.stack([uniform_at(k, counters) for k in keys])
    _build.require_cuda("hash_uniform", ((counters, torch.int64),), ())
    dev_keys = torch.as_tensor(keys.view(np.int32), device=counters.device).contiguous()
    out = torch.empty((keys.shape[0], counters.shape[0]), dtype=torch.float32,
                      device=counters.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    code = lib.hash_uniform_launch(dev_keys.data_ptr(), counters.data_ptr(), out.data_ptr(),
                                   keys.shape[0], counters.shape[0],
                                   _build.stream_handle(counters))
    _build.check(lib, code, "hash_uniform")
    hash_uniform.launches += 1
    return out


hash_uniform.launches = 0
