"""Walk-step kernels: flat-bias ITS (``walk_step``), window-bias ITS
(``walk_step_window``) and rejection (``reject_step``).

Each wrapper dispatches on its operands' device: a CUDA tensor launches the
hand-written kernel of ``csrc/walk_kernels.cu`` (or raises if it cannot
build or launch), a CPU tensor runs the plain version in ``kernels/ref.py``.
Each wrapper counts its kernel launches in a plain integer attribute,
``walk_step.launches``, ``walk_step_window.launches``,
``reject_step.launches``.

``walk_step`` and ``reject_step`` are whole steps: they take the step's key
and the walkers' vertices, find each walker's degree cohort on the ladder
themselves, serve every cohort planned for their method in one launch, and
hash the counted uniforms their walkers consume inside the kernel.  Their
key is one key for every walker, :class:`~repro_torch.kernels.threefry.RowKeys`
(one key a row of a batch of rows, read from a device table:
``random_walk_segments``, every row in one launch), or
:class:`~repro_torch.kernels.threefry.EntryKeys` (a key a depth, read from a
device table at each entry's depth, the counter its instance: the sharded
drain, whose batches mix depths).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.threefry import BatchKeys, EntryKeys, RowKeys, fold_in

#: the longest degree ladder the step kernels take
MAX_LADDER = 4


def _check_seg(max_seg: int, name: str = "walk_step") -> None:
    # the reference's ITS windows: 2*max_seg positions from a block origin,
    # a segment of whole 128-lane tiles up to 512 (walk_step_pallas)
    if max_seg <= 0 or max_seg % 128 or max_seg > 512:
        raise ValueError(f"{name} needs max_seg in 128, 256, 384, 512; got {max_seg}")


def _ladder(name: str, buckets: tuple, use_chunked: bool, methods: tuple, method: str,
            tail: bool) -> ctypes.Array:
    """The kernel's view of the step's schedule: ``(nseg, tail, serve,
    seg_0 .. seg_{MAX_LADDER-1})``, ``serve`` the bit mask of the cohorts
    planned as ``method`` (bit ``len(buckets)`` is the tail, served only
    when ``tail``)."""
    buckets = tuple(int(s) for s in buckets)
    if not 1 <= len(buckets) <= MAX_LADDER or any(s <= 0 for s in buckets) or any(
            a >= b for a, b in zip(buckets, buckets[1:])):
        raise ValueError(f"{name}: buckets must be 1 to {MAX_LADDER} increasing segments, "
                         f"got {buckets}")
    if len(methods) != len(buckets) + bool(use_chunked):
        raise ValueError(f"{name}: {len(methods)} methods for {len(buckets)} buckets "
                         f"{'and a tail' if use_chunked else 'and no tail'}")
    serve = 0
    for k, m in enumerate(methods):
        if m == method and (k < len(buckets) or tail):
            serve |= 1 << k
    segs = buckets + (0,) * (MAX_LADDER - len(buckets))
    return (ctypes.c_int * (3 + MAX_LADDER))(len(buckets), int(bool(use_chunked)), serve, *segs)


def _key_words(*keys) -> ctypes.Array:
    words = np.concatenate([np.asarray(k, dtype=np.uint32).reshape(2) for k in keys])
    return (ctypes.c_uint32 * words.shape[0])(*(int(x) for x in words))


def _launch_keys(name: str, key, cur: torch.Tensor, *suffixes):
    """A step kernel's keys: ``key`` after each suffix of ``fold_in`` data,
    as ``(words, table, width, entries)``.  For one key, ``(words, None, 0,
    None)``: the words by value, derived on the host.  For
    :class:`RowKeys` over ``cur``'s rows, ``(None, table, width, None)``: a
    device table of each row's keys (one ``derive_keys`` launch), which the
    kernel reads at walker ``b``'s row ``b // width``.  For
    :class:`EntryKeys`, ``(None, table, 0, (depth, inst))``: a table of each
    depth's keys, which the kernel reads at entry ``b``'s depth, hashing at
    its instance."""
    if isinstance(key, BatchKeys):
        if key.size != cur.shape[0]:
            raise ValueError(f"{name}: keys of {key.size} walkers for {cur.shape[0]} walkers")
        if isinstance(key, EntryKeys):
            entries = key.entry_operands()
            if entries[0].device != cur.device:
                raise ValueError(f"{name}: entry keys on {entries[0].device}, walkers on "
                                 f"{cur.device}")
            return None, key.table(*suffixes), 0, entries
        return None, key.table(*suffixes), key.width, None
    derived = {(): np.asarray(key, dtype=np.uint32)}

    def at(path):
        if path not in derived:
            derived[path] = fold_in(at(path[:-1]), path[-1])
        return derived[path]

    return _key_words(*(at(tuple(s)) for s in suffixes)), None, 0, None


def _entry_ptrs(entries):
    """The entries' depth and instance pointers (null for other keys)."""
    return (None, None) if entries is None else (entries[0].data_ptr(), entries[1].data_ptr())


def _table_ptr(table):
    return None if table is None else table.data_ptr()


def _step_operands(name, cur, out, indptr, tables, vertex=()):
    """Check a step kernel's operands: walkers (W,), CSR arrays (E,),
    indptr (V+1,) and per-vertex arrays (V,).  Returns the output, all -1
    when not given."""
    if out is None:
        out = torch.full_like(cur, -1)
    _build.require_cuda(name, ((cur, torch.int32), (out, torch.int32)), tables,
                        others=((indptr, torch.int32), *vertex))
    if indptr.dim() != 1 or any(t.shape != (indptr.shape[0] - 1,) for t, _ in vertex):
        raise ValueError(f"{name}: indptr must be (V+1,) and per-vertex operands (V,)")
    return out


def walk_step(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
    key_path: tuple = (0,),
) -> torch.Tensor:
    """One flat-bias ITS step (``walk_step_pallas`` behind the JAX
    package's ``kernels.ops.walk_step``) for every bucket cohort planned as
    ``"its"``, in one launch.

    key: the step's key (the uniform is ``fold_in(key, 0)`` at the
    walker's index in ``cur``; ``key_path`` names the ``fold_in`` data from
    ``key`` to the uniform's key, ``()`` for ``key`` itself), or :class:`~repro_torch.kernels.threefry.RowKeys`
    for a batch of rows (each row's key, at the walker's index in its
    row), or :class:`~repro_torch.kernels.threefry.EntryKeys` for a batch of
    queue entries (each entry's depth's key, at its instance); indptr (V+1,) int32, indices (E,) int32
    and bias (E,) float32: the flat CSR; cur: (W,) int32 vertices, -1 for
    finished walkers; ``buckets``/``use_chunked``/``methods``: the step's
    ladder and plan (``core.backend.walk_bucket_plan``,
    ``core.methods.plan_for_graph``).  Writes the served walkers' next
    vertices (-1 for a dead end) into ``out`` (W,) int32 and leaves the
    other entries as they are; ``out=None`` starts from all -1.  Returns
    ``out``.  The ITS tail is not served (it is the chunked scan).
    """
    ladder = _ladder("walk_step", buckets, use_chunked, methods, "its", tail=False)
    for k, m in enumerate(methods[:len(buckets)]):
        if m == "its":
            _check_seg(int(buckets[k]))
    if cur.device.type == "cpu":
        return ref.walk_step_ref(key, indptr, indices, bias, cur, buckets=buckets,
                                 use_chunked=use_chunked, methods=methods, out=out,
                                 key_path=key_path)
    out = _step_operands("walk_step", cur, out, indptr,
                         ((indices, torch.int32), (bias, torch.float32)))
    w = cur.shape[0]
    if w == 0 or ladder[2] == 0:
        return out
    words, table, width, entries = _launch_keys("walk_step", key, cur, key_path)
    lib = _build.load()
    code = lib.walk_step_launch(
        cur.data_ptr(), indptr.data_ptr(), indices.data_ptr(), bias.data_ptr(), out.data_ptr(),
        w, bias.shape[0], ladder, words, _table_ptr(table), width, *_entry_ptrs(entries),
        _build.stream_handle(cur),
    )
    _build.check(lib, code, "walk_step")
    walk_step.launches += 1
    return out


walk_step.launches = 0


def walk_step_window(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias_rows: torch.Tensor,
    rand: torch.Tensor,
    *,
    max_seg: int = 512,
) -> torch.Tensor:
    """One window-bias ITS step for W walkers (``walk_step_window_pallas``).

    starts/degs: (W,) int32, ``degs <= max_seg``; indices (E,) int32: the
    flat CSR ids; bias_rows: (W, max_seg) float32, the bias the window hook
    computed for each walker's edges ``start + j`` in column ``j``; rand:
    (W,) float32.  Returns next vertices (W,) int32, -1 for a dead end.
    """
    _check_seg(max_seg, "walk_step_window")
    if bias_rows.shape != (starts.shape[0], max_seg):
        raise ValueError(f"walk_step_window: bias_rows must be (W, {max_seg}), "
                         f"got {tuple(bias_rows.shape)}")
    if starts.device.type == "cpu":
        return ref.walk_step_window_block_ref(starts, degs, indices, bias_rows, rand, seg=max_seg)
    i32, f32 = torch.int32, torch.float32
    _build.require_cuda("walk_step_window",
                        ((starts, i32), (degs, i32), (rand, f32), (bias_rows, f32)),
                        ((indices, i32),))
    out = torch.empty_like(starts)
    w = starts.shape[0]
    if w == 0:
        return out
    lib = _build.load()
    code = lib.walk_step_window_launch(
        starts.data_ptr(), degs.data_ptr(), indices.data_ptr(), bias_rows.data_ptr(),
        rand.data_ptr(), out.data_ptr(), w, max_seg, _build.stream_handle(starts),
    )
    _build.check(lib, code, "walk_step_window")
    walk_step_window.launches += 1
    return out


walk_step_window.launches = 0


def reject_step(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    row_max: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One counted-budget rejection step (``reject_step_pallas``) for every
    cohort planned as ``"rejection"``, the tail included, in one launch.

    Operands as :func:`walk_step`, and row_max: (V,) float32 per-vertex
    envelopes.  Round ``t`` of walker ``i`` hashes its slot uniform under
    ``fold_in(fold_in(key, 2), 2t)`` and its accept uniform under
    ``fold_in(fold_in(key, 2), 2t + 1)``, both at counter ``i`` — the
    ``ref.rejection_randoms`` budget, of which the kernel hashes
    only the rounds the walker reaches.  A bucket cohort's rows are
    truncated to its segment; the tail draws over the whole row.  Writes
    into ``out`` as :func:`walk_step` does.  Returns ``out``.
    """
    ladder = _ladder("reject_step", buckets, use_chunked, methods, "rejection", tail=True)
    if cur.device.type == "cpu":
        return ref.reject_step_ref(key, indptr, indices, bias, row_max, cur, buckets=buckets,
                                   use_chunked=use_chunked, methods=methods, out=out)
    out = _step_operands("reject_step", cur, out, indptr,
                         ((indices, torch.int32), (bias, torch.float32)),
                         vertex=((row_max, torch.float32),))
    w = cur.shape[0]
    if w == 0 or ladder[2] == 0:
        return out
    words, table, width, entries = _launch_keys(
        "reject_step", key, cur, *((2, t) for t in range(2 * ref.REJECT_ITERS)))
    lib = _build.load()
    code = lib.reject_step_launch(
        cur.data_ptr(), indptr.data_ptr(), indices.data_ptr(), bias.data_ptr(),
        row_max.data_ptr(), out.data_ptr(), w, ladder, words, _table_ptr(table), width,
        *_entry_ptrs(entries), _build.stream_handle(cur),
    )
    _build.check(lib, code, "reject_step")
    reject_step.launches += 1
    return out


reject_step.launches = 0
