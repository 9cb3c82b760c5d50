"""O(1) alias-table walk-step kernel (``alias_step``).

Dispatches on its operands' device like ``kernels.walk_step``: a CUDA
tensor launches the kernel of ``csrc/walk_kernels.cu``, a CPU tensor runs
the plain version in ``kernels/ref.py``.  ``alias_step.launches`` counts the
kernel's launches.

``alias_step`` is a whole step, as ``walk_step`` and ``reject_step`` are: it
takes the step's key and the walkers' vertices, finds each walker's cohort
on the ladder, serves every cohort planned as ``"alias"`` (the tail
included) in one launch, and hashes each served walker's uniform in the
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.walk_step import (
    _entry_ptrs, _ladder, _launch_keys, _step_operands, _table_ptr)


def alias_step(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One O(1) alias step (``alias_step_pallas``) for every cohort planned
    as ``"alias"``, the tail included, in one launch.

    key, indptr, indices, cur and the ladder (``buckets``, ``use_chunked``,
    ``methods``) as ``kernels.walk_step`` (``key`` may be
    :class:`~repro_torch.kernels.threefry.RowKeys` or
    :class:`~repro_torch.kernels.threefry.EntryKeys`); prob (E,) float32 and alias (E,)
    int32: the CSR-aligned tables of ``core.select.build_alias``.  A bucket
    cohort's walker ``i`` draws ``uniform(fold_in(key, 0))`` at counter
    ``i`` over its row capped at the cohort's segment; a tail walker draws
    ``uniform(fold_in(key, 1))`` at counter ``i`` over its whole row.
    Writes the served walkers' next vertices (-1 for a zero-total row) into
    ``out`` (W,) int32 and leaves the other entries as they are;
    ``out=None`` starts from all -1.  Returns ``out``.
    """
    ladder = _ladder("alias_step", buckets, use_chunked, methods, "alias", tail=True)
    if cur.device.type == "cpu":
        return ref.alias_step_ref(key, indptr, indices, prob, alias, cur, buckets=buckets,
                                  use_chunked=use_chunked, methods=methods, out=out)
    out = _step_operands("alias_step", cur, out, indptr,
                         ((indices, torch.int32), (prob, torch.float32), (alias, torch.int32)))
    w = cur.shape[0]
    if w == 0 or ladder[2] == 0:
        return out
    words, table, width, entries = _launch_keys("alias_step", key, cur, (0,), (1,))
    lib = _build.load()
    code = lib.alias_step_launch(
        cur.data_ptr(), indptr.data_ptr(), indices.data_ptr(), prob.data_ptr(),
        alias.data_ptr(), out.data_ptr(), w, ladder, words, _table_ptr(table), width,
        *_entry_ptrs(entries), _build.stream_handle(cur),
    )
    _build.check(lib, code, "alias_step")
    alias_step.launches += 1
    return out


alias_step.launches = 0
