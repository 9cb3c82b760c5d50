"""O(1) alias-table walk-step kernel (``alias_step``).

Dispatches on its operands' device like ``kernels.walk_step``: a CUDA
tensor launches the kernel of ``csrc/walk_kernels.cu``, a CPU tensor runs
the plain version in ``kernels/ref.py``.  ``alias_step.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_INT_MAX = (1 << 31) - 1


def alias_step(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    rand: torch.Tensor,
    *,
    max_seg: int | None = 512,
) -> torch.Tensor:
    """One alias draw for W walkers (``alias_step_pallas``).

    starts/degs: (W,) int32; indices (E,) int32, prob (E,) float32 and alias
    (E,) int32: CSR-aligned arrays, the tables from
    ``core.select.build_alias``; rand: (W,) float32.  Rows longer than
    ``max_seg`` are truncated to it; ``max_seg=None`` draws over the whole
    row.  Returns next vertices (W,) int32, -1 for a dead end.
    """
    if starts.device.type == "cpu":
        return ref.alias_step_block_ref(starts, degs, indices, prob, alias, rand, seg=max_seg)
    i32, f32 = torch.int32, torch.float32
    _build.require_cuda("alias_step", ((starts, i32), (degs, i32), (rand, f32)),
                        ((indices, i32), (prob, f32), (alias, i32)))
    out = torch.empty_like(starts)
    w = starts.shape[0]
    if w == 0:
        return out
    lib = _build.load()
    code = lib.alias_step_launch(
        starts.data_ptr(), degs.data_ptr(), indices.data_ptr(), prob.data_ptr(),
        alias.data_ptr(), rand.data_ptr(), out.data_ptr(), w,
        _INT_MAX if max_seg is None else max_seg, _build.stream_handle(starts),
    )
    _build.check(lib, code, "alias_step")
    alias_step.launches += 1
    return out


alias_step.launches = 0
