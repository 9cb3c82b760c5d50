"""Flat-bias walk-step kernels: ITS (``walk_step``) and rejection
(``reject_step``).

Each wrapper dispatches on its operands' device: a CUDA tensor launches the
hand-written kernel of ``csrc/walk_kernels.cu`` (or raises if it cannot
build or launch), a CPU tensor runs the plain version in ``kernels/ref.py``.
Each wrapper counts its kernel launches in a plain integer attribute,
``walk_step.launches`` / ``reject_step.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: the kernels' row cap for ``max_seg=None`` (no truncation)
_INT_MAX = (1 << 31) - 1
_MAX_WINDOW = 1024


def _check_seg(max_seg: int) -> None:
    # the kernel's window (2*max_seg floats per warp) is sized for 512, and
    # its scan takes whole 16-groups of 16-blocks
    if max_seg <= 0 or max_seg % 128 or 2 * max_seg > _MAX_WINDOW:
        raise ValueError(f"walk_step needs max_seg in 128, 256, 384, 512; got {max_seg}")


def walk_step(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    rand: torch.Tensor,
    *,
    max_seg: int = 512,
) -> torch.Tensor:
    """One flat-bias ITS step for W walkers (``walk_step_pallas``).

    starts/degs: (W,) int32 row offsets and degrees, ``degs <= max_seg``;
    indices (E,) int32 and bias (E,) float32: flat CSR arrays; rand: (W,)
    float32.  Returns next vertices (W,) int32, -1 for a dead end.
    """
    _check_seg(max_seg)
    if starts.device.type == "cpu":
        return ref.walk_step_block_ref(starts, degs, indices, bias, rand, seg=max_seg)
    i32, f32 = torch.int32, torch.float32
    _build.require_cuda("walk_step", ((starts, i32), (degs, i32), (rand, f32)),
                        ((indices, i32), (bias, f32)))
    out = torch.empty_like(starts)
    w = starts.shape[0]
    if w == 0:
        return out
    lib = _build.load()
    code = lib.walk_step_launch(
        starts.data_ptr(), degs.data_ptr(), indices.data_ptr(), bias.data_ptr(),
        rand.data_ptr(), out.data_ptr(), w, max_seg, _build.stream_handle(starts),
    )
    _build.check(lib, code, "walk_step")
    walk_step.launches += 1
    return out


walk_step.launches = 0


def reject_step(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    row_max: torch.Tensor,
    rej: torch.Tensor,
    *,
    max_seg: int | None = 512,
) -> torch.Tensor:
    """One counted-budget rejection step for W walkers (``reject_step_pallas``).

    starts/degs: (W,) int32; indices/bias: flat CSR arrays; row_max: (W,)
    float32 per-walker envelopes; rej: (W, iters, 2) float32 budget from
    ``core.select.rejection_randoms``.  Rows longer than ``max_seg`` are
    truncated to it; ``max_seg=None`` draws over the whole row.  Returns
    next vertices (W,) int32, -1 for a dead end.
    """
    if rej.ndim != 3 or rej.shape[0] != starts.shape[0] or rej.shape[2] != 2:
        raise ValueError(f"reject_step: rej must be (W, iters, 2), got {tuple(rej.shape)}")
    if starts.device.type == "cpu":
        return ref.reject_step_block_ref(starts, degs, indices, bias, row_max, rej, seg=max_seg)
    i32, f32 = torch.int32, torch.float32
    _build.require_cuda("reject_step", ((starts, i32), (degs, i32), (row_max, f32), (rej, f32)),
                        ((indices, i32), (bias, f32)))
    out = torch.empty_like(starts)
    w = starts.shape[0]
    if w == 0:
        return out
    lib = _build.load()
    code = lib.reject_step_launch(
        starts.data_ptr(), degs.data_ptr(), indices.data_ptr(), bias.data_ptr(),
        row_max.data_ptr(), rej.data_ptr(), out.data_ptr(), w, rej.shape[1],
        _INT_MAX if max_seg is None else max_seg, _build.stream_handle(starts),
    )
    _build.check(lib, code, "reject_step")
    reject_step.launches += 1
    return out


reject_step.launches = 0
