"""ITS selection without replacement with bipartite region search
(``its_select``), the paper's warp-centric SELECT.

Dispatches on its operands' device like ``kernels.walk_step``: a CUDA
tensor launches a kernel of ``csrc/walk_kernels.cu`` (or raises), a CPU
tensor runs ``kernels.ref.its_select_ref``.  Two kernels compute the same
function, chosen by shape: ``its_select_kernel`` (a warp an instance, a
lane a draw, the row staged in shared memory) for ``K <= 32`` and
``P <= 4096``, and the wide kernels for any other ``K`` and ``P``: each row
split into chunks of 4,096 entries over many blocks and read once, its scan
joined by a small table a row with XLA's association kept exact, then a
block a row for the rounds (phases A-D of ``its_select_wide_launch``).
``its_select.launches`` counts the launches of both,
``its_select.wide_launches`` those of the wide kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: the warp kernel: one lane per draw, K draws share one warp
MAX_K = 32
#: the warp kernel's register scan holds up to 8 16-blocks a lane: 8 * 32 * 16
MAX_P = 4096


def its_select(biases: torch.Tensor, rands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K of P candidates per instance, without replacement (``its_select_pallas``
    with ``with_stats=True``).

    biases: (I, P) float32, ``<= 0`` unselectable; rands: (I, ITERS, K)
    float32, the counted retry budget; any ``K >= 1``, ``P >= 1`` and
    ``ITERS >= 1``.  Returns ``(idx, stats)``: (I, K) int32 indices, -1
    unfilled, and (I, 2) int32 ``(iters, searches)`` per instance.  On the
    card the shape picks the kernel: the warp kernel for ``K <= MAX_K`` and
    ``P <= MAX_P``, the wide kernel otherwise.
    """
    if biases.ndim != 2 or rands.ndim != 3 or rands.shape[0] != biases.shape[0]:
        raise ValueError(f"its_select: biases (I, P) and rands (I, ITERS, K), got "
                         f"{tuple(biases.shape)} and {tuple(rands.shape)}")
    p, iters, k = biases.shape[1], rands.shape[1], rands.shape[2]
    if p < 1 or k < 1 or iters < 1:
        raise ValueError(f"its_select takes P >= 1, K >= 1 and ITERS >= 1; got P={p}, "
                         f"K={k}, ITERS={iters}")
    if biases.device.type == "cpu":
        return ref.its_select_ref(biases, rands)
    return _launch(biases, rands, wide=not (k <= MAX_K and p <= MAX_P))


def _launch(biases: torch.Tensor, rands: torch.Tensor, wide: bool):
    """Launch one of the two kernels on operands :func:`its_select` has
    checked; its tests and timings also run the wide kernel at the warp
    kernel's shapes."""
    n, p = biases.shape
    iters, k = rands.shape[1], rands.shape[2]
    if not wide and (k > MAX_K or p > MAX_P):
        raise ValueError(f"its_select's warp kernel takes K <= {MAX_K} and P <= {MAX_P}; "
                         f"got K={k}, P={p}")
    _build.require_cuda("its_select", ((biases, torch.float32), (rands, torch.float32)), ())
    idx = torch.empty((n, k), dtype=torch.int32, device=biases.device)
    stats = torch.empty((n, 2), dtype=torch.int32, device=biases.device)
    if n == 0:
        return idx, stats
    lib = _build.load()
    stream = _build.stream_handle(biases)
    if wide:
        words = lib.its_select_wide_scratch_words(n, p, k)
        scratch = torch.empty(words, dtype=torch.float32, device=biases.device)
        code = lib.its_select_wide_launch(
            biases.data_ptr(), rands.data_ptr(), idx.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), n, p, iters, k, stream,
        )
        _build.check(lib, code, "its_select (wide)")
        its_select.wide_launches += 1
    else:
        code = lib.its_select_launch(
            biases.data_ptr(), rands.data_ptr(), idx.data_ptr(), stats.data_ptr(),
            n, p, iters, k, stream,
        )
        _build.check(lib, code, "its_select")
    its_select.launches += 1
    return idx, stats


its_select.launches = 0
its_select.wide_launches = 0
