"""ITS selection without replacement with bipartite region search
(``its_select``), the paper's warp-centric SELECT.

Dispatches on its operands' device like ``kernels.walk_step``: a CUDA
tensor launches the kernel of ``csrc/walk_kernels.cu`` (or raises), a CPU
tensor runs ``kernels.ref.its_select_ref``.  ``its_select.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: one lane per draw: K draws share one warp
MAX_K = 32
#: the kernel's register scan holds up to 8 16-blocks a lane: 8 * 32 * 16
MAX_P = 4096


def its_select(biases: torch.Tensor, rands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K of P candidates per instance, without replacement (``its_select_pallas``
    with ``with_stats=True``).

    biases: (I, P) float32, ``<= 0`` unselectable; rands: (I, ITERS, K)
    float32, the counted retry budget.  Returns ``(idx, stats)``: (I, K)
    int32 indices, -1 unfilled, and (I, 2) int32 ``(iters, searches)`` per
    instance.  On the card ``K <= 32`` and ``P <= 4096``.
    """
    if biases.ndim != 2 or rands.ndim != 3 or rands.shape[0] != biases.shape[0]:
        raise ValueError(f"its_select: biases (I, P) and rands (I, ITERS, K), got "
                         f"{tuple(biases.shape)} and {tuple(rands.shape)}")
    if biases.device.type == "cpu":
        return ref.its_select_ref(biases, rands)
    n, p = biases.shape
    iters, k = rands.shape[1], rands.shape[2]
    if not (1 <= k <= MAX_K and 1 <= p <= MAX_P and iters >= 1):
        raise ValueError(f"its_select kernel takes 1 <= K <= {MAX_K}, 1 <= P <= {MAX_P} "
                         f"and ITERS >= 1; got K={k}, P={p}, ITERS={iters}")
    _build.require_cuda("its_select", ((biases, torch.float32), (rands, torch.float32)), ())
    idx = torch.empty((n, k), dtype=torch.int32, device=biases.device)
    stats = torch.empty((n, 2), dtype=torch.int32, device=biases.device)
    if n == 0:
        return idx, stats
    lib = _build.load()
    code = lib.its_select_launch(
        biases.data_ptr(), rands.data_ptr(), idx.data_ptr(), stats.data_ptr(),
        n, p, iters, k, _build.stream_handle(biases),
    )
    _build.check(lib, code, "its_select")
    its_select.launches += 1
    return idx, stats


its_select.launches = 0
