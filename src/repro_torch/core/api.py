"""C-SAW user programming interface (paper Fig. 2(a)), the flat-bias part.

A sampling algorithm is a :class:`SamplingSpec`.  This slice of the port
runs specs whose transition bias is a static per-edge array (the
``flat_edge_bias`` hook, lowered to ``core.transition.FlatBias``); the
vertex-bias, edge-context and update hooks of ``repro.core.api`` arrive with
the window-bias and traversal slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

# graph -> (E,) per-edge bias in CSR order, for the compiled walk fast path
FlatEdgeBiasFn = Callable[[object], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """A random-walk algorithm: its per-edge bias and selection method.

    ``flat_edge_bias(graph)`` gives the ``(E,)`` float32 bias in CSR order.
    ``transition`` is the declared program (``core.transition``); when set
    it takes precedence over ``flat_edge_bias``.  ``selection_method``
    overrides the program's method: ``None`` leaves it (default ``"auto"``,
    the cost model picks per degree bucket), ``"its"`` / ``"alias"`` /
    ``"rejection"`` force one method for every bucket.
    """

    flat_edge_bias: Optional[FlatEdgeBiasFn] = None
    transition: Optional[object] = None
    selection_method: Optional[str] = None
    name: str = "custom"
