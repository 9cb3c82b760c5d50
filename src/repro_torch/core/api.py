"""C-SAW user programming interface (paper Fig. 2(a)), the random-walk part.

A walk algorithm is a :class:`SamplingSpec` of hooks, as in
``repro.core.api``:

  - ``edge_bias(EdgeCtx) -> biases``      : bias of each candidate neighbor
  - ``update(key, EdgeCtx, u) -> vertex`` : vertex to walk to (jump, restart
                                            and MH live here)

plus ``flat_edge_bias``, the static per-edge bias array that lowers to the
flat fast path.  Hooks take and return torch tensors; ``key`` is a
``uint32[2]`` numpy key of ``core.rng``.  The vertex-bias hooks and the
frontier-pool knobs of ``repro.core.api`` belong to traversal sampling,
which is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


class EdgeCtx(NamedTuple):
    """Context for EDGEBIAS/UPDATE: edges (v -> u) out of each walker."""

    v: torch.Tensor  # (W,) source vertex
    u: torch.Tensor  # (W, D) candidate neighbors (-1 = padding)
    weight: torch.Tensor  # (W, D) edge weights
    deg_v: torch.Tensor  # (W,)
    deg_u: torch.Tensor  # (W, D)
    prev: torch.Tensor  # (W,) vertex visited before v (-1 at start)
    is_prev_neighbor: Optional[torch.Tensor]  # (W, D) bool, only if requested
    depth: int  # the step


EdgeBiasFn = Callable[[EdgeCtx], torch.Tensor]
UpdateFn = Callable[[object, EdgeCtx, torch.Tensor], torch.Tensor]
# graph -> (E,) per-edge bias in CSR order, for the compiled walk fast path
FlatEdgeBiasFn = Callable[[object], torch.Tensor]


def uniform_edge_bias(ctx: EdgeCtx) -> torch.Tensor:
    """Constant EDGEBIAS: unbiased neighbor choice (DeepWalk)."""
    return torch.ones(ctx.u.shape, dtype=torch.float32, device=ctx.u.device)


def weight_edge_bias(ctx: EdgeCtx) -> torch.Tensor:
    """Edge-weight EDGEBIAS: transition probability ∝ edge weight."""
    return ctx.weight.to(torch.float32)


def degree_edge_bias(ctx: EdgeCtx) -> torch.Tensor:
    """Biased DeepWalk: neighbor degree as bias (paper §II-A)."""
    return ctx.deg_u.to(torch.float32)


def identity_update(key, ctx: EdgeCtx, u: torch.Tensor) -> torch.Tensor:
    """Default UPDATE: walk to the selected neighbor unchanged."""
    return u


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """A random-walk algorithm: bias hooks, update hook, selection method.

    ``edge_bias`` and ``update`` are the paper's hooks.  ``flat_edge_bias(graph)``
    gives the ``(E,)`` float32 bias in CSR order when the bias is static; it
    must equal ``edge_bias`` on every real edge.  ``needs_prev_neighbors``
    asks the dense context for ``is_prev_neighbor`` (node2vec).
    ``transition`` is the declared program (``core.transition``); when set
    it takes precedence over the hooks.  ``selection_method`` overrides the
    program's method: ``None`` leaves it (default ``"auto"``, the cost model
    picks per degree bucket), ``"its"`` / ``"alias"`` / ``"rejection"``
    force one method for every bucket of a flat program.
    """

    edge_bias: EdgeBiasFn = uniform_edge_bias
    update: UpdateFn = identity_update
    needs_prev_neighbors: bool = False
    flat_edge_bias: Optional[FlatEdgeBiasFn] = None
    transition: Optional[object] = None
    selection_method: Optional[str] = None
    name: str = "custom"
