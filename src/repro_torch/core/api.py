"""C-SAW user programming interface (paper Fig. 2(a)).

A sampling or random-walk algorithm is a :class:`SamplingSpec` of hooks, as
in ``repro.core.api``:

  - ``vertex_bias(VertexCtx) -> biases``  : bias of each FrontierPool candidate
  - ``edge_bias(EdgeCtx) -> biases``      : bias of each candidate neighbor
  - ``update(key, EdgeCtx, u) -> vertex`` : vertex to insert into the pool
                                            (jump, restart and MH live here)

plus ``flat_edge_bias``, the static per-edge bias array that lowers to the
flat fast path, and the frontier-pool knobs of traversal sampling (paper
Table I).  Hooks take and return torch tensors; ``key`` is a ``uint32[2]``
numpy key of ``core.rng``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


class VertexCtx(NamedTuple):
    """Context for VERTEXBIAS: candidates of a frontier pool."""

    v: torch.Tensor  # (..., C) candidate vertex ids (-1 = empty slot)
    deg: torch.Tensor  # (..., C) degrees
    depth: int  # the step


class EdgeCtx(NamedTuple):
    """Context for EDGEBIAS/UPDATE: edges (v -> u) out of the frontier."""

    v: torch.Tensor  # (...,) source / frontier vertex
    u: torch.Tensor  # (..., D) candidate neighbors (-1 = padding)
    weight: torch.Tensor  # (..., D) edge weights
    deg_v: torch.Tensor  # (...,)
    deg_u: torch.Tensor  # (..., D)
    prev: torch.Tensor  # (...,) vertex visited before v (-1 at start)
    is_prev_neighbor: Optional[torch.Tensor]  # (..., D) bool, only if requested
    depth: int  # the step


BiasFn = Callable[[VertexCtx], torch.Tensor]
EdgeBiasFn = Callable[[EdgeCtx], torch.Tensor]
UpdateFn = Callable[[object, EdgeCtx, torch.Tensor], torch.Tensor]
# graph -> (E,) per-edge bias in CSR order, for the compiled walk fast path
FlatEdgeBiasFn = Callable[[object], torch.Tensor]


def uniform_vertex_bias(ctx: VertexCtx) -> torch.Tensor:
    """Constant VERTEXBIAS: every frontier-pool candidate equally likely."""
    return torch.ones(ctx.v.shape, dtype=torch.float32, device=ctx.v.device)


def degree_vertex_bias(ctx: VertexCtx) -> torch.Tensor:
    """Degree-proportional VERTEXBIAS (MDRW frontier selection, paper Fig. 3b)."""
    return ctx.deg.to(torch.float32)


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
    """A sampling or random-walk algorithm: bias hooks, update hook and the
    structural knobs of the paper's Table I design space.

    ``vertex_bias``, ``edge_bias`` and ``update`` are the paper's hooks.
    Traversal sampling reads the frontier-pool knobs, with the reference's
    meanings: ``frontier_size`` vertices are selected from each pool a step
    and ``neighbor_size`` neighbors for each of them (``per_vertex``,
    neighbor sampling) or over their pooled neighbors (layer sampling,
    MDRW); ``replace_selected`` drops the selected frontier vertices from
    the pool (MDRW); ``track_visited`` samples without replacement across
    the whole instance (visited vertices get zero bias); ``burn_prob`` keeps
    a geometric prefix of the neighbor draws (forest fire).  ``flat_edge_bias(graph)``
    gives the ``(E,)`` float32 bias in CSR order when the bias is static; it
    must equal ``edge_bias`` on every real edge.  ``needs_prev_neighbors``
    asks the dense context for ``is_prev_neighbor`` (node2vec).
    ``transition`` is the declared program (``core.transition``); when set
    it takes precedence over the hooks.  ``selection_method`` overrides the
    program's method: ``None`` leaves it (default ``"auto"``, the cost model
    picks per degree bucket), ``"its"`` / ``"alias"`` / ``"rejection"``
    force one method for every bucket of a flat program.
    """

    vertex_bias: BiasFn = uniform_vertex_bias
    edge_bias: EdgeBiasFn = uniform_edge_bias
    update: UpdateFn = identity_update
    frontier_size: int = 1
    neighbor_size: int = 1
    per_vertex: bool = True
    replace_selected: bool = False
    track_visited: bool = True
    needs_prev_neighbors: bool = False
    burn_prob: Optional[float] = None
    flat_edge_bias: Optional[FlatEdgeBiasFn] = None
    transition: Optional[object] = None
    selection_method: Optional[str] = None
    name: str = "custom"
