"""Algorithm zoo (paper Table I): random walks and traversal sampling.

Each constructor returns a :class:`SamplingSpec` with the hooks and knobs
of ``repro.core.algorithms`` and, for the walks, the same declared
transition program.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (
    EdgeCtx,
    SamplingSpec,
    degree_edge_bias,
    degree_vertex_bias,
    identity_update,
    uniform_edge_bias,
    weight_edge_bias,
)
from repro_torch.core.rng import randint, split, uniform
from repro_torch.core.transition import (
    FlatBias,
    MHAcceptEpilogue,
    TeleportEpilogue,
    TransitionProgram,
    WindowBias,
    _selected_deg_u,
    f32,
    mh_stay,
)


# flat per-edge biases (CSR order); each agrees with its EdgeCtx hook on
# every real edge
def _flat_uniform(g) -> torch.Tensor:
    return torch.ones_like(g.weights)


def _flat_weight(g) -> torch.Tensor:
    return g.weights


def _flat_degree(g) -> torch.Tensor:
    deg = g.indptr[1:] - g.indptr[:-1]
    return deg[g.indices.long()].to(torch.float32)


def deepwalk() -> SamplingSpec:
    """Unbiased simple random walk (DeepWalk)."""
    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        flat_edge_bias=_flat_uniform,
        transition=TransitionProgram(bias=FlatBias(_flat_uniform)),
        name="deepwalk",
        track_visited=False,
    )


def biased_random_walk() -> SamplingSpec:
    """Static biased walk: neighbor degree as bias (Biased DeepWalk)."""
    return SamplingSpec(
        edge_bias=degree_edge_bias,
        flat_edge_bias=_flat_degree,
        transition=TransitionProgram(bias=FlatBias(_flat_degree)),
        name="biased_rw",
        track_visited=False,
    )


def weighted_random_walk() -> SamplingSpec:
    """Static biased walk on edge weights."""
    return SamplingSpec(
        edge_bias=weight_edge_bias,
        flat_edge_bias=_flat_weight,
        transition=TransitionProgram(bias=FlatBias(_flat_weight)),
        name="weighted_rw",
        track_visited=False,
    )


def node2vec(p: float = 2.0, q: float = 0.5) -> SamplingSpec:
    """Dynamic bias from the previous step (paper Fig. 3(a)): return to
    ``prev`` with weight ``w/p``, stay near it with ``w``, move out with
    ``w/q``.  Declared a :class:`WindowBias`, so it runs degree-bucketed on
    gathered row windows."""
    inv_p, inv_q = f32(1.0 / p), f32(1.0 / q)

    def edge_bias(ctx: EdgeCtx) -> torch.Tensor:
        w = ctx.weight
        back = ctx.u == ctx.prev[..., None]
        near = ctx.is_prev_neighbor
        first_step = (ctx.prev < 0)[..., None]
        bias = torch.where(near, w, w * inv_q)
        bias = torch.where(back, w * inv_p, bias)
        return torch.where(first_step, w, bias)

    return SamplingSpec(
        edge_bias=edge_bias,
        needs_prev_neighbors=True,
        transition=TransitionProgram(
            bias=WindowBias(
                edge_bias, needs_prev_neighbors=True,
                needs_deg_u=False,  # bias reads weights/membership only
            )
        ),
        name="node2vec",
        track_visited=False,
    )


def metropolis_hastings_walk() -> SamplingSpec:
    """MHRW: propose uniform neighbor u, accept w.p. min(1, deg(v)/deg(u))."""

    def update(key, ctx: EdgeCtx, u: torch.Tensor) -> torch.Tensor:
        stay = mh_stay(uniform(key, u.shape, device=u.device), ctx.deg_v, _selected_deg_u(ctx, u))
        return torch.where(stay & (ctx.v >= 0), ctx.v, u)

    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        flat_edge_bias=_flat_uniform,
        update=update,
        transition=TransitionProgram(bias=FlatBias(_flat_uniform), epilogue=MHAcceptEpilogue()),
        name="mhrw",
        track_visited=False,
    )


def random_walk_with_jump(jump_prob: float, num_vertices: int) -> SamplingSpec:
    """Jump to a uniformly random vertex with probability ``jump_prob``."""

    def update(key, ctx: EdgeCtx, u: torch.Tensor) -> torch.Tensor:
        kj, kv = split(key)
        jump = uniform(kj, u.shape, device=u.device) < f32(jump_prob)
        tgt = randint(kv, u.shape, 0, num_vertices, device=u.device)
        return torch.where(jump, tgt, u)

    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        flat_edge_bias=_flat_uniform,
        update=update,
        transition=TransitionProgram(
            bias=FlatBias(_flat_uniform),
            epilogue=TeleportEpilogue(jump_prob, "uniform", num_vertices=num_vertices),
        ),
        name="rw_jump",
        track_visited=False,
    )


def random_walk_with_restart(restart_prob: float, home: int | None = None) -> SamplingSpec:
    """Restart with probability ``restart_prob``: to the predetermined vertex
    ``home``, or (``home=None``) to the walk's own seed — the engine carries
    the per-instance home vertex as transition-program state."""

    def update(key, ctx: EdgeCtx, u: torch.Tensor) -> torch.Tensor:
        if home is None:
            raise NotImplementedError(
                "restart-to-seed needs the engine's home carry; use the "
                "transition-program path (spec.transition), not the raw hook"
            )
        restart = uniform(key, u.shape, device=u.device) < f32(restart_prob)
        return torch.where(restart, torch.full_like(u, home), u)

    epilogue = (
        TeleportEpilogue(restart_prob, "home")
        if home is None
        else TeleportEpilogue(restart_prob, "fixed", vertex=home)
    )
    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        flat_edge_bias=_flat_uniform,
        update=update,
        transition=TransitionProgram(bias=FlatBias(_flat_uniform), epilogue=epilogue),
        name="rw_restart",
        track_visited=False,
    )


# ---------------------------------------------------------------------------
# Traversal-based sampling (frontier pools)
# ---------------------------------------------------------------------------


def unbiased_neighbor_sampling(neighbor_size: int = 2, frontier_size: int = 8) -> SamplingSpec:
    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        frontier_size=frontier_size,
        neighbor_size=neighbor_size,
        per_vertex=True,
        name="neighbor_unbiased",
    )


def biased_neighbor_sampling(neighbor_size: int = 2, frontier_size: int = 8) -> SamplingSpec:
    """Constant NeighborSize per vertex, edge-weight bias."""
    return SamplingSpec(
        edge_bias=weight_edge_bias,
        frontier_size=frontier_size,
        neighbor_size=neighbor_size,
        per_vertex=True,
        name="neighbor_biased",
    )


def forest_fire_sampling(p_f: float = 0.7, max_burn: int = 8, frontier_size: int = 8) -> SamplingSpec:
    """Probabilistic neighbor sampling: geometric(p_f) burn count per vertex."""
    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        frontier_size=frontier_size,
        neighbor_size=max_burn,
        per_vertex=True,
        burn_prob=p_f,
        name="forest_fire",
    )


def layer_sampling(neighbor_size: int = 8, frontier_size: int = 8) -> SamplingSpec:
    """Constant NeighborSize per *layer* over the pooled frontier neighbors."""
    return SamplingSpec(
        edge_bias=weight_edge_bias,
        frontier_size=frontier_size,
        neighbor_size=neighbor_size,
        per_vertex=False,
        name="layer",
    )


def snowball_sampling(max_degree_keep: int = 16, frontier_size: int = 8) -> SamplingSpec:
    """Add (up to a cap of) all neighbors of every sampled vertex."""
    return SamplingSpec(
        edge_bias=uniform_edge_bias,
        frontier_size=frontier_size,
        neighbor_size=max_degree_keep,
        per_vertex=True,
        name="snowball",
    )


def multi_dimensional_random_walk(frontier_size: int = 1) -> SamplingSpec:
    """MDRW / frontier sampling (paper Figs. 3(b), 4): degree-biased frontier
    selection, uniform neighbor choice, selected vertex replaced in the pool."""
    return SamplingSpec(
        vertex_bias=degree_vertex_bias,
        edge_bias=uniform_edge_bias,
        update=identity_update,
        frontier_size=frontier_size,
        neighbor_size=1,
        per_vertex=False,
        replace_selected=True,
        track_visited=False,
        name="mdrw",
    )


#: the specs by name: ``repro.core.algorithms.ALGORITHMS``, and the walks
#: with jump and restart (which take arguments)
ALGORITHMS = {
    "deepwalk": deepwalk,
    "biased_rw": biased_random_walk,
    "weighted_rw": weighted_random_walk,
    "node2vec": node2vec,
    "mhrw": metropolis_hastings_walk,
    "rw_jump": random_walk_with_jump,
    "rw_restart": random_walk_with_restart,
    "neighbor_unbiased": unbiased_neighbor_sampling,
    "neighbor_biased": biased_neighbor_sampling,
    "forest_fire": forest_fire_sampling,
    "layer": layer_sampling,
    "snowball": snowball_sampling,
    "mdrw": multi_dimensional_random_walk,
}
