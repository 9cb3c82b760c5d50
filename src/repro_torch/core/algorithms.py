"""Algorithm zoo, random walks (paper Table I).

Each constructor returns a :class:`SamplingSpec` with the hooks of
``repro.core.algorithms`` and the same declared transition program.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (
    EdgeCtx,
    SamplingSpec,
    degree_edge_bias,
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
    )


def biased_random_walk() -> SamplingSpec:
    """Static biased walk: neighbor degree as bias (Biased DeepWalk)."""
    return SamplingSpec(
        edge_bias=degree_edge_bias,
        flat_edge_bias=_flat_degree,
        transition=TransitionProgram(bias=FlatBias(_flat_degree)),
        name="biased_rw",
    )


def weighted_random_walk() -> SamplingSpec:
    """Static biased walk on edge weights."""
    return SamplingSpec(
        edge_bias=weight_edge_bias,
        flat_edge_bias=_flat_weight,
        transition=TransitionProgram(bias=FlatBias(_flat_weight)),
        name="weighted_rw",
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
    )


#: the walk specs by name (``repro.core.algorithms.ALGORITHMS``'s walks;
#: jump and restart take arguments)
ALGORITHMS = {
    "deepwalk": deepwalk,
    "biased_rw": biased_random_walk,
    "weighted_rw": weighted_random_walk,
    "node2vec": node2vec,
    "mhrw": metropolis_hastings_walk,
    "rw_jump": random_walk_with_jump,
    "rw_restart": random_walk_with_restart,
}
