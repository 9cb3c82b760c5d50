"""Mixture-of-Experts with sort-based capacity dispatch: the port of
``repro.models.moe``.

Tokens are routed within groups ``G`` (= batch rows).  Each ``(token,
choice)`` is sorted by its expert (stably, so tokens keep their order
within an expert), ranked within its expert's run, and placed in slot
``rank`` of its expert's ``capacity`` slots; a rank at or past the capacity
is dropped.  Dispatch is a gather of token rows into a ``(G, E, C, D)``
grid (row ``S`` is a zero dummy for empty slots), the experts run as
einsums over the grid, and the combine is a scatter-add back to the token
rows in the activations' dtype.

Router modes:
  - ``topk``    — deterministic top-k (standard).
  - ``sampled`` — C-SAW integration: experts sampled *without replacement*
    with router probabilities as biases (Gumbel top-k), on the port's
    counted RNG, so the picks equal ``repro``'s under the same key.
    ``repro`` reaches it only through ``moe_apply(..., key)``: its blocks
    call ``moe_apply`` without a key, so every model routes top-k, and the
    port's blocks do the same.

On a device mesh the groups are sharded over the batch axes and the experts
over ``model``, as ``repro`` lays out its ``(G, E, C, D)`` grid: the routing
and the dispatch plan (sort, ranks, slots, the gather into the grid) run on
each rank's own groups in an explicit local region, the expert einsums on
the grid's DTensors, and the combine scatters each rank's experts' outputs
into its groups' rows, summed over ``model``.  The aux loss's means run over
every group of every rank.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.threefry import gumbel, xla_log
from repro_torch.models.layers import ACTIVATIONS, ParamDef, ashard, from_local


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None)),
        "wi": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.glu:
        defs["wg"] = ParamDef((e, d, f), ("experts", "embed", "mlp"))
    return defs


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per group and expert for groups of ``s`` tokens (``repro``'s
    Python arithmetic)."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(s * k / e * cfg.capacity_factor), 4)


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, ties to the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among ties)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def select_experts(cfg: ModelConfig, probs: torch.Tensor, key=None):
    """The router's picks from its probabilities ``probs`` (..., E) f32:
    ``(gates, idx)`` (..., k), the gates normalized to sum to 1.  With
    ``router_mode="sampled"`` and a key (``uint32[2]`` words), the Gumbel
    top-k of ``log(probs)``: ``jax.random.gumbel``'s bits and XLA's log."""
    scores = probs
    if cfg.router_mode == "sampled" and key is not None:
        g = gumbel(key, tuple(probs.shape), device=probs.device)
        scores = xla_log(torch.clamp(probs, min=1e-20)) + g
    idx = _top(scores, cfg.num_experts_per_tok)
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def _route(params, cfg: ModelConfig, x: torch.Tensor, key):
    """x: (..., D). Returns (gates, idx, probs) with (..., k) leading dims."""
    logits = torch.einsum("...d,de->...e", x, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = select_experts(cfg, probs, key)
    return gates, idx, probs


def _plan(params, cfg: ModelConfig, x: torch.Tensor, key):
    """Routing and the sort-based dispatch plan, per group: ``(grid_tok,
    grid_gate, idx, probs)``; ``grid_tok`` (G, E, C) holds each slot's token
    row (``S``, the dummy row, for an empty slot), ``grid_gate`` its gate."""
    g_dim, s, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    tk = s * k
    cap = capacity(cfg, s)
    dev = x.device

    gates, idx, probs = _route(params, cfg, x, key)  # (G, S, k)

    flat_e = idx.reshape(g_dim, tk)  # expert of each (token, choice)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k).expand(g_dim, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_tok = torch.gather(flat_tok, -1, order)
    sorted_gate = torch.gather(gates.reshape(g_dim, tk), -1, order)
    # rank within expert segment: arange - running start-of-segment
    ar = torch.arange(tk, device=dev).expand(g_dim, tk)
    is_start = torch.ones((g_dim, tk), dtype=torch.bool, device=dev)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    rank = ar - run_start
    # a rank past the capacity goes to the spare slot ``cap``, sliced off:
    # ``repro``'s out-of-bounds slot, which its scatter drops
    slot = torch.where(rank < cap, rank, cap)
    rows = torch.arange(g_dim, device=dev)[:, None]
    where = (rows.expand(g_dim, tk), sorted_e, slot)
    grid_tok = torch.full((g_dim, e, cap + 1), s, dtype=torch.int64, device=dev)
    grid_tok = grid_tok.index_put(where, sorted_tok)[..., :cap]  # s = dummy row
    grid_gate = torch.zeros((g_dim, e, cap + 1), dtype=torch.float32, device=dev)
    grid_gate = grid_gate.index_put(where, sorted_gate)[..., :cap]
    return grid_tok, grid_gate, idx, probs


def _dispatch(x: torch.Tensor, grid_tok: torch.Tensor) -> torch.Tensor:
    """The token rows of each slot: (G, E, C, D), zeros for empty slots."""
    g_dim, _, d = x.shape
    xp = torch.cat([x, torch.zeros((g_dim, 1, d), dtype=x.dtype, device=x.device)], dim=1)
    rows = torch.arange(g_dim, device=x.device)[:, None]
    return xp[rows, grid_tok.reshape(g_dim, -1)].reshape(grid_tok.shape + (d,))


def _experts(params, cfg: ModelConfig, expert_in, grid_gate, dtype) -> torch.Tensor:
    grid = ("batch", "model", None, None)
    act = ACTIVATIONS[cfg.activation]
    h = ashard(torch.einsum("gecd,edf->gecf", expert_in, params["wi"]), *grid)
    if cfg.glu:
        h = act(ashard(torch.einsum("gecd,edf->gecf", expert_in, params["wg"]), *grid)) * h
    else:
        h = act(h)
    expert_out = ashard(torch.einsum("gecf,efd->gecd", h, params["wo"]), *grid)
    return (expert_out * grid_gate[..., None]).to(dtype)


def _combine(expert_out: torch.Tensor, grid_tok: torch.Tensor, s: int) -> torch.Tensor:
    """Scatter-add back to the token rows (plus the dummy row, cut off)."""
    g_dim, d = expert_out.shape[0], expert_out.shape[-1]
    # a token row takes at most k <= 2 adds onto 0 (every config has k <= 2),
    # and 0 + a + b rounds once in either order: the same sum in any order
    y = torch.zeros((g_dim, s + 1, d), dtype=expert_out.dtype, device=expert_out.device)
    rows = torch.arange(g_dim, device=expert_out.device)[:, None, None]
    return y.index_put((rows, grid_tok), expert_out, accumulate=True)[:, :s]


def _aux(first: torch.Tensor, probs: torch.Tensor, e: int) -> torch.Tensor:
    """The load-balancing aux loss (Switch-style) from each token's first
    choice one-hot (G, S, E) and its router probabilities."""
    me = torch.mean(first, dim=(0, 1))
    ce = torch.mean(probs, dim=(0, 1))
    return torch.sum(me * ce) * e


def moe_apply(
    params: dict, cfg: ModelConfig, x: torch.Tensor, key=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Groups = batch rows."""
    if isinstance(x, DTensor):
        return _moe_mesh(params, cfg, x, key)
    grid_tok, grid_gate, idx, probs = _plan(params, cfg, x, key)
    expert_out = _experts(params, cfg, _dispatch(x, grid_tok), grid_gate, x.dtype)
    e = cfg.num_experts
    return _combine(expert_out, grid_tok, x.shape[1]), _aux(
        F.one_hot(idx[..., 0], e).float(), probs, e)


def _moe_mesh(params, cfg: ModelConfig, x: DTensor, key):
    """:func:`moe_apply` on a mesh: ``x``'s groups sharded over the batch
    axes, the experts over ``model``."""
    mesh = x.device_mesh
    g_dim, s, d = x.shape
    rows = [p if p.is_shard(0) else Replicate() for p in x.placements]
    if rows != list(x.placements):
        x = x.redistribute(mesh, rows)
    batch = [i for i, p in enumerate(rows) if p.is_shard(0)]
    router = params["router"].redistribute(mesh, [Replicate()] * mesh.ndim)
    # the local region: each rank's groups, routed and dispatched on the
    # rank (every model rank of a group computes the same plan); the
    # router's gradient is partial over the batch slices
    rl = router.to_local(grad_placements=[Partial() if i in batch else Replicate()
                                          for i in range(mesh.ndim)])
    grid_tok, grid_gate, idx, probs = _plan({"router": rl}, cfg, x.to_local(), key)
    # a view of its own, so that x's gradients add in the order they do
    # without a mesh
    expert_in = _dispatch(x.to_local(), grid_tok)
    e, cap = grid_tok.shape[1:]

    def wrap(t, shape):
        return from_local(t, mesh, rows, shape)

    grid = ("batch", "model", None)
    grid_tok = ashard(wrap(grid_tok, (g_dim, e, cap)), *grid)
    grid_gate = ashard(wrap(grid_gate, (g_dim, e, cap)), *grid)
    expert_in = ashard(wrap(expert_in, (g_dim, e, cap, d)), *grid, None)
    expert_out = _experts(params, cfg, expert_in, grid_gate, x.dtype)
    # the combine: each rank's experts into its groups' rows, a partial
    # sum over the expert slices
    split = [i for i, p in enumerate(expert_out.placements) if p.is_shard(1)]
    y = _combine(expert_out.to_local(), grid_tok.redistribute(mesh, expert_out.placements)
                 .to_local(), s)
    part = [Partial() if i in split else p for i, p in enumerate(rows)]
    y = from_local(y, mesh, part, (g_dim, s, d))
    y = ashard(y.redistribute(mesh, rows), "batch", None, None)
    aux = _aux(wrap(F.one_hot(idx[..., 0], e).float(), (g_dim, s, e)),
               wrap(probs, (g_dim, s, e)), e)
    return y, aux
