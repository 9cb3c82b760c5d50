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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.threefry import gumbel, xla_log
from repro_torch.models.layers import ACTIVATIONS, ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, e)),
        "wi": ParamDef((e, d, f)),
        "wo": ParamDef((e, f, d)),
    }
    if cfg.glu:
        defs["wg"] = ParamDef((e, d, f))
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


def moe_apply(
    params: dict, cfg: ModelConfig, x: torch.Tensor, key=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Groups = batch rows."""
    g_dim, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    tk = s * k
    cap = capacity(cfg, s)
    dev = x.device

    gates, idx, probs = _route(params, cfg, x, key)  # (G, S, k)

    # ---- sort-based dispatch plan, per group --------------------------------
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

    # ---- expert compute ------------------------------------------------------
    xp = torch.cat([x, torch.zeros((g_dim, 1, d), dtype=x.dtype, device=dev)], dim=1)
    expert_in = xp[rows, grid_tok.reshape(g_dim, -1)].reshape(g_dim, e, cap, d)
    act = ACTIVATIONS[cfg.activation]
    h = torch.einsum("gecd,edf->gecf", expert_in, params["wi"])
    if cfg.glu:
        h = act(torch.einsum("gecd,edf->gecf", expert_in, params["wg"])) * h
    else:
        h = act(h)
    expert_out = torch.einsum("gecf,efd->gecd", h, params["wo"])
    expert_out = (expert_out * grid_gate[..., None]).to(x.dtype)

    # ---- combine: scatter-add back to token rows (plus the dummy row) ------
    # a token row takes at most k <= 2 adds onto 0 (every config has k <= 2),
    # and 0 + a + b rounds once in either order: the same sum in any order
    y = torch.zeros((g_dim, s + 1, d), dtype=x.dtype, device=dev)
    y = y.index_put((rows[:, :, None], grid_tok), expert_out, accumulate=True)[:, :s]

    # load-balancing aux loss (Switch-style)
    me = torch.mean(F.one_hot(idx[..., 0], e).float(), dim=(0, 1))
    ce = torch.mean(probs, dim=(0, 1))
    aux = torch.sum(me * ce) * e
    return y, aux
