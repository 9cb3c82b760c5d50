"""Transition programs: lowering a spec's hooks onto the walk fast paths.

Same IR as ``repro.core.transition``: a program names where the per-edge
bias comes from and what happens after the draw picks neighbor ``u``.

Bias sources:

  - :class:`FlatBias`   — a static ``(E,)`` CSR-order array (deepwalk,
    weighted and biased walks), sampled straight off the flat edge arrays.
  - :class:`WindowBias` — a function of each walker's gathered neighbor
    window and its carried state (prev vertex): node2vec.  Evaluated per
    degree cohort on compact ``(n, seg)`` row windows, never on a dense
    ``(W, max_degree)`` gather.
  - :class:`OpaqueBias` — anything else; the dense gather serves it.

Epilogues:

  - :class:`IdentityEpilogue` — walk to ``u``.
  - :class:`MHAcceptEpilogue` — Metropolis-Hastings: accept ``u`` w.p.
    ``min(1, deg(v)/deg(u))``, else stay at ``v``.
  - :class:`TeleportEpilogue` — with probability ``prob`` go elsewhere: a
    uniform random vertex (jump), a fixed vertex (restart), or the walk's
    own seed (``"home"`` restart).
  - :class:`OpaqueEpilogue`   — defer to ``spec.update``.

Every epilogue runs in :func:`apply_epilogue` and consumes the reference's
counted RNG, so the port's walks equal ``repro``'s for the same key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal, Optional, Union

import numpy as np
import torch

from repro_torch.core.api import EdgeCtx, SamplingSpec, identity_update
from repro_torch.core.rng import randint, split, uniform

# ---------------------------------------------------------------------------
# Bias sources
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatBias:
    """Static per-edge bias: ``fn(graph) -> (E,)`` float32 in CSR order."""

    fn: Callable[[object], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WindowBias:
    """Dynamic per-edge bias evaluated on gathered neighbor windows.

    ``fn`` receives an :class:`EdgeCtx` whose neighbor axis is a degree
    cohort's row window.  Each candidate's bias may depend only on its own
    edge (``u``, ``weight``, ``deg_u``, ``is_prev_neighbor``) and on the
    walker's state (``v``, ``prev``, ``deg_v``, ``depth``).
    ``needs_prev_neighbors`` asks for ``is_prev_neighbor`` (a binary search
    over prev's sorted CSR row per candidate); ``needs_deg_u=False`` says
    the hook never reads ``deg_u``, which then reads as zeros.
    """

    fn: Callable[[EdgeCtx], torch.Tensor]
    needs_prev_neighbors: bool = False
    needs_deg_u: bool = True


@dataclasses.dataclass(frozen=True)
class OpaqueBias:
    """Fallback: evaluate ``spec.edge_bias`` on the dense full-context gather."""


BiasSource = Union[FlatBias, WindowBias, OpaqueBias]

# ---------------------------------------------------------------------------
# Epilogues
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdentityEpilogue:
    """Walk to the selected neighbor."""


@dataclasses.dataclass(frozen=True)
class MHAcceptEpilogue:
    """Metropolis-Hastings acceptance: keep ``u`` w.p. ``min(1, deg_v/deg_u)``,
    else stay at ``v`` (paper Table I, MHRW)."""


@dataclasses.dataclass(frozen=True)
class TeleportEpilogue:
    """With probability ``prob`` replace ``u`` by a teleport target.

    target="uniform": a uniform random vertex in ``[0, num_vertices)`` (jump);
    target="fixed":   the predetermined ``vertex`` (restart);
    target="home":    the walk's own seed vertex (restart-to-home) — the
                      engine carries the per-instance home vertex.
    """

    prob: float
    target: Literal["uniform", "fixed", "home"] = "uniform"
    vertex: int = -1
    num_vertices: int = 0

    def __post_init__(self):
        if self.target == "uniform" and self.num_vertices <= 0:
            raise ValueError(
                "TeleportEpilogue(target='uniform') needs num_vertices > 0 "
                "(randint over an empty range would silently teleport every "
                "jumper to vertex 0)"
            )
        if self.target == "fixed" and self.vertex < 0:
            raise ValueError("TeleportEpilogue(target='fixed') needs vertex >= 0")


@dataclasses.dataclass(frozen=True)
class OpaqueEpilogue:
    """Fallback: call ``spec.update`` (arbitrary user code)."""


Epilogue = Union[IdentityEpilogue, MHAcceptEpilogue, TeleportEpilogue, OpaqueEpilogue]

# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransitionProgram:
    """One walk step: bias source + epilogue + selection method.

    ``method`` is ``"auto"`` (the cost model picks per degree bucket) or one
    of ``"its"`` / ``"alias"`` / ``"rejection"`` for every bucket.  Only the
    flat path reads it; window and opaque programs always draw by ITS.
    """

    bias: BiasSource
    epilogue: Epilogue = IdentityEpilogue()
    method: str = "auto"

    def __post_init__(self):
        if self.method not in ("auto", "its", "alias", "rejection"):
            raise ValueError(
                f"unknown selection method {self.method!r}; expected one of "
                "'auto', 'its', 'alias', 'rejection'"
            )

    @property
    def carries_home(self) -> bool:
        return isinstance(self.epilogue, TeleportEpilogue) and self.epilogue.target == "home"

    @property
    def mode(self) -> str:
        """Engine dispatch: ``"flat"`` / ``"window"`` run the degree-bucketed
        fast path, ``"opaque"`` the dense-gather fallback."""
        if isinstance(self.bias, FlatBias):
            return "flat"
        if isinstance(self.bias, WindowBias):
            return "window"
        return "opaque"


def lower(spec: SamplingSpec) -> TransitionProgram:
    """Compile a spec's hooks into a transition program.

    A declared ``spec.transition`` wins (``spec.selection_method`` stamped
    onto it).  Otherwise the hooks are lowered: ``flat_edge_bias`` without
    ``needs_prev_neighbors`` ⇒ :class:`FlatBias`, anything else ⇒
    :class:`OpaqueBias`; an ``update`` other than ``identity_update`` ⇒
    :class:`OpaqueEpilogue`.  Only declarations reach :class:`WindowBias`.
    """
    override = spec.selection_method
    if spec.transition is not None:
        prog = spec.transition
        if override is not None and override != prog.method:
            prog = dataclasses.replace(prog, method=override)
        return prog
    if spec.flat_edge_bias is not None and not spec.needs_prev_neighbors:
        bias: BiasSource = FlatBias(spec.flat_edge_bias)
    else:
        bias = OpaqueBias()
    epi: Epilogue = IdentityEpilogue() if spec.update is identity_update else OpaqueEpilogue()
    return TransitionProgram(bias=bias, epilogue=epi, method=override or "auto")


# ---------------------------------------------------------------------------
# The post-select epilogue
# ---------------------------------------------------------------------------


def f32(x: float) -> float:
    """A Python scalar rounded to f32, as JAX applies weak-typed scalars to
    f32 arrays (exact in every torch op that takes it)."""
    return float(np.float32(x))


def apply_epilogue(
    key,
    program: TransitionProgram,
    spec: SamplingSpec,
    ctx: EdgeCtx,
    u: torch.Tensor,
    home: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Lowered UPDATE, shared by every walk mode.

    ``ctx`` is the EdgeCtx of the selected edge (D = 1 on the fast paths,
    the dense context on the opaque path) and ``u`` the selected neighbor
    ``(W,)``, -1 for dead walkers (preserved).  ``home`` is the per-walker
    seed, required iff ``program.carries_home``.  RNG: one ``key`` per step,
    drawn as the reference draws it.
    """
    epi = program.epilogue
    if isinstance(epi, IdentityEpilogue):
        return u
    dev = u.device
    if isinstance(epi, MHAcceptEpilogue):
        deg_u = _selected_deg_u(ctx, u)
        stay = mh_stay(uniform(key, u.shape, device=dev), ctx.deg_v, deg_u)
        return torch.where(stay & (ctx.v >= 0) & (u >= 0), ctx.v, u)
    if isinstance(epi, TeleportEpilogue):
        kj, kv = split(key)
        teleport = uniform(kj, u.shape, device=dev) < f32(epi.prob)
        if epi.target == "uniform":
            tgt = randint(kv, u.shape, 0, epi.num_vertices, device=dev)
        elif epi.target == "fixed":
            tgt = torch.full_like(u, epi.vertex)
        else:  # "home"
            if home is None:
                raise ValueError(
                    "TeleportEpilogue(target='home') needs the per-instance home array"
                )
            tgt = home
        return torch.where(teleport & (u >= 0), tgt, u)
    return spec.update(key, ctx, u)


def mh_stay(r: torch.Tensor, deg_v: torch.Tensor, deg_u: torch.Tensor) -> torch.Tensor:
    """The MH acceptance test: stay iff ``r >= min(1, deg_v/deg_u)``.

    ``deg_v``/``deg_u`` are int32 degrees; the quotient is a true f32
    divide, as JAX promotes int32 / int32 to float32.
    """
    accept_p = deg_v.to(torch.float32) / torch.clamp(deg_u, min=1).to(torch.float32)
    return r >= torch.clamp(accept_p, max=1.0)


def _selected_deg_u(ctx: EdgeCtx, u: torch.Tensor) -> torch.Tensor:
    """deg(u) for the selected neighbor, from whatever ctx the path built:
    the D = 1 context holds it; in a dense context, locate ``u``."""
    if ctx.u.shape[-1] == 1:
        return ctx.deg_u[..., 0]
    pos = (ctx.u == u[..., None]).to(torch.uint8).argmax(dim=-1, keepdim=True)
    return torch.where(u >= 0, torch.gather(ctx.deg_u, -1, pos)[..., 0], 1)
