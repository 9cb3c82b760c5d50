"""Transition programs: lowering a spec onto the walk fast path (flat mode).

Same IR as ``repro.core.transition``: a program names where the per-edge
bias comes from and what happens after the draw.  This slice runs
:class:`FlatBias` with :class:`IdentityEpilogue`; window biases (node2vec),
the Metropolis-Hastings epilogue and teleports arrive with the next slice
and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.api import SamplingSpec

_NEXT_SLICE = (
    "arrives with the window-bias slice of the port (node2vec window biases, "
    "the MH and teleport epilogues)"
)


@dataclasses.dataclass(frozen=True)
class FlatBias:
    """Static per-edge bias: ``fn(graph) -> (E,)`` float32 in CSR order."""

    fn: Callable[[object], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class IdentityEpilogue:
    """Walk to the selected neighbor."""


@dataclasses.dataclass(frozen=True)
class TransitionProgram:
    """One walk step: bias source + epilogue + selection method.

    ``method`` is ``"auto"`` (the cost model picks per degree bucket) or one
    of ``"its"`` / ``"alias"`` / ``"rejection"`` for every bucket.
    """

    bias: FlatBias
    epilogue: IdentityEpilogue = IdentityEpilogue()
    method: str = "auto"

    def __post_init__(self):
        if self.method not in ("auto", "its", "alias", "rejection"):
            raise ValueError(
                f"unknown selection method {self.method!r}; expected one of "
                "'auto', 'its', 'alias', 'rejection'"
            )
        if not isinstance(self.bias, FlatBias):
            raise NotImplementedError(f"bias source {self.bias!r} {_NEXT_SLICE}")
        if not isinstance(self.epilogue, IdentityEpilogue):
            raise NotImplementedError(f"epilogue {self.epilogue!r} {_NEXT_SLICE}")

    @property
    def mode(self) -> str:
        return "flat"


def WindowBias(*args, **kwargs):  # noqa: N802 — the reference's class name
    raise NotImplementedError(f"WindowBias {_NEXT_SLICE}")


def MHAcceptEpilogue(*args, **kwargs):  # noqa: N802
    raise NotImplementedError(f"MHAcceptEpilogue {_NEXT_SLICE}")


def TeleportEpilogue(*args, **kwargs):  # noqa: N802
    raise NotImplementedError(f"TeleportEpilogue {_NEXT_SLICE}")


def lower(spec: SamplingSpec) -> TransitionProgram:
    """Compile a spec into its transition program.

    A declared ``spec.transition`` wins; otherwise ``flat_edge_bias`` lowers
    to :class:`FlatBias`.  ``spec.selection_method`` is stamped onto the
    program.  A spec with neither has an opaque bias, which this slice
    does not run.
    """
    override = spec.selection_method
    if spec.transition is not None:
        prog = spec.transition
        if override is not None and override != prog.method:
            prog = dataclasses.replace(prog, method=override)
        return prog
    if spec.flat_edge_bias is None:
        raise NotImplementedError(f"opaque edge-bias specs {_NEXT_SLICE}")
    return TransitionProgram(bias=FlatBias(spec.flat_edge_bias), method=override or "auto")
