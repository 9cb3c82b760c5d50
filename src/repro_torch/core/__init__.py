"""C-SAW core, random walks: the spec API, transition programs, counted
RNG, selection, the adaptive method planner, the degree-bucketed scheduler
and the walk engine."""
from repro_torch.core import algorithms, backend, methods, rng, select, transition
from repro_torch.core.api import EdgeCtx, SamplingSpec
from repro_torch.core.engine import WalkResult, flat_method_plan, random_walk
from repro_torch.core.transition import (
    FlatBias,
    IdentityEpilogue,
    MHAcceptEpilogue,
    OpaqueBias,
    OpaqueEpilogue,
    TeleportEpilogue,
    TransitionProgram,
    WindowBias,
)

__all__ = [
    "EdgeCtx",
    "SamplingSpec",
    "WalkResult",
    "flat_method_plan",
    "random_walk",
    "algorithms",
    "backend",
    "methods",
    "rng",
    "select",
    "transition",
    "FlatBias",
    "IdentityEpilogue",
    "MHAcceptEpilogue",
    "OpaqueBias",
    "OpaqueEpilogue",
    "TeleportEpilogue",
    "TransitionProgram",
    "WindowBias",
]
