"""C-SAW core, flat-bias random walks: the spec API, transition programs,
counted RNG, selection, the adaptive method planner, the degree-bucketed
scheduler and the walk engine."""
from repro_torch.core import algorithms, backend, methods, rng, select, transition
from repro_torch.core.api import SamplingSpec
from repro_torch.core.engine import WalkResult, flat_method_plan, random_walk
from repro_torch.core.transition import FlatBias, IdentityEpilogue, TransitionProgram

__all__ = [
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
    "TransitionProgram",
]
