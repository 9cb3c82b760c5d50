"""C-SAW core: the spec API, transition programs, counted RNG, selection,
the adaptive method planner, the degree-bucketed scheduler, the walk and
traversal engines, the multi-request segment walk, and the out-of-memory
engine with its frontier queues."""
from repro_torch.core import algorithms, backend, frontier, methods, oom, rng, select, transition
from repro_torch.core.api import (
    EdgeCtx,
    SamplingSpec,
    VertexCtx,
    degree_edge_bias,
    degree_vertex_bias,
    uniform_edge_bias,
    uniform_vertex_bias,
    weight_edge_bias,
)
from repro_torch.core.select import (
    SelectResult,
    build_ctps,
    its_search,
    select_with_replacement,
    select_without_replacement,
    walk_transition_chunked,
)
from repro_torch.core.engine import (
    SampleResult,
    WalkResult,
    flat_method_plan,
    random_walk,
    random_walk_segments,
    traversal_sample,
)
from repro_torch.core.oom import OOMStats, oom_random_walk
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
    "VertexCtx",
    "degree_edge_bias",
    "degree_vertex_bias",
    "uniform_edge_bias",
    "uniform_vertex_bias",
    "weight_edge_bias",
    "SelectResult",
    "build_ctps",
    "its_search",
    "select_with_replacement",
    "select_without_replacement",
    "walk_transition_chunked",
    "SampleResult",
    "WalkResult",
    "flat_method_plan",
    "random_walk",
    "random_walk_segments",
    "traversal_sample",
    "OOMStats",
    "oom_random_walk",
    "algorithms",
    "backend",
    "frontier",
    "methods",
    "oom",
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
