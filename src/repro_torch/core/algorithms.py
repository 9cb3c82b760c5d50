"""Algorithm zoo, flat-bias random walks (paper Table I).

Each constructor returns a :class:`SamplingSpec` whose per-edge bias is a
static CSR-order array, as in ``repro.core.algorithms``.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import SamplingSpec
from repro_torch.core.transition import FlatBias, TransitionProgram


# flat per-edge biases (CSR order); each agrees with the reference's
# EdgeCtx hook on every real edge
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
        flat_edge_bias=_flat_uniform,
        transition=TransitionProgram(bias=FlatBias(_flat_uniform)),
        name="deepwalk",
    )


def biased_random_walk() -> SamplingSpec:
    """Static biased walk: neighbor degree as bias (Biased DeepWalk)."""
    return SamplingSpec(
        flat_edge_bias=_flat_degree,
        transition=TransitionProgram(bias=FlatBias(_flat_degree)),
        name="biased_rw",
    )


def weighted_random_walk() -> SamplingSpec:
    """Static biased walk on edge weights."""
    return SamplingSpec(
        flat_edge_bias=_flat_weight,
        transition=TransitionProgram(bias=FlatBias(_flat_weight)),
        name="weighted_rw",
    )
