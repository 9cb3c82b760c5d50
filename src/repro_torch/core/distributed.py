"""Multi-device sampling (paper §V-D, and graph sharding beyond it).

Paper-faithful mode, :func:`instance_parallel_walk`: the sampling instances
are split into equal groups over the mesh's shards, the graph is replicated,
and no shard talks to another but for one sum of sampled edges.

Graph sharding (each shard owns a vertex range, walkers routed to the owner
of their vertex) lives in ``repro_torch.shard``; :func:`graph_sharded_walk`
is a thin wrapper over it, as ``repro.core.distributed``'s is.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import transition as tp
from repro_torch.core.api import SamplingSpec
from repro_torch.core.engine import WalkResult, random_walk
from repro_torch.core.rng import fold_in, key_from_array
from repro_torch.graph.csr import CSRGraph
from repro_torch.shard.mesh import ShardMesh
from repro_torch.shard.walk import (  # noqa: F401  (re-exported, as repro's)
    replicated_psum_walk,
    shard_graph_for_mesh,
    sharded_random_walk,
)


def instance_parallel_walk(mesh: ShardMesh, graph: CSRGraph, seeds, key, *, depth: int,
                           spec: SamplingSpec, max_degree: int) -> WalkResult:
    """Instances split over the mesh's shards, the graph replicated.

    Shard ``d`` of a ``D``-shard mesh walks instances ``[d·n/D, (d+1)·n/D)``
    under ``fold_in(fold_in(key, D), d)`` (so meshes of different sizes draw
    disjoint streams), on its own device; ``sampled_edges`` is the sum over
    the shards.  The instance count must divide evenly, as ``shard_map``
    requires.  A flat program walks every cohort by ITS: ``repro``'s walk
    runs inside ``shard_map`` on a traced graph, where its planner cannot
    read degrees and keeps the all-ITS plan.  Returns the walks and lengths
    on the mesh's first device.
    """
    seeds = torch.as_tensor(seeds)
    n, ndev = int(seeds.shape[0]), mesh.size
    if n % ndev:
        raise ValueError(f"{n} instances do not split evenly over {ndev} shards")
    per = n // ndev
    key = key_from_array(key)
    home = mesh.devices[0]
    if tp.lower(spec).mode == "flat":
        spec = dataclasses.replace(spec, selection_method="its")
    runs = []
    for d, dev in enumerate(mesh.devices):
        kdev = fold_in(fold_in(key, ndev), d)
        runs.append(random_walk(graph, seeds[d * per:(d + 1) * per], kdev, depth=depth,
                                spec=spec, max_degree=max_degree, device=dev))
    total = mesh.psum([r.sampled_edges for r in runs])[0]
    return WalkResult(torch.cat([r.walks.to(home) for r in runs]),
                      torch.cat([r.lengths.to(home) for r in runs]), total)


def graph_sharded_walk(mesh: ShardMesh, graph: CSRGraph, seeds, key, *, depth: int,
                       spec: SamplingSpec, max_degree: int) -> torch.Tensor:
    """Walks ``(I, depth+1)`` over a sharded graph: a wrapper over
    ``shard.sharded_random_walk`` (bit-identical to single-device
    ``random_walk`` for flat and window programs; opaque programs take its
    replicated-``psum`` fallback)."""
    return sharded_random_walk(mesh, graph, seeds, key, depth=depth, spec=spec,
                               max_degree=max_degree).walks
