"""Mesh-sharded sampling: owner-routed frontier exchange (§V-D).

The port of ``repro.shard``: each shard of a :class:`ShardMesh` holds one
vertex-range partition (plus the replicated hub rows), walkers are routed to
the shard that owns their vertex, and overflow defers to the next round
instead of dropping.  Flat and window transition programs equal the
single-device ``random_walk`` bit for bit; opaque programs take the
replicated ``psum`` fallback.  One process drives every shard;
``ShardMesh.on("cuda:0", 4)`` puts four shards on one card and
``ShardMesh.on("cpu", D)`` runs them on the CPU.
"""
from repro_torch.shard.exchange import (
    ShardQueue,
    all_to_all_fields,
    make_queue,
    queue_pop,
    queue_push,
    route_by_owner,
)
from repro_torch.shard.mesh import ShardMesh
from repro_torch.shard.walk import (
    replicated_psum_walk,
    shard_graph_for_mesh,
    sharded_random_walk,
)

__all__ = [
    "ShardMesh",
    "ShardQueue",
    "all_to_all_fields",
    "make_queue",
    "queue_pop",
    "queue_push",
    "replicated_psum_walk",
    "route_by_owner",
    "shard_graph_for_mesh",
    "sharded_random_walk",
]
