"""Graph substrate: CSR storage, generators and vertex-range partitions."""
from repro_torch.graph.csr import (
    CSRGraph,
    csr_from_arrays,
    csr_from_edges,
    degrees,
    neighbors_padded,
    resolve_device,
)
from repro_torch.graph.generators import erdos_renyi_graph, powerlaw_graph, rmat_graph
from repro_torch.graph.partition import (
    DevicePartition,
    PartitionMap,
    RangePartition,
    partition_by_vertex_range,
    partition_of,
)

__all__ = [
    "CSRGraph",
    "csr_from_arrays",
    "csr_from_edges",
    "degrees",
    "neighbors_padded",
    "resolve_device",
    "rmat_graph",
    "erdos_renyi_graph",
    "powerlaw_graph",
    "DevicePartition",
    "PartitionMap",
    "RangePartition",
    "partition_by_vertex_range",
    "partition_of",
]
