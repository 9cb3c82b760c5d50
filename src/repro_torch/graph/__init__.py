"""Graph substrate: CSR storage and generators."""
from repro_torch.graph.csr import (
    CSRGraph,
    csr_from_arrays,
    csr_from_edges,
    resolve_device,
)
from repro_torch.graph.generators import erdos_renyi_graph, powerlaw_graph, rmat_graph

__all__ = [
    "CSRGraph",
    "csr_from_arrays",
    "csr_from_edges",
    "resolve_device",
    "rmat_graph",
    "erdos_renyi_graph",
    "powerlaw_graph",
]
