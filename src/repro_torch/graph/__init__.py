"""Graph substrate of the port: the container and the generators."""
from .generators import TABLE3_PRESETS, erdos_renyi, paper_dataset, random_dag, web_graph
from .structure import (
    Graph,
    csr_from_graph,
    graph_from_arrays,
    graph_from_edges,
    validate_graph,
)

__all__ = [
    "Graph", "TABLE3_PRESETS", "csr_from_graph", "erdos_renyi",
    "graph_from_arrays", "graph_from_edges", "paper_dataset", "random_dag",
    "validate_graph", "web_graph",
]
