from repro_torch.graph.build import add_reverse_edges, build_knn_graph, medoid, nn_descent
from repro_torch.graph.index import build_index, build_partitioned_index

__all__ = [
    "add_reverse_edges",
    "build_index",
    "build_knn_graph",
    "build_partitioned_index",
    "medoid",
    "nn_descent",
]
