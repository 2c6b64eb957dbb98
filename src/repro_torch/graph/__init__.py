from repro_torch.graph.build import add_reverse_edges, build_knn_graph, medoid
from repro_torch.graph.index import build_index

__all__ = ["add_reverse_edges", "build_index", "build_knn_graph", "medoid"]
