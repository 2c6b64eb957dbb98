from repro_torch.data.pipeline import (
    deepfm_batch,
    dlrm_batch,
    gnn_batch,
    lm_batch,
    sasrec_batch,
    sasrec_serve_batch,
    shard_batch,
    two_tower_batch,
)
from repro_torch.data.synthetic import (
    clustered_vectors,
    kmeans_labels,
    make_labeled_corpus,
    make_queries,
    randomize_labels,
)

__all__ = [
    "clustered_vectors",
    "deepfm_batch",
    "dlrm_batch",
    "gnn_batch",
    "kmeans_labels",
    "lm_batch",
    "make_labeled_corpus",
    "make_queries",
    "randomize_labels",
    "sasrec_batch",
    "sasrec_serve_batch",
    "shard_batch",
    "two_tower_batch",
]
