from repro_torch.common.distances import (
    batched_rowwise_sqdist,
    cosine_distance,
    neg_inner_product,
    squared_l2,
    squared_l2_one_to_many,
)
from repro_torch.common.kmeans import kmeans

__all__ = ["batched_rowwise_sqdist", "cosine_distance", "kmeans", "neg_inner_product",
           "squared_l2", "squared_l2_one_to_many"]
