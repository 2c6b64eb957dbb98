from repro_torch.common.distances import batched_rowwise_sqdist, squared_l2
from repro_torch.common.kmeans import kmeans

__all__ = ["batched_rowwise_sqdist", "kmeans", "squared_l2"]
