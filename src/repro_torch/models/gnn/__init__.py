"""The MACE GNN family of the port (port of ``repro.models.gnn``): the model,
the fanout sampler and the destination-partitioned loss."""
from repro_torch.models.gnn.mace import (
    MACE,
    MACEConfig,
    energy,
    energy_and_forces,
    init_params,
    loss,
)
from repro_torch.models.gnn.sampler import sample_neighbors, sample_subgraph, subgraph_sizes

__all__ = ["MACE", "MACEConfig", "energy", "energy_and_forces", "init_params", "loss",
           "sample_neighbors", "sample_subgraph", "subgraph_sizes"]
