from repro_torch.models.common.modules import MLP

__all__ = ["MLP"]
