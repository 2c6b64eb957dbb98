from repro_torch.models.recsys.models import (
    RecsysConfig,
    TwoTower,
    embedding_bag_sum,
    stable_topk,
    two_tower_init,
)

__all__ = ["RecsysConfig", "TwoTower", "embedding_bag_sum", "stable_topk", "two_tower_init"]
