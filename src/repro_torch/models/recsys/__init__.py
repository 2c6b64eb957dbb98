from repro_torch.models.recsys.models import (
    DLRM,
    NEG_CHUNK,
    DeepFM,
    RecsysConfig,
    TwoTower,
    deepfm_init,
    deepfm_loss,
    dlrm_init,
    dlrm_loss,
    embedding_bag_sum,
    stable_topk,
    two_tower_init,
    two_tower_loss,
)

__all__ = ["DLRM", "DeepFM", "NEG_CHUNK", "RecsysConfig", "TwoTower", "deepfm_init",
           "deepfm_loss", "dlrm_init", "dlrm_loss", "embedding_bag_sum", "stable_topk",
           "two_tower_init", "two_tower_loss"]
