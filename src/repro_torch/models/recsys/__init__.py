from repro_torch.models.recsys.models import (
    DLRM,
    NEG_CHUNK,
    DeepFM,
    RecsysConfig,
    SASRec,
    TwoTower,
    deepfm_init,
    deepfm_loss,
    dlrm_init,
    dlrm_loss,
    embedding_bag_sum,
    sasrec_init,
    sasrec_loss,
    sasrec_serve,
    stable_topk,
    two_tower_init,
    two_tower_loss,
)

__all__ = ["DLRM", "DeepFM", "NEG_CHUNK", "RecsysConfig", "SASRec", "TwoTower", "deepfm_init",
           "deepfm_loss", "dlrm_init", "dlrm_loss", "embedding_bag_sum", "sasrec_init",
           "sasrec_loss", "sasrec_serve", "stable_topk", "two_tower_init", "two_tower_loss"]
