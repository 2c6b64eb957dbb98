"""The training core of the port (port of ``repro.train``): the AdamW and
Adafactor optimizers and the train-step builder."""
from repro_torch.train.optimizer import Optimizer, adafactor, adamw, apply_updates
from repro_torch.train.train_step import (
    clip_by_global_norm,
    global_norm,
    gradients,
    init_state,
    make_train_step,
    param_leaves,
    reference_key,
    reference_layout,
)

__all__ = [
    "Optimizer",
    "adafactor",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "gradients",
    "init_state",
    "make_train_step",
    "param_leaves",
    "reference_key",
    "reference_layout",
]
