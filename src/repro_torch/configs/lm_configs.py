"""The dense GQA LM configurations of the port (port of the GQA entries of
``repro.configs.lm_configs``): Command-R / Command-R+ [hf:CohereForAI],
Granite-3.0-2B [hf:ibm-granite] and the reduced smoke config. The
DeepSeek configs (MLA, MoE, MTP) are ROADMAP item 14c."""
from __future__ import annotations

import torch

from repro_torch.archs.lm import LMArch
from repro_torch.models.transformer.model import TransformerConfig


def command_r_plus_104b() -> LMArch:
    return LMArch(
        TransformerConfig(name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
                          n_kv_heads=8, head_dim=128, d_ff=33792, vocab_size=256000,
                          attn_type="gqa"),
        optimizer="adafactor",
    )


def command_r_35b() -> LMArch:
    return LMArch(
        TransformerConfig(name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
                          n_kv_heads=8, head_dim=128, d_ff=22528, vocab_size=256000,
                          attn_type="gqa"),
        optimizer="adafactor",
    )


def granite_3_2b() -> LMArch:
    return LMArch(
        TransformerConfig(name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
                          n_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=49155,
                          attn_type="gqa"),
        optimizer="adamw",
    )


SMOKE_LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=32, global_batch=4),
    "prefill_32k": dict(kind="serve", seq_len=64, global_batch=2),
    "decode_32k": dict(kind="serve", seq_len=64, global_batch=4),
    "long_500k": dict(kind="serve", seq_len=128, global_batch=1),
}


def smoke_gqa() -> LMArch:
    """The reference's ``smoke_lm("gqa")``: a reduced config of the same
    family, float32, for CPU tests."""
    return LMArch(
        TransformerConfig(name="smoke-gqa", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512, attn_type="gqa",
                          param_dtype=torch.float32, compute_dtype=torch.float32,
                          attn_chunk=16, ce_chunk=16, remat="none"),
        optimizer="adamw", shapes=SMOKE_LM_SHAPES,
    )
