"""The LM configurations of the port (port of ``repro.configs.lm_configs``),
exact public configs: DeepSeek-V2 [arXiv:2405.04434], DeepSeek-V3
[arXiv:2412.19437], Command-R / Command-R+ [hf:CohereForAI],
Granite-3.0-2B [hf:ibm-granite], and the reduced smoke configs. d_ff for
the MoE archs is the leading dense layers' published width; the routed
experts' is d_ff_expert."""
from __future__ import annotations

import torch

from repro_torch.archs.lm import LMArch
from repro_torch.models.transformer.model import TransformerConfig


def deepseek_v2_236b() -> LMArch:
    """60 layers, d 5120, 128 MLA heads (kv_lora 512, q_lora 1536), 160 routed
    experts top-6 + 2 shared, expert d_ff 1536, the first layer dense (d_ff
    12288). grad_accum 2, the reference's."""
    return LMArch(
        TransformerConfig(name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
                          n_kv_heads=128, head_dim=192, d_ff=12288, vocab_size=102400,
                          attn_type="mla", q_lora_rank=1536, kv_lora_rank=512, d_nope=128,
                          d_rope=64, d_v=128, n_experts=160, n_shared_experts=2, top_k=6,
                          d_ff_expert=1536, n_dense_layers=1),
        optimizer="adafactor", grad_accum=2,
    )


def deepseek_v3_671b() -> LMArch:
    """61 layers, d 7168, 128 MLA heads, 256 routed experts top-8 + 1 shared,
    expert d_ff 2048, the first 3 layers dense (d_ff 18432), MTP."""
    return LMArch(
        TransformerConfig(name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
                          n_kv_heads=128, head_dim=192, d_ff=18432, vocab_size=129280,
                          attn_type="mla", q_lora_rank=1536, kv_lora_rank=512, d_nope=128,
                          d_rope=64, d_v=128, n_experts=256, n_shared_experts=1, top_k=8,
                          d_ff_expert=2048, n_dense_layers=3, mtp=True),
        optimizer="adafactor", grad_accum=4,
    )


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


def smoke_lm(attn_type: str = "gqa", moe: bool = False, mtp: bool = False) -> LMArch:
    """The reference's ``smoke_lm``: a reduced config of the same family,
    float32, for CPU tests (smoke-gqa, smoke-mla-moe)."""
    kw = dict(name=f"smoke-{attn_type}{'-moe' if moe else ''}", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2 if attn_type == "gqa" else 4, head_dim=16, d_ff=128,
              vocab_size=512, attn_type=attn_type, param_dtype=torch.float32,
              compute_dtype=torch.float32, attn_chunk=16, ce_chunk=16, remat="none", mtp=mtp)
    if attn_type == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16)
    if moe:
        kw.update(n_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=32, n_dense_layers=1)
    return LMArch(TransformerConfig(**kw), optimizer="adamw", shapes=SMOKE_LM_SHAPES)


def smoke_gqa() -> LMArch:
    return smoke_lm("gqa")


def smoke_mla_moe() -> LMArch:
    return smoke_lm("mla", moe=True, mtp=True)
