"""The decoder-only transformer of the port (port of
``repro.models.transformer``): GQA and MLA attention, dense and MoE
feed-forwards, prefill and the KV-cache decode on one device or over a
mesh."""
from repro_torch.models.transformer.model import (
    Transformer,
    TransformerConfig,
    cache_shape,
    decode_step,
    forward_hidden,
    gather_cache,
    init_cache,
    init_params,
    make_resident,
    prefill_logits,
    shard_cache,
)

__all__ = ["Transformer", "TransformerConfig", "cache_shape", "decode_step", "forward_hidden",
           "gather_cache", "init_cache", "init_params", "make_resident", "prefill_logits",
           "shard_cache"]
