"""The decoder-only transformer of the port (port of
``repro.models.transformer``): dense GQA layers, prefill and the KV-cache
decode."""
from repro_torch.models.transformer.model import (
    Transformer,
    TransformerConfig,
    cache_shape,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    prefill_logits,
)

__all__ = ["Transformer", "TransformerConfig", "cache_shape", "decode_step", "forward_hidden",
           "init_cache", "init_params", "prefill_logits"]
