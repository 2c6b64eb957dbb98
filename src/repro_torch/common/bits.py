"""32-bit word helpers shared by the bitsets and sort keys.

The JAX package keeps its bitsets (visited, label words, tombstones) as
uint32. PyTorch's uint32 lacks shifts, comparisons and scatter-adds on the
CPU, so the port stores the same bits as int32 and does every shift, mask
and comparison in int64, where bit 31 is an ordinary positive bit.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
U32_MASK = 0xFFFFFFFF


def n_words(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values, as int64."""
    return words.to(torch.int64) & U32_MASK


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(values >= 2**31, values - 2**32, values).to(torch.int32)


def bit_of(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx & 31`` of each int32 word, as bool (shapes broadcast)."""
    return ((u32(words) >> (idx.to(torch.int64) & (WORD_BITS - 1))) & 1).bool()


def tail_bits(n_live: int, n: int) -> np.ndarray:
    """(ceil(n/32),) uint32 words with bits [n_live, n) set: the tombstone
    bitmap of a pool or sub-corpus whose rows from ``n_live`` on are dead."""
    bits = np.zeros((n_words(n) * WORD_BITS,), np.uint8)
    bits[n_live:n] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)
