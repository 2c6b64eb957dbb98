"""Exact visited set as a batched bitset (port of ``repro.core.visited``).

A (B, ceil(n/32)) int32 tensor holding the reference's uint32 bits. Within
one step each row's id list is duplicate-free and bits are only set for ids
that tested unvisited, so a scatter-ADD of the bit values equals an OR: no
carries. int32 addition wraps modulo 2**32, so adding bit 31 (the int32
value -2**31) to a word whose bit 31 is clear sets exactly that bit.
"""
from __future__ import annotations

import torch

from repro_torch.common.bits import WORD_BITS, bit_of, n_words, to_i32, u32
from repro_torch.common.device import resolve_device

__all__ = ["WORD_BITS", "n_words", "visited_count", "visited_init", "visited_set",
           "visited_test"]


def visited_init(batch: int, n: int, device="cuda") -> torch.Tensor:
    return torch.zeros((batch, n_words(n)), dtype=torch.int32, device=resolve_device(device))


def visited_test(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, W) x (B, M) -> (B, M) bool. Padding ids (< 0) report as visited."""
    safe = ids.clamp_min(0).to(torch.int64)
    word = words.gather(1, safe >> 5)
    return torch.where(ids >= 0, bit_of(word, safe), True)


def visited_set(words: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Return ``words`` with the bits of ``ids`` set where ``mask`` holds.

    Caller contract: every (row, id) pair with ``mask`` set is currently
    unvisited and appears at most once in ``ids[row]``.
    """
    safe = ids.clamp_min(0).to(torch.int64)
    bits = torch.where(mask & (ids >= 0), torch.ones_like(safe) << (safe & 31), 0)
    rows = torch.arange(words.shape[0], device=words.device)[:, None].expand_as(safe)
    return words.index_put((rows, safe >> 5), to_i32(bits), accumulate=True)


def visited_count(words: torch.Tensor) -> torch.Tensor:
    """(B,) int32 number of set bits: vertices touched per query."""
    x = u32(words)
    # SWAR popcount per 32-bit word, as the reference.
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(-1).to(torch.int32)
