"""Packed requirement bitsets.

A requirement is a membership mask over an interned value vocabulary, packed
32 values per 32-bit word. Torch's uint32 lacks shifts on many backends, so
the port keeps the words as int32 holding the same bits (numpy
`.view(np.int32)`); `(w >> b) & 1` on int32 yields bit b for 0 <= b < 32.
"""

from __future__ import annotations

import numpy as np
import torch


def words_for(n_values: int) -> int:
    return max(1, (n_values + 31) // 32)


def pack_bool_masks(bools: np.ndarray) -> np.ndarray:
    """[..., V] bool -> [..., ceil(V/32)] uint32 (little-endian bit order)."""
    *lead, v = bools.shape
    w = words_for(v)
    padded = np.zeros((*lead, w * 32), dtype=bool)
    padded[..., :v] = bools
    r = padded.reshape(*lead, w, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    packed = (r.astype(np.uint64) * weights).sum(axis=-1)
    return packed.astype(np.uint32)


def as_int32_words(masks: np.ndarray) -> np.ndarray:
    """uint32 words -> int32 words with the same bits."""
    return np.ascontiguousarray(masks.astype(np.uint32)).view(np.int32)


def test_bit(masks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """masks: [..., W] int32 words; idx: [...] int32 value ids -> [...] bool.

    The word index is clamped to [0, W-1]; idx < 0 returns False."""
    n_words = masks.shape[-1]
    word_idx = torch.clamp(torch.div(idx, 32, rounding_mode="floor"), 0, n_words - 1).to(torch.int64)
    bit_idx = torch.remainder(idx, 32).to(torch.int32)
    words = torch.gather(masks, -1, word_idx.unsqueeze(-1)).squeeze(-1)
    hit = torch.bitwise_and(torch.bitwise_right_shift(words, bit_idx), 1)
    return (idx >= 0) & (hit != 0)
