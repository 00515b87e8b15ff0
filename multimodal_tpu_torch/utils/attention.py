"""Attention-mask helpers. Counterpart of ``multimodal_tpu/utils/attention.py``:
additive-bias or boolean masks."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative additive bias; safe in bf16/fp32 softmax


def get_extended_attention_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Broadcast a padding mask (1 = attend) of shape ``(batch, seq)``,
    ``(batch, q, k)`` or ``(batch, heads, q, k)`` to an fp32 attention bias
    ``(batch, 1, 1, seq)``, ``(batch, 1, q, k)`` or ``(batch, heads, q, k)``:
    0 where attended, ``NEG_INF`` where masked."""
    if attention_mask.dim() == 2:
        ext = attention_mask[:, None, None, :]
    elif attention_mask.dim() == 3:
        ext = attention_mask[:, None, :, :]
    elif attention_mask.dim() == 4:
        ext = attention_mask
    else:
        raise ValueError(f"bad attention mask ndim {attention_mask.dim()}")
    return (1.0 - ext.to(torch.float32)) * NEG_INF


def get_causal_attention_mask(tgt_len: int, src_len: Optional[int] = None,
                              device=None) -> torch.Tensor:
    """Lower-triangular boolean mask ``(tgt_len, src_len)``; True = attend."""
    if src_len is None:
        src_len = tgt_len
    return torch.ones(tgt_len, src_len, dtype=torch.bool, device=device).tril()


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND together boolean masks (broadcasting), skipping Nones."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else torch.logical_and(out, m)
    return out
