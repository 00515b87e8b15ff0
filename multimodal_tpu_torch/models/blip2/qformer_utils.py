"""Q-Former mask helpers. Counterpart of
``multimodal_tpu/models/blip2/qformer_utils.py`` (``get_causal_mask``)."""

from __future__ import annotations

from typing import Tuple

import torch


def get_causal_mask(attention_mask: torch.Tensor, input_shape: Tuple[int, int],
                    has_query: bool = False) -> torch.Tensor:
    """Causal mask over the text suffix with a fully attendable prefix (a
    cached context or the queries), 1.0 = attend, ``(b, q_len,
    attn_seq_len)`` fp32. ``attention_mask`` ``(b, attn_seq_len)`` is the
    padding mask; ``input_shape`` ``(b, input_seq_len)`` the embedding
    output's, shorter than ``attn_seq_len`` when a prefix is cached. With a
    query prefix the queries attend each other but not the text."""
    batch_size, seq_len = input_shape
    dev = attention_mask.device
    causal = torch.ones(seq_len, seq_len, device=dev).tril()[None].expand(batch_size, -1, -1)
    attn_len = attention_mask.shape[1]
    if seq_len < attn_len:
        prefix_len = attn_len - seq_len
        if has_query:
            causal = torch.cat([torch.zeros(batch_size, prefix_len, seq_len, device=dev),
                                causal], dim=1)
        causal = torch.cat([torch.ones(batch_size, causal.shape[1], prefix_len, device=dev),
                            causal], dim=-1)
    return causal
