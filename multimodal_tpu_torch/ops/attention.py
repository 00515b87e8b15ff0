"""Attention dispatch: the flash kernel from a sequence length up, plain
math below it.

Counterpart of ``multimodal_tpu/ops/attention.py``. Takes a boolean mask
(True = attend) or an additive float bias, causal masking, packed-sequence
segment ids, attention dropout and the probabilities (those two on the plain
path only: returning the full probability matrix defeats the point of the
fused kernel).

``FLASH_MIN_SEQ`` is this card's threshold, not the JAX package's TPU one:
on an H100 80GB HBM3 the flash kernel (``ops/flash_attention.py``) beats the
plain path at every length ``chip_smoke.py`` times, 32 to 1024, at the LM's
heads (2.7-3.9x at 32; PERF.md), so the flash path starts at the shortest of
them; below 32 the choice is unmeasured. A CPU tensor at or above it takes
the flash wrapper too, which runs its plain version there.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from multimodal_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention

FLASH_MIN_SEQ = 32


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    sm_scale: Optional[float] = None,
    return_probs: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Multi-head attention over ``(batch, heads, seq, head_dim)`` tensors.

    Args:
        mask: boolean, True = attend, broadcastable to (b, h, sq, sk).
        bias: additive float bias, broadcastable to (b, h, sq, sk).
        is_causal: bottom-right aligned causal masking.
        dropout_rate / generator: attention-probability dropout (plain path).
        return_probs: also return the post-softmax probabilities.
        segment_ids: (b, s) ids for packed self-attention (sq == sk):
            positions attend only within their segment.
    """
    if segment_ids is not None and q.shape[-2] != k.shape[-2]:
        raise ValueError("segment_ids require self-attention (sq == sk)")
    q_segment_ids = kv_segment_ids = None
    if segment_ids is not None:
        q_segment_ids = kv_segment_ids = segment_ids.to(torch.int32)
    # A bool key-padding mask (b, 1, 1, sk) becomes segment ids: O(S) on the
    # flash path instead of an O(S^2) bias.
    if (
        segment_ids is None
        and mask is not None
        and bias is None
        and mask.dtype == torch.bool
        and mask.dim() == 4
        and mask.shape[1] == 1
        and mask.shape[2] == 1
        and mask.shape[3] == k.shape[-2]
    ):
        kv_segment_ids = mask[:, 0, 0, :].to(torch.int32).expand(q.shape[0], k.shape[-2])
        q_segment_ids = torch.ones((q.shape[0], q.shape[-2]), dtype=torch.int32, device=q.device)
        mask = None

    if mask is not None:
        mask_bias = torch.where(mask, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
        bias = mask_bias if bias is None else bias + mask_bias

    use_flash = (
        not return_probs
        and dropout_rate == 0.0
        and q.shape[-2] >= FLASH_MIN_SEQ
        and k.shape[-2] >= FLASH_MIN_SEQ
    )
    if use_flash:
        return flash_attention(q, k, v, bias, is_causal, sm_scale, q_segment_ids,
                               kv_segment_ids)

    out, p = attention_plain(q, k, v, bias, is_causal, sm_scale, q_segment_ids, kv_segment_ids,
                             dropout_rate, generator)
    return (out, p) if return_probs else out


def attention_plain(q, k, v, bias=None, is_causal: bool = False,
                    sm_scale: Optional[float] = None, q_segment_ids=None, kv_segment_ids=None,
                    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None):
    """The plain path (the JAX package's XLA branch): fp32 scores and
    softmax, masked entries at -1e30, the probabilities cast to ``v``'s dtype
    for the second product. Returns the output and the probabilities."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if q_segment_ids is not None:
        allowed = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        s = torch.where(allowed, s, DEFAULT_MASK_VALUE)
    if is_causal:
        sq, sk = s.shape[-2], s.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = torch.where(causal, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    p_dropped = p
    if dropout_rate > 0.0:
        keep = torch.rand(p.shape, generator=generator, device=p.device) >= dropout_rate
        p_dropped = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.matmul(p_dropped.to(v.dtype), v), p
