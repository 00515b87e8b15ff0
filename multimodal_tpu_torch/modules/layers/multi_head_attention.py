"""Multi-head attention: self-attention off one fused QKV projection, and
attention with separate q/k/v projections and a KV cache.

Counterpart of ``multimodal_tpu/modules/layers/multi_head_attention.py``
(``MultiHeadSelfAttention``, ``MultiHeadAttentionWithCache`` and their
helpers). ``MultiHeadSelfAttention`` takes the fused attention kernel
(``ops/fused_encoder.py:fused_qkv_attention``, kernel #1, with a key-padding
mask on its key-bias lane) on the JAX layer's condition: no probabilities
asked for, no attention dropout, and a shape the kernel takes; else the
split-head path of ``ops/attention.py``. The cache is an explicit
``(k, v)`` pair handed in and returned by the caller. Given
``cache_index``, it is a preallocated fixed-size buffer that the new keys
and values are written into in place (a decode tick writes one position of
a multi-gigabyte cache; the JAX layer returns an updated copy instead). A
``QuantizedKV`` cache is quantized at write time and read through the int8
decode kernel (``ops/quantized_attention.py``, kernel #10) when its
predicate holds, else dequantized.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.ops.attention import scaled_dot_product_attention
from multimodal_tpu_torch.ops.fused_encoder import (
    fused_attention_supported,
    fused_qkv_attention,
    key_padding_bias,
)
from multimodal_tpu_torch.ops.kv_cache import QuantizedKV, quantize_kv
from multimodal_tpu_torch.ops.quantized_attention import (
    quantized_cache_attention,
    supports_quantized_attention,
)
from multimodal_tpu_torch.ops.rotary import apply_rotary


class MHAWithCacheOutput(NamedTuple):
    attn_output: torch.Tensor
    past_key_value: Tuple


def _mask_or_bias(attn_mask: Optional[torch.Tensor]):
    """Split a user mask into (bool mask, float bias) like torch SDPA."""
    if attn_mask is None:
        return None, None
    if attn_mask.dtype == torch.bool:
        return attn_mask, None
    return None, attn_mask


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _position_writer(idx: torch.Tensor, rows: int, s_new: int, length: int):
    """A function that writes ``new`` (rows, h, s_new, ...) into a cache
    (rows, h, length, ...) in place at ``idx``: a scalar start for every
    row, a ``(rows,)`` start per row, or ``(rows, s_new)`` per-position
    targets. Starts clamp so the block fits, as ``dynamic_update_slice``
    clamps. The index tensors are built once for all the caches of a layer."""
    steps = torch.arange(s_new, device=idx.device)
    if idx.dim() == 0:
        pos = idx.clamp(0, length - s_new) + steps
        return lambda cache, new: cache.index_copy_(2, pos, new)
    pos = idx.clamp(0, length - s_new)[:, None] + steps[None, :] if idx.dim() == 1 else idx
    row_ids = torch.arange(rows, device=idx.device)[:, None]

    def write(cache: torch.Tensor, new: torch.Tensor) -> None:
        cache[row_ids, :, pos] = new.transpose(1, 2)

    return write


def _write_fixed_cache(past_key_value, k_new: torch.Tensor, v_new: torch.Tensor,
                       cache_index) -> Tuple:
    """Write ``(b, h, s_new, d)`` keys/values into the preallocated
    ``(b, h, max_len, d)`` buffers at ``cache_index`` (scalar, ``(b,)`` or
    ``(b, s_new)``; see :func:`_position_writer`), in place. An int8 cache
    quantizes keys and values in one pass. Returns the same buffers."""
    cache_k, cache_v = past_key_value
    idx = torch.as_tensor(cache_index, device=k_new.device).long()
    length = cache_k.shape[2]
    write = _position_writer(idx, k_new.shape[0], k_new.shape[2], length)
    if isinstance(cache_k, QuantizedKV):
        q, scale = quantize_kv(torch.stack((k_new, v_new)))
        for cache, i in ((cache_k, 0), (cache_v, 1)):
            write(cache.q, q[i])
            write(cache.scale, scale[i])
    else:
        write(cache_k, k_new.to(cache_k.dtype))
        write(cache_v, v_new.to(cache_v.dtype))
    return cache_k, cache_v


def dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``lin`` on ``x`` in the compute dtype ``dt``, its weights cast at use."""
    return F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a single fused QKV projection (``input_proj``,
    laid out ``[q | k | v]``) and ``output_proj``. Weights are cast at use to
    the compute dtype, the dtype of ``query``. Context parallelism is not
    ported (ROADMAP.md, queue A4)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 cp_axis_name: Optional[str] = None):
        super().__init__()
        if cp_axis_name is not None:
            raise NotImplementedError(
                "context-parallel attention is not ported yet (ROADMAP.md, queue A4)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.input_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        query: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        is_causal: bool = False,
        return_attn_weights: bool = False,
        deterministic: bool = True,
    ):
        """``attn_mask``: boolean (True = attend) or additive float,
        broadcastable to ``(b, h, s, s)``. Returns the output, and with
        ``return_attn_weights`` also the fp32 ``(b, h, s, s)`` softmax
        probabilities."""
        dt = query.dtype
        qkv = dense(self.input_proj, query, dt)
        rate = self.dropout if not deterministic else 0.0
        if (not return_attn_weights and rate == 0.0 and query.dim() == 3
                and fused_attention_supported(query.shape[1], self.embed_dim, self.num_heads)):
            key_bias = None
            if attn_mask is not None:
                key_bias = key_padding_bias(attn_mask, query.shape[0], query.shape[1])
            if attn_mask is None or key_bias is not None:
                attn = fused_qkv_attention(qkv, self.num_heads, is_causal, None, key_bias)
                return dense(self.output_proj, attn, dt)

        q, k, v = (_split_heads(t, self.num_heads) for t in qkv.chunk(3, dim=-1))
        mask, bias = _mask_or_bias(attn_mask)
        attn = scaled_dot_product_attention(q, k, v, mask=mask, bias=bias, is_causal=is_causal,
                                            dropout_rate=rate, return_probs=return_attn_weights)
        if return_attn_weights:
            attn, probs = attn
            return dense(self.output_proj, _merge_heads(attn), dt), probs
        return dense(self.output_proj, _merge_heads(attn), dt)


class MultiHeadAttentionWithCache(nn.Module):
    """Self- or cross-attention with separate q/k/v projections and KV cache.

    ``dim_kv`` may differ from ``dim_q`` (cross-attention). With
    ``past_key_value`` alone, new keys/values are concatenated along the
    sequence axis; with ``cache_index`` too, ``past_key_value`` is a
    fixed-size buffer written in place at that index. ``num_kv_heads``
    (grouped-query attention) projects and caches only that many kv heads.
    Weights are cast at use to the compute dtype, the dtype of ``query``.
    """

    def __init__(self, dim_q: int, dim_kv: int, num_heads: int, dropout: float = 0.0,
                 add_bias: bool = True, num_kv_heads: Optional[int] = None,
                 cp_axis_name: Optional[str] = None):
        super().__init__()
        if cp_axis_name is not None:
            raise NotImplementedError(
                "context-parallel attention is not ported yet (ROADMAP.md, queue A4/A7)")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {kv_heads}")
        self.num_heads = num_heads
        self.num_kv_heads = kv_heads
        self.dropout = dropout
        head_dim = dim_q // num_heads
        self.q_proj = nn.Linear(dim_q, dim_q, bias=add_bias)
        self.k_proj = nn.Linear(dim_kv, kv_heads * head_dim, bias=add_bias)
        self.v_proj = nn.Linear(dim_kv, kv_heads * head_dim, bias=add_bias)
        self.output_proj = nn.Linear(dim_q, dim_q, bias=add_bias)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        past_key_value: Optional[Tuple] = None,
        is_causal: bool = False,
        use_cache: bool = False,
        deterministic: bool = True,
        cache_index=None,
        rope_positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        """``segment_ids`` ((b, s) integers): packed-sequence self-attention,
        positions attend only within their segment (composed with
        ``is_causal``: block-diagonal causal); a training-shape feature, so
        refused with a cache."""
        if segment_ids is not None and (
                past_key_value is not None or use_cache or cache_index is not None):
            raise ValueError("segment_ids are a training-shape feature (no KV cache)")
        dt = query.dtype
        kv_heads = self.num_kv_heads
        q = _split_heads(dense(self.q_proj, query, dt), self.num_heads)
        k = _split_heads(dense(self.k_proj, key, dt), kv_heads)
        v = _split_heads(dense(self.v_proj, value, dt), kv_heads)
        if rope_positions is not None:
            # q and the NEW k rows by their own positions; cached rows were
            # rotated when they were written
            q = apply_rotary(q, rope_positions)
            k = apply_rotary(k, rope_positions)
        rate = self.dropout if not deterministic else 0.0

        cache_out = None
        quantized_attn = None
        if past_key_value is not None:
            if cache_index is not None:
                ck, cv = _write_fixed_cache(past_key_value, k, v, cache_index)
                cache_out = (ck, cv)
                if isinstance(ck, QuantizedKV):
                    if supports_quantized_attention(q, attn_mask, rate, is_causal,
                                                    kv_heads=kv_heads):
                        quantized_attn = quantized_cache_attention(q, ck, cv, attn_mask)
                    else:
                        k = ck.dequantize(k.dtype)
                        v = cv.dequantize(v.dtype)
                else:
                    k, v = ck, cv
            else:
                k = torch.cat([past_key_value[0], k], dim=2)
                v = torch.cat([past_key_value[1], v], dim=2)
        if quantized_attn is not None:
            out = dense(self.output_proj, _merge_heads(quantized_attn), dt)
            return MHAWithCacheOutput(out, cache_out) if use_cache else out

        kv_present = (k, v)  # before the GQA broadcast: what a fresh cache stores
        if kv_heads != self.num_heads:
            group = self.num_heads // kv_heads
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        mask, bias = _mask_or_bias(attn_mask)
        attn = scaled_dot_product_attention(q, k, v, mask=mask, bias=bias, is_causal=is_causal,
                                            dropout_rate=rate, segment_ids=segment_ids)
        out = dense(self.output_proj, _merge_heads(attn), dt)
        if use_cache:
            return MHAWithCacheOutput(out, cache_out if cache_out is not None else kv_present)
        return out
