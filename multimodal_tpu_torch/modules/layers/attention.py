"""Generalized n-dimensional attention (video and image latents).
Counterpart of ``multimodal_tpu/modules/layers/attention.py``.

Inputs are channel-last ``(b, d1, ..., dn, dim)``; the latent axes are
flattened to one sequence (``SelfAttention``) or attended one axis at a
time (``AxialAttention``). The attention is the explicit-softmax one of the
JAX module (``scaled_dot_product_attention``): fp32 scores, a boolean mask
filled with -1e30, fp32 softmax, a multiplicative ``head_mask`` on the
probabilities. The JAX package runs it without a Pallas kernel, so it stays
plain here. ``MultiHeadAttention``'s cache is an explicit ``(k, v)`` pair:
concatenated onto, or, given ``cache_index``, a preallocated buffer written
in place (``multi_head_attention.py:_write_fixed_cache``, the path the
serving engine drives). An int8 cache is dequantized before the attention,
as the JAX layer does; the cache itself stays int8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.multi_head_attention import _write_fixed_cache, dense
from multimodal_tpu_torch.ops.kv_cache import is_quantized_kv


def split_multihead(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, seq, dim) -> (b, heads, seq, dim // heads)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_multihead(x: torch.Tensor) -> torch.Tensor:
    """(b, heads, seq, head_dim) -> (b, seq, dim)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit-softmax attention returning (output, fp32 probabilities):
    a boolean ``attention_mask`` (True = attend) and a multiplicative
    ``head_mask`` on the probabilities."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if attention_mask is not None:
        attn = attn.masked_fill(~attention_mask, -1e30)
    probs = torch.softmax(attn, dim=-1)
    if head_mask is not None:
        probs = probs * head_mask
    return torch.matmul(probs.to(v.dtype), v), probs


class SelfAttention(nn.Module):
    """Attention over the flattened latent axes of ``(b, heads, d1..dn,
    head_dim)``; dropout (training only) on the output, as in JAX."""

    def __init__(self, attn_dropout: float = 0.0):
        super().__init__()
        self.attn_dropout = attn_dropout

    def forward(self, q, k, v, attention_mask=None, head_mask=None,
                deterministic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = q.shape
        b, h, d = shape[0], shape[1], shape[-1]
        out, probs = scaled_dot_product_attention(
            q.reshape(b, h, -1, d), k.reshape(b, h, -1, d), v.reshape(b, h, -1, v.shape[-1]),
            attention_mask, head_mask)
        if self.attn_dropout > 0 and not deterministic:
            out = F.dropout(out, self.attn_dropout, training=True)
        return out.reshape(shape[:-1] + (v.shape[-1],)), probs


class AxialAttention(nn.Module):
    """Attention along one latent axis, the others folded into the batch."""

    def __init__(self, axial_dim: int):
        super().__init__()
        self.axial_dim = axial_dim

    def forward(self, q, k, v, attention_mask=None, head_mask=None,
                deterministic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        axial = self.axial_dim + 2  # past (b, h)
        q, k, v = (t.movedim(axial, -2) for t in (q, k, v))
        pre_shape = q.shape
        out, probs = scaled_dot_product_attention(
            q.reshape(-1, q.shape[-2], q.shape[-1]), k.reshape(-1, k.shape[-2], k.shape[-1]),
            v.reshape(-1, v.shape[-2], v.shape[-1]), attention_mask, head_mask)
        out = out.reshape(pre_shape[:-1] + (v.shape[-1],))
        return out.movedim(-2, axial), probs


class MultiHeadAttention(nn.Module):
    """n-dim multi-head attention with separate ``query`` / ``key`` /
    ``value`` projections (biases as ``add_bias`` says), a pluggable
    attention module (full or axial) and an ``output`` projection that
    always has a bias. ``dtype`` is the compute dtype of the projections
    (the input's when None); weights are cast at use."""

    def __init__(self, dim_q: int, dim_kv: int, n_head: int,
                 attn_module: Optional[nn.Module] = None, add_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim_q % n_head or dim_kv % n_head:
            raise ValueError("dims must be divisible by n_head")
        self.dim_q = dim_q
        self.n_head = n_head
        self.dtype = dtype
        self.query = nn.Linear(dim_q, dim_q, bias=add_bias)
        self.key = nn.Linear(dim_kv, dim_q, bias=add_bias)
        self.value = nn.Linear(dim_kv, dim_q, bias=add_bias)
        self.output = nn.Linear(dim_q, dim_q, bias=True)
        self.attn = attn_module if attn_module is not None else SelfAttention()

    def forward(
        self,
        q: torch.Tensor,
        kv: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        head_mask: Optional[torch.Tensor] = None,
        return_attn_weights: bool = False,
        past_key_value: Optional[Tuple] = None,
        use_cache: bool = False,
        cache_index=None,
        deterministic: bool = True,
    ):
        """With ``cache_index`` and ``past_key_value``, the cache is a
        preallocated buffer written in place at the index (a scalar, per
        row ``(b,)`` or per position ``(b, s)``); without it the new keys
        and values are concatenated onto the cache. Returns the output, and
        as asked the present ``(k, v)`` and the probabilities."""
        kv = q if kv is None else kv
        dt = self.dtype or q.dtype
        latent_shape = q.shape[1:-1]

        def heads(x):
            return split_multihead(x.reshape(x.shape[0], -1, x.shape[-1]), self.n_head)

        q_p = heads(dense(self.query, q, dt))
        k_p = heads(dense(self.key, kv, dt))
        v_p = heads(dense(self.value, kv, dt))
        if past_key_value is not None:
            if cache_index is not None:
                k_p, v_p = _write_fixed_cache(past_key_value, k_p, v_p, cache_index)
            else:
                k_p = torch.cat([past_key_value[0], k_p], dim=2)
                v_p = torch.cat([past_key_value[1], v_p], dim=2)
        present = (k_p, v_p)
        if is_quantized_kv(k_p):
            k_p, v_p = k_p.dequantize(q_p.dtype), v_p.dequantize(q_p.dtype)

        if isinstance(self.attn, AxialAttention):
            b, hd = q.shape[0], self.dim_q // self.n_head
            nd = lambda x: x.reshape((b, self.n_head) + tuple(latent_shape) + (hd,))  # noqa: E731
            a, probs = self.attn(nd(q_p), nd(k_p), nd(v_p), attention_mask, head_mask,
                                 deterministic=deterministic)
            a = a.reshape(b, self.n_head, -1, hd)
        else:
            a, probs = self.attn(q_p, k_p, v_p, attention_mask, head_mask,
                                 deterministic=deterministic)
        out = merge_multihead(a)
        out = dense(self.output, out.reshape((out.shape[0],) + tuple(latent_shape)
                                             + (out.shape[-1],)), dt)
        if use_cache and return_attn_weights:
            return out, present, probs
        if use_cache:
            return out, present
        if return_attn_weights:
            return out, probs
        return out
