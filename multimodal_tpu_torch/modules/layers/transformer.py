"""Transformer encoder and decoder. Counterpart of
``multimodal_tpu/modules/layers/transformer.py``, in the loop layout (the
JAX package's ``scan_layers`` stacking is not carried over).

Encoder (``TransformerEncoderLayer``, ``TransformerEncoder``): fused-QKV
self-attention and the MLP, pre- or post-norm, stochastic depth or residual
dropout, per-layer hidden-state and attention-probability taps, an optional
final LayerNorm. Decoder (``TransformerDecoderLayer``,
``TransformerDecoder``): causal self-attention with a per-layer KV cache,
optional cross-attention, the MLP, pre- or post-norm, and an optional final
LayerNorm; ``segment_ids`` (packed sequences) reach every layer's
self-attention. ``remat=True`` recomputes each layer in the backward from
its input alone (``torch.utils.checkpoint``, the counterpart of
``nn.remat(policy=nothing_saveable)``). MoE layers and context parallelism
are refused (ROADMAP.md, queue A4).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import (
    MultiHeadAttentionWithCache,
    MultiHeadSelfAttention,
)
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class TransformerOutput(NamedTuple):
    last_hidden_state: Optional[torch.Tensor] = None
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    attentions: Optional[Tuple[torch.Tensor, ...]] = None
    image_labels: Optional[torch.Tensor] = None
    current_key_values: Optional[Tuple] = None


def _refuse(moe_num_experts: Optional[int], cp_axis_name: Optional[str]) -> None:
    for flag, what in ((moe_num_experts, "MoE layers"), (cp_axis_name, "context parallelism")):
        if flag:
            raise NotImplementedError(
                f"{what} in the transformer is not ported yet (ROADMAP.md, queue A4)")


class StochasticDepth(nn.Module):
    """Row-mode stochastic depth (drop-path): each sample's residual branch
    is dropped with probability ``rate`` and kept ones scaled by
    ``1 / (1 - rate)``, as torchvision's."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class TransformerEncoderLayer(nn.Module):
    """Pre- or post-norm encoder block: fused-QKV self-attention and the MLP
    with residuals. With ``drop_path_rate`` the residual branches take
    stochastic depth, otherwise dropout at ``dropout``."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        dim_feedforward: int,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "relu",
        layer_norm_eps: float = 1e-12,
        norm_first: bool = False,
        drop_path_rate: Optional[float] = None,
        cp_axis_name: Optional[str] = None,
        moe_num_experts: Optional[int] = None,
    ):
        super().__init__()
        _refuse(moe_num_experts, cp_axis_name)
        self.norm_first = norm_first
        self.dropout = dropout
        self.attention = MultiHeadSelfAttention(d_model, n_head, dropout=dropout)
        self.feedforward = MLP(d_model, d_model, dim_feedforward, dropout=dropout,
                               activation=activation)
        self.attention_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        self.feedforward_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        self.drop_path = StochasticDepth(drop_path_rate) if drop_path_rate is not None else None

    def _residual_drop(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        if self.drop_path is not None:
            return self.drop_path(x, deterministic)
        return F.dropout(x, self.dropout, training=not deterministic and self.dropout > 0)

    def forward(self, hidden_states: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, return_attn_weights: bool = False):
        """Returns the block's output, and with ``return_attn_weights`` also
        its attention probabilities."""
        x = hidden_states
        probs = None
        if self.norm_first:
            attn = self.attention(self.attention_layernorm(x), attn_mask=attention_mask,
                                  return_attn_weights=return_attn_weights,
                                  deterministic=deterministic)
            if return_attn_weights:
                attn, probs = attn
            x = x + self._residual_drop(attn, deterministic)
            ff = self.feedforward(self.feedforward_layernorm(x), deterministic)
            out = x + self._residual_drop(ff, deterministic)
        else:
            attn = self.attention(x, attn_mask=attention_mask,
                                  return_attn_weights=return_attn_weights,
                                  deterministic=deterministic)
            if return_attn_weights:
                attn, probs = attn
            x = self.attention_layernorm(x + self._residual_drop(attn, deterministic))
            ff = self.feedforward(x, deterministic)
            out = self.feedforward_layernorm(x + self._residual_drop(ff, deterministic))
        return (out, probs) if return_attn_weights else out


class TransformerEncoder(nn.Module):
    """Stack of encoder layers with an optional final LayerNorm and a linear
    drop-path schedule (0 at the first layer to ``drop_path_rate`` at the
    last)."""

    def __init__(
        self,
        n_layer: int,
        d_model: int,
        n_head: int,
        dim_feedforward: int,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "relu",
        layer_norm_eps: float = 1e-12,
        norm_first: bool = False,
        final_layer_norm_eps: Optional[float] = None,
        drop_path_rate: Optional[float] = None,
        remat: bool = False,
        cp_axis_name: Optional[str] = None,
        moe_num_experts: Optional[int] = None,
    ):
        super().__init__()
        _refuse(moe_num_experts, cp_axis_name)
        self.remat = remat
        if drop_path_rate is not None:
            rates = torch.linspace(0.0, drop_path_rate, n_layer).tolist()
        else:
            rates = [None] * n_layer
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_head, dim_feedforward, dropout, activation,
                                    layer_norm_eps, norm_first, rates[i])
            for i in range(n_layer)
        )
        self.final_layer_norm = (Fp32LayerNorm(d_model, eps=final_layer_norm_eps)
                                 if final_layer_norm_eps is not None else None)

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
        return_attn_weights: bool = False,
        deterministic: bool = True,
    ) -> TransformerOutput:
        all_hidden_states: List[torch.Tensor] = []
        all_attentions: List[torch.Tensor] = []
        for layer in self.layers:
            if return_hidden_states:
                all_hidden_states.append(hidden_states)
            args = (hidden_states, attention_mask, deterministic, return_attn_weights)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(layer, *args, use_reentrant=False)
            else:
                out = layer(*args)
            if return_attn_weights:
                hidden_states, probs = out
                all_attentions.append(probs)
            else:
                hidden_states = out
        if return_hidden_states:
            all_hidden_states.append(hidden_states)
        if self.final_layer_norm is not None:
            hidden_states = self.final_layer_norm(hidden_states)
        return TransformerOutput(
            last_hidden_state=hidden_states,
            hidden_states=tuple(all_hidden_states) if return_hidden_states else None,
            attentions=tuple(all_attentions) if return_attn_weights else None,
        )


class TransformerDecoderLayer(nn.Module):
    """Decoder block: causal self-attention (+KV cache), optional
    cross-attention, MLP."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        dim_feedforward: int,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "relu",
        layer_norm_eps: float = 1e-12,
        norm_first: bool = False,
        use_cross_attention: bool = True,
        dim_kv: Optional[int] = None,
        n_kv_head: Optional[int] = None,
        moe_num_experts: Optional[int] = None,
        cp_axis_name: Optional[str] = None,
    ):
        super().__init__()
        _refuse(moe_num_experts, cp_axis_name)
        self.norm_first = norm_first
        self.use_cross_attention = use_cross_attention
        self.dropout = dropout
        self.attention = MultiHeadAttentionWithCache(
            d_model, d_model, n_head, dropout=dropout, num_kv_heads=n_kv_head)
        self.attention_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        if use_cross_attention:
            self.cross_attention = MultiHeadAttentionWithCache(
                d_model, dim_kv if dim_kv is not None else d_model, n_head, dropout=dropout)
            self.cross_attention_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        self.feedforward = MLP(d_model, d_model, dim_feedforward, dropout=dropout,
                               activation=activation)
        self.feedforward_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        cross_attention_mask: Optional[torch.Tensor] = None,
        past_key_value: Optional[Tuple] = None,
        use_cache: bool = False,
        is_causal: bool = False,
        deterministic: bool = True,
        cache_index=None,
        rope_positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        def drop(t):
            return F.dropout(t, self.dropout, training=not deterministic and self.dropout > 0)

        def self_attn(inp):
            out = self.attention(inp, inp, inp, attn_mask=attention_mask,
                                 past_key_value=past_key_value, is_causal=is_causal,
                                 use_cache=use_cache, deterministic=deterministic,
                                 cache_index=cache_index, rope_positions=rope_positions,
                                 segment_ids=segment_ids)
            return (out.attn_output, out.past_key_value) if use_cache else (out, None)

        def cross_attn(inp):
            return self.cross_attention(inp, encoder_hidden_states, encoder_hidden_states,
                                        attn_mask=cross_attention_mask,
                                        deterministic=deterministic)

        x = hidden_states
        if self.norm_first:
            attn_out, present_kv = self_attn(self.attention_layernorm(x))
            x = x + drop(attn_out)
            if self.use_cross_attention and encoder_hidden_states is not None:
                x = x + drop(cross_attn(self.cross_attention_layernorm(x)))
            x = x + drop(self.feedforward(self.feedforward_layernorm(x), deterministic))
        else:
            attn_out, present_kv = self_attn(x)
            x = self.attention_layernorm(x + drop(attn_out))
            if self.use_cross_attention:
                if encoder_hidden_states is None:
                    raise ValueError("encoder_hidden_states required for cross attention")
                x = self.cross_attention_layernorm(x + drop(cross_attn(x)))
            x = self.feedforward_layernorm(x + drop(self.feedforward(x, deterministic)))
        return x, present_kv


class TransformerDecoder(nn.Module):
    """Stack of decoder layers; cross-attention every
    ``cross_attention_interval`` layers; threads per-layer KV caches."""

    def __init__(
        self,
        n_layer: int,
        d_model: int,
        n_head: int,
        dim_feedforward: int,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "relu",
        layer_norm_eps: float = 1e-12,
        norm_first: bool = False,
        use_cross_attention: bool = True,
        dim_kv: Optional[int] = None,
        cross_attention_interval: int = 1,
        final_layer_norm_eps: Optional[float] = None,
        n_kv_head: Optional[int] = None,
        remat: bool = False,
        moe_num_experts: Optional[int] = None,
        cp_axis_name: Optional[str] = None,
    ):
        super().__init__()
        _refuse(moe_num_experts, cp_axis_name)
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
                d_model, n_head, dim_feedforward, dropout, activation, layer_norm_eps,
                norm_first, use_cross_attention and i % cross_attention_interval == 0, dim_kv,
                n_kv_head)
            for i in range(n_layer)
        )
        self.final_layer_norm = (Fp32LayerNorm(d_model, eps=final_layer_norm_eps)
                                 if final_layer_norm_eps is not None else None)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        cross_attention_mask: Optional[torch.Tensor] = None,
        past_key_values: Optional[Tuple] = None,
        use_cache: bool = False,
        is_causal: bool = False,
        return_hidden_states: bool = False,
        deterministic: bool = True,
        cache_index=None,
        rope_positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> TransformerOutput:
        all_hidden_states: List[torch.Tensor] = []
        current_key_values: List[Tuple] = []
        for i, layer in enumerate(self.layers):
            if return_hidden_states:
                all_hidden_states.append(hidden_states)
            pkv = past_key_values[i] if past_key_values is not None else None
            args = (hidden_states, encoder_hidden_states, attention_mask, cross_attention_mask,
                    pkv, use_cache, is_causal, deterministic, cache_index, rope_positions,
                    segment_ids)
            if self.remat and torch.is_grad_enabled():
                # only the layer's inputs are kept; its activations are
                # recomputed in the backward
                hidden_states, present_kv = checkpoint(layer, *args, use_reentrant=False)
            else:
                hidden_states, present_kv = layer(*args)
            if use_cache and present_kv is not None:
                current_key_values.append(present_kv)
        if return_hidden_states:
            all_hidden_states.append(hidden_states)
        if self.final_layer_norm is not None:
            hidden_states = self.final_layer_norm(hidden_states)
        return TransformerOutput(
            last_hidden_state=hidden_states,
            hidden_states=tuple(all_hidden_states) if return_hidden_states else None,
            current_key_values=tuple(current_key_values) if use_cache else None,
        )
