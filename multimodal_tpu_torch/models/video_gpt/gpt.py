"""Multimodal GPT (VideoGPT-style cross-modality generation). Counterpart
of ``multimodal_tpu/models/video_gpt/gpt.py``.

Pre-LN decoder layers over the n-dim attention of
``modules/layers/attention.py``, the LayerNorms in fp32, and the MLP of
``modules/layers/mlp.py`` at dropout 0, so every layer's feed-forward takes
the fused MLP kernel (``ops/fused_encoder.py:fused_mlp``, kernel #3) where
its widths suit it, at a prefill and at every decode tick. KV caches are
explicit per-layer ``(k, v)`` pairs threaded by the caller, written in
place at ``cache_index`` (``utils/generate.py``, ``serving/``).

Numerics follow the JAX modules: parameters are fp32 and ``dtype`` is the
compute dtype each projection and the MLP cast to; the residual stream
keeps the dtype of the embeddings that start it (fp32 for the text
tokenizer's table, the compute dtype after a projection), and the logits
are fp32, masked with ``finfo(float32).min``. Module and parameter names
are the JAX modules' (``utils/checkpoint.py:video_gpt_state_dict_from_jax``
maps by path).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.attention import MultiHeadAttention, SelfAttention
from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class TransformerDecoderOutput(NamedTuple):
    last_hidden_states: torch.Tensor
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    attention_weights: Optional[Tuple[torch.Tensor, ...]] = None
    past_key_values: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]] = None


class TransformerLayerOutput(NamedTuple):
    hidden_states: torch.Tensor
    attention_weights: Optional[torch.Tensor] = None
    past_key_values: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class MultimodalGPTOutput(NamedTuple):
    decoder_output: TransformerDecoderOutput
    logits: torch.Tensor


class RightShift(nn.Module):
    """Shift right along the sequence and put the learned start-of-sequence
    vector ``sos`` first."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.sos = nn.Parameter(torch.randn(embedding_dim) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sos = self.sos.to(x.dtype)[None, None, :].expand(x.shape[0], 1, self.embedding_dim)
        return torch.cat([sos, x[:, :-1]], dim=1)


def _dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    return F.dropout(x, rate, training=True) if rate > 0 and not deterministic else x


class TransformerDecoderLayer(nn.Module):
    """Pre-LN GPT block over n-dim attention."""

    def __init__(self, d_model: int = 768, n_head: int = 12, dropout: float = 0.1,
                 attn_dropout: float = 0.1, activation: Union[str, Callable] = "quick_gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.norm_attn = Fp32LayerNorm(d_model, eps=1e-5)
        self.attention = MultiHeadAttention(d_model, d_model, n_head,
                                            attn_module=SelfAttention(attn_dropout),
                                            add_bias=False, dtype=dtype)
        self.norm_mlp = Fp32LayerNorm(d_model, eps=1e-5)
        self.mlp = MLP(d_model, d_model, [d_model * 4], dropout=0.0, activation=activation)

    def forward(self, x, attn_mask=None, head_mask=None, use_cache: bool = False,
                causal: bool = False, return_attn_weights: bool = False, past_key_value=None,
                cache_index=None, deterministic: bool = True) -> TransformerLayerOutput:
        attn_out = self.attention(
            self.norm_attn(x), attention_mask=attn_mask, head_mask=head_mask,
            return_attn_weights=return_attn_weights, past_key_value=past_key_value,
            use_cache=use_cache, cache_index=cache_index, deterministic=deterministic)
        present = probs = None
        if use_cache and return_attn_weights:
            attn_h, present, probs = attn_out
        elif use_cache:
            attn_h, present = attn_out
        elif return_attn_weights:
            attn_h, probs = attn_out
        else:
            attn_h = attn_out
        x = x + _dropout(attn_h, self.dropout, deterministic)
        mlp_out = self.mlp(self.norm_mlp(x).to(self.dtype), deterministic=deterministic)
        x = x + _dropout(mlp_out, self.dropout, deterministic)
        return TransformerLayerOutput(x, probs, present)


class TransformerDecoder(nn.Module):
    """A stack of GPT layers (``layers``, JAX's ``layer_<i>``) threading
    per-layer caches."""

    def __init__(self, num_layers: int = 12, d_model: int = 768, n_head: int = 12,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 activation: Union[str, Callable] = "quick_gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        self.n_head = n_head
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, n_head, dropout, attn_dropout, activation, dtype=dtype)
            for _ in range(num_layers))

    def forward(self, hidden_states, attn_mask=None, head_mask=None, use_cache: bool = False,
                causal: bool = False, return_attn_weights: bool = False,
                return_hidden_states: bool = False, past_key_values=None, cache_index=None,
                deterministic: bool = True) -> TransformerDecoderOutput:
        """``attn_mask``: boolean (True = attend) or 0/1, ``(q, k)``,
        ``(b, q, k)`` or ``(b, h, q, k)``. ``causal`` without a mask or a
        ``cache_index`` adds the lower-triangular mask."""
        if attn_mask is not None and attn_mask.dim() == 2:
            attn_mask = attn_mask[None, None]
        if attn_mask is not None and attn_mask.dim() == 3:
            attn_mask = attn_mask[:, None]
        if attn_mask is not None and attn_mask.dtype != torch.bool:
            attn_mask = attn_mask.bool()
        if causal and attn_mask is None and cache_index is None:
            s = hidden_states.shape[1]
            attn_mask = torch.ones(s, s, dtype=torch.bool,
                                   device=hidden_states.device).tril()[None, None]
        if head_mask is not None and head_mask.dim() == 3:
            head_mask = head_mask[None]
        all_hidden, all_attn, all_kv = [], [], []
        for i in range(self.num_layers):
            if return_hidden_states:
                all_hidden.append(hidden_states)
            pkv = past_key_values[i] if past_key_values is not None else None
            out = self.layers[i](
                hidden_states, attn_mask, head_mask, use_cache, causal, return_attn_weights,
                pkv, cache_index, deterministic)
            hidden_states = out.hidden_states
            if return_attn_weights:
                all_attn.append(out.attention_weights)
            if use_cache:
                all_kv.append(out.past_key_values)
        if return_hidden_states:
            all_hidden.append(hidden_states)
        return TransformerDecoderOutput(
            hidden_states,
            tuple(all_hidden) if return_hidden_states else None,
            tuple(all_attn) if return_attn_weights else None,
            tuple(all_kv) if use_cache else None)


class MultimodalTransformerDecoder(nn.Module):
    """Per-modality position embeddings, the start-of-sequence right shift
    and the GPT stack."""

    def __init__(self, in_pos_emb: nn.Module, out_pos_emb: nn.Module, decoder: nn.Module,
                 right_shift: nn.Module):
        super().__init__()
        self.in_pos_emb = in_pos_emb
        self.out_pos_emb = out_pos_emb
        self.decoder = decoder
        self.right_shift = right_shift

    def forward(self, in_modality=None, out_modality=None, in_pos_ids=None, out_pos_ids=None,
                attn_mask=None, head_mask=None, use_cache: bool = False, causal: bool = False,
                right_shift: bool = False, return_attn_weights: bool = False,
                return_hidden_states: bool = False, past_key_values=None, cache_index=None,
                deterministic: bool = True) -> TransformerDecoderOutput:
        if in_modality is None and out_modality is None:
            raise ValueError("in_modality and out_modality sequences cannot be both empty")

        def embed(x, pos_ids, table):
            if pos_ids is None:
                pos_ids = torch.arange(x.shape[1], device=x.device)[None]
            if pos_ids.shape[1] != x.shape[1]:
                raise ValueError(f"Input sequence and position ids must be equal in length: "
                                 f"{pos_ids.shape[1]} != {x.shape[1]}")
            return x + table(pos_ids).to(x.dtype)

        parts = []
        if in_modality is not None:
            parts.append(embed(in_modality, in_pos_ids, self.in_pos_emb))
        if out_modality is not None:
            parts.append(embed(out_modality, out_pos_ids, self.out_pos_emb))
        x = parts[0] if len(parts) == 1 else torch.cat(
            [p.to(torch.promote_types(parts[0].dtype, parts[1].dtype)) for p in parts], dim=1)
        if not deterministic or right_shift:
            x = self.right_shift(x)
        return self.decoder(x, attn_mask, head_mask, use_cache, causal, return_attn_weights,
                            return_hidden_states, past_key_values=past_key_values,
                            cache_index=cache_index, deterministic=deterministic)


class MultimodalGPT(nn.Module):
    """Cross-modality GPT over an input and an output tokenizer: the input
    tokenizer has ``encode`` and ``lookup``, the output one ``decode`` too;
    each has ``embedding_dim``, the width of its lookups."""

    def __init__(self, d_model: int, num_in_tokens: int, num_out_tokens: int,
                 latent_shape: Tuple[int, ...], in_tokenizer: nn.Module,
                 out_tokenizer: nn.Module, mm_decoder: MultimodalTransformerDecoder,
                 use_in_projection: bool = True, use_out_projection: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for attr in ("encode", "lookup"):
            if not hasattr(in_tokenizer, attr):
                raise AttributeError(
                    "Input modality tokenizer must have methods 'encode' and 'lookup'.")
        for attr in ("encode", "lookup", "decode"):
            if not hasattr(out_tokenizer, attr):
                raise AttributeError("Output modality tokenizer must have methods 'encode', "
                                     "'lookup' and 'decode'.")
        self.d_model = d_model
        self.num_in_tokens = num_in_tokens
        self.num_out_tokens = num_out_tokens
        self.latent_shape = tuple(latent_shape)
        self.use_in_projection = use_in_projection
        self.use_out_projection = use_out_projection
        self.dtype = dtype
        self.in_tokenizer = in_tokenizer
        self.out_tokenizer = out_tokenizer
        self.mm_decoder = mm_decoder
        self.norm = Fp32LayerNorm(d_model, eps=1e-5)
        self.to_logit = nn.Linear(d_model, num_in_tokens + num_out_tokens, bias=False)
        nn.init.zeros_(self.to_logit.weight)  # equal probabilities at first
        if use_in_projection:
            self.in_projection = nn.Linear(in_tokenizer.embedding_dim, d_model, bias=False)
        if use_out_projection:
            self.out_projection = nn.Linear(out_tokenizer.embedding_dim, d_model, bias=False)

    def forward(self, in_tokens=None, out_tokens=None, in_pos_ids=None, out_pos_ids=None,
                attn_mask=None, head_mask=None, logits_mask=None, use_cache: bool = False,
                causal: bool = False, right_shift: bool = False,
                return_attn_weights: bool = False, return_hidden_states: bool = False,
                past_key_values=None, cache_index=None,
                deterministic: bool = True) -> MultimodalGPTOutput:
        decoder_output = self.fwd(
            in_tokens=in_tokens, out_tokens=out_tokens, in_pos_ids=in_pos_ids,
            out_pos_ids=out_pos_ids, attn_mask=attn_mask, head_mask=head_mask,
            use_cache=use_cache, causal=causal, right_shift=right_shift,
            return_attn_weights=return_attn_weights, return_hidden_states=return_hidden_states,
            past_key_values=past_key_values, cache_index=cache_index,
            deterministic=deterministic)
        logits = self.logit_projection(decoder_output.last_hidden_states, logits_mask)
        return MultimodalGPTOutput(decoder_output, logits)

    def init_weights(self, video_in, video_out, in_tokens, out_tokens) -> MultimodalGPTOutput:
        """Runs every submodule once (both tokenizers' encoders, the output
        decoder, the right shift and the stack), as the JAX helper that
        materializes the parameters does."""
        self.encode(video_in, "in")
        self.encode(video_out, "out")
        self.decode(torch.zeros((video_out.shape[0], math.prod(self.latent_shape)),
                                dtype=torch.long, device=self.to_logit.weight.device))
        return self(in_tokens=in_tokens, out_tokens=out_tokens, causal=True, right_shift=True)

    def _project(self, tokens: torch.Tensor, modality: str) -> torch.Tensor:
        x = self.lookup(tokens, modality)
        use = self.use_in_projection if modality == "in" else self.use_out_projection
        if use:
            x = dense(getattr(self, f"{modality}_projection"), x, self.dtype)
        return x

    def fwd(self, in_tokens=None, out_tokens=None, **kwargs: Any) -> TransformerDecoderOutput:
        if in_tokens is None and out_tokens is None:
            raise ValueError("input-modality token and output-modality token sequences cannot "
                             "be both empty")
        return self.mm_decoder(
            in_modality=None if in_tokens is None else self._project(in_tokens, "in"),
            out_modality=None if out_tokens is None else self._project(out_tokens, "out"),
            **kwargs)

    def logit_projection(self, hidden_states: torch.Tensor,
                         logits_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if logits_mask is not None and logits_mask.dim() == 2:
            logits_mask = logits_mask[None]
        h = self.norm(hidden_states)
        logits = dense(self.to_logit, h, self.dtype).float()
        if logits_mask is not None:
            logits = logits.masked_fill(logits_mask == 0, torch.finfo(torch.float32).min)
        return logits

    def encode(self, x: Any, modality: str, **kwargs: Any) -> torch.Tensor:
        if modality == "in":
            encoder = self.in_tokenizer.encode
        elif modality == "out":
            encoder = self.out_tokenizer.encode
        else:
            raise ValueError(f"Invalid modality parameter: {modality}")
        token_ids = encoder(x, **kwargs)
        return token_ids.reshape(token_ids.shape[0], -1)

    def decode(self, token_ids: torch.Tensor, **kwargs: Any) -> Any:
        if token_ids.dim() != 2:
            raise ValueError(f"Shape of token ids should be (batch, seq_len) but got "
                             f"{tuple(token_ids.shape)}")
        latent_seq_len = math.prod(self.latent_shape)
        if token_ids.shape[1] != latent_seq_len:
            raise ValueError(f"Sequence to decode does not match that inferred from the "
                             f"tokenizer: {latent_seq_len}")
        token_ids = token_ids.reshape((token_ids.shape[0],) + self.latent_shape)
        return self.out_tokenizer.decode(token_ids, **kwargs)

    def lookup(self, token_ids: torch.Tensor, modality: str) -> torch.Tensor:
        if modality == "in":
            return self.in_tokenizer.lookup(token_ids)
        if modality == "out":
            return self.out_tokenizer.lookup(token_ids)
        raise ValueError(f"Invalid modality parameter: {modality}")
