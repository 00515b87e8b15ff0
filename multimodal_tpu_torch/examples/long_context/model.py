"""Long-context causal LM. Counterpart of
``multimodal_tpu/examples/long_context/model.py`` (``LongContextLM``) on
one device: token embedding (+ learned positions, or rotary inside the
attention), a pre-norm ``TransformerDecoder`` with exact-GELU MLPs and a
final LayerNorm, and an untied LM head. ``remat=True`` recomputes each
layer in the backward; ``segment_ids=`` trains on packed documents
(``data/packing.py``: block-diagonal causal attention). Context parallelism
and MoE are refused (ROADMAP.md, queue A4).

Besides the plain causal forward it has the serving engine's decode
surface (``serving/engine.py``): ``positions=`` per-row position ids,
``past_key_values=`` fixed-size per-layer caches written in place at
``cache_index=``, an ``attention_mask=`` over the cache (then no causal
mask is added), and ``use_cache=True`` to return the per-layer keys and
values.

Numerics: with ``dtype=torch.bfloat16`` the embeddings are cast to bf16 and
every layer computes in it (LayerNorms in fp32); weights other than the
LayerNorms' are held in ``param_dtype`` and cast at use.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.clip.model import to_param_dtype
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.transformer import TransformerDecoder
from multimodal_tpu_torch.utils.device import resolve_device


class LongContextLM(nn.Module):
    """Decoder-only causal LM."""

    def __init__(
        self,
        vocab_size: int,
        max_seq_len: int,
        n_layer: int = 12,
        d_model: int = 768,
        n_head: int = 12,
        dim_feedforward: int = 3072,
        dropout: float = 0.0,
        n_kv_head: Optional[int] = None,
        positional: str = "learned",
        dtype: torch.dtype = torch.float32,
        cp_axis_name: Optional[str] = None,
        moe_num_experts: Optional[int] = None,
        remat: bool = False,
    ):
        super().__init__()
        if positional not in ("learned", "rope"):
            raise ValueError(f"unknown positional scheme {positional!r}")
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.n_layer = n_layer
        self.d_model = d_model
        self.n_head = n_head
        self.n_kv_head = n_kv_head
        self.positional = positional
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_seq_len, d_model) if positional == "learned" else None
        self.decoder = TransformerDecoder(
            n_layer=n_layer, d_model=d_model, n_head=n_head, dim_feedforward=dim_feedforward,
            dropout=dropout, activation="gelu", layer_norm_eps=1e-5, norm_first=True,
            use_cross_attention=False, final_layer_norm_eps=1e-5, n_kv_head=n_kv_head,
            remat=remat, moe_num_experts=moe_num_experts, cp_axis_name=cp_axis_name,
        )
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    def forward(
        self,
        tokens: torch.Tensor,
        deterministic: bool = True,
        positions: Optional[torch.Tensor] = None,
        past_key_values=None,
        cache_index=None,
        attention_mask: Optional[torch.Tensor] = None,
        use_cache: bool = False,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        b, s = tokens.shape
        x = self.tok_embed(tokens).to(self.dtype)
        pos_ids = (torch.arange(s, device=tokens.device)[None, :]
                   if positions is None else positions)
        rope_positions = None
        if self.positional == "rope":
            rope_positions = pos_ids.expand(b, s)
        else:
            x = x + self.pos_embed(pos_ids).to(self.dtype)
        out = self.decoder(
            x, attention_mask=attention_mask, past_key_values=past_key_values,
            use_cache=use_cache,
            # with an explicit mask (decode over a fixed buffer) causality is
            # the caller's; plain forwards stay causal
            is_causal=attention_mask is None, deterministic=deterministic,
            cache_index=cache_index, rope_positions=rope_positions, segment_ids=segment_ids,
        )
        logits = F.linear(out.last_hidden_state, self.lm_head.weight.to(self.dtype))
        if use_cache:
            return logits, out.current_key_values
        return logits


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of aligned (logits, targets): feed the model
    ``tokens[:, :-1]`` and pass ``tokens[:, 1:]`` here."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def packed_next_token_loss(logits: torch.Tensor, targets: torch.Tensor,
                           segment_ids: torch.Tensor) -> torch.Tensor:
    """Next-token loss over a packed batch (``data/packing.py``): feed the
    model ``tokens[:, :-1]`` with ``segment_ids[:, :-1]`` and pass
    ``tokens[:, 1:]`` and the whole ``segment_ids`` here. A position counts
    only when its target is the next token of the same document and not
    padding (segment 0)."""
    valid = (segment_ids[:, :-1] == segment_ids[:, 1:]) & (segment_ids[:, 1:] > 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


@torch.no_grad()
def init_parameters_(model: LongContextLM, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initial scales (fan-in scaled
    normal kernels, embeddings of std d_model^-0.5, zero biases, unit
    LayerNorms), drawn on the CPU from ``generator``, so every device gets
    the same weights from one seed."""
    for m in model.modules():
        if isinstance(m, Fp32LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.embedding_dim ** -0.5)


def long_context_lm(
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.bfloat16,
    param_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    **config,
) -> LongContextLM:
    """A ``LongContextLM(**config)`` with random weights from ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU), computing in
    ``dtype`` with weights held in ``param_dtype`` (default ``dtype``)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = LongContextLM(**config, dtype=dtype)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return to_param_dtype(model, param_dtype or dtype).eval()
