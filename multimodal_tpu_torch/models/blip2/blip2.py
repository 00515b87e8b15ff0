"""BLIP-2 stage 1. Counterpart of ``multimodal_tpu/models/blip2/blip2.py``
(``Blip2Output``, ``BLIP2``): a frozen image tower (run without gradients,
the JAX module's ``stop_gradient``, so it keeps no activations), ``ln_vision``,
learned query tokens, the Q-Former, and 256-wide projections.

``BLIP2.forward`` runs the Q-Former over the queries with cross-attention to
the image and keeps each layer's query keys and values; the text pass
(ITC features) runs the Q-Former over the text alone; the captioning pass
(ITG) runs ``QformerForCLM`` over the text on top of the cached query keys
and values, through which the gradient reaches the queries, as ``jax.grad``
does. ``itm_forward`` is the Q-Former over ``[queries; text]`` with
cross-attention, for the ITM loss's 3x batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from multimodal_tpu_torch.models.coca.coca_model import l2norm
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class Blip2Output(NamedTuple):
    image_embeddings: torch.Tensor
    image_features: torch.Tensor
    image_qformer_output: torch.Tensor
    text_features: Optional[torch.Tensor] = None
    prediction_scores: Optional[torch.Tensor] = None


class BLIP2(nn.Module):
    """``qformer`` a ``QformerForCLM``; ``vision_encoder`` returns a
    ``TransformerOutput`` or a tensor. ``dtype`` is the compute dtype
    (None: the query tokens')."""

    def __init__(
        self,
        qformer: nn.Module,
        vision_encoder: nn.Module,
        dim_q: int,
        image_encoder_embedding_dim: int,
        freeze_vision_encoder: bool = True,
        cross_attention_freq: int = 2,
        embedding_dim: int = 256,
        num_query_token: int = 32,
        decoder_bos_token_id: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.qformer = qformer
        self.vision_encoder = vision_encoder
        self.dim_q = dim_q
        self.freeze_vision_encoder = freeze_vision_encoder
        self.num_query_token = num_query_token
        self.decoder_bos_token_id = decoder_bos_token_id
        self.dtype = dtype
        self.query_tokens = nn.Parameter(torch.randn(1, num_query_token, dim_q) * 0.02)
        self.vision_proj = nn.Linear(dim_q, embedding_dim)
        self.text_proj = nn.Linear(dim_q, embedding_dim)
        self.ln_vision = Fp32LayerNorm(image_encoder_embedding_dim, eps=1e-5)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.query_tokens.dtype

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_vision_encoder):
            out = self.vision_encoder(image, deterministic=True)
        if isinstance(out, tuple):  # TransformerOutput
            out = out[0]
        return self.ln_vision(out).to(self.compute_dtype)

    def _queries(self, b: int) -> torch.Tensor:
        return self.query_tokens.to(self.compute_dtype).expand(b, -1, -1)

    def itm_forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    image_embeds: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """The Q-Former over ``[queries; text]`` cross-attending the images;
        the query slice of its output."""
        query_tokens = self._queries(input_ids.shape[0])
        query_atts = torch.ones(query_tokens.shape[:-1], dtype=attention_mask.dtype,
                                device=attention_mask.device)
        out, _ = self.qformer.model(input_ids=input_ids, query_embeds=query_tokens,
                                    attention_mask=torch.cat([query_atts, attention_mask], dim=1),
                                    encoder_hidden_states=image_embeds,
                                    deterministic=deterministic)
        return out[:, : self.num_query_token]

    def forward(self, image: torch.Tensor, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> Blip2Output:
        image_embeds = self.encode_image(image)
        dt = self.compute_dtype
        query_tokens = self._queries(image_embeds.shape[0])
        query_output, query_kv_cache = self.qformer.model(
            query_embeds=query_tokens, encoder_hidden_states=image_embeds, use_cache=True,
            deterministic=deterministic)
        image_feats = l2norm(dense(self.vision_proj, query_output, dt))

        text_feats = prediction_scores = None
        if input_ids is not None:
            text_output, _ = self.qformer.model(input_ids=input_ids,
                                                attention_mask=attention_mask,
                                                deterministic=deterministic)
            text_feats = l2norm(dense(self.text_proj, text_output[:, 0], dt))
            decoder_input_ids = input_ids
            if self.decoder_bos_token_id is not None:
                decoder_input_ids = input_ids.clone()
                decoder_input_ids[:, 0] = self.decoder_bos_token_id
            full_mask = attention_mask
            if attention_mask is not None:
                query_atts = torch.ones(query_tokens.shape[:-1], dtype=attention_mask.dtype,
                                        device=attention_mask.device)
                full_mask = torch.cat([query_atts, attention_mask], dim=1)
            prediction_scores = self.qformer(input_ids=decoder_input_ids,
                                             attention_mask=full_mask,
                                             past_key_values=query_kv_cache,
                                             deterministic=deterministic)
        return Blip2Output(image_embeddings=image_embeds, image_features=image_feats,
                           image_qformer_output=query_output, text_features=text_feats,
                           prediction_scores=prediction_scores)
