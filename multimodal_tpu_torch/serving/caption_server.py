"""Continuous-batching image captioning for CoCa. Counterpart of
``multimodal_tpu/serving/caption_server.py`` (``CoCaCaptionAdapter``,
``_captioning_geometry``, ``CoCaCaptionServer``).

CoCa's two causal stacks (the text decoder's layers, then the multimodal
decoder's, which also cross-attend the image) sit behind the engine's
causal-LM surface as one flat KV cache of ``text_n_layer + fusion_n_layer``
layers that the adapter splits. The captioning path leaves out the text
decoder's appended CLS token: no earlier position attends it, so dropping it
changes nothing before it. Each request's conditioning row is its image's
captioning tokens (the pooler's first stage), which the engine keeps in its
per-slot buffer; the adapter recomputes the cross-attention keys and values
from them in every layer on every call, as the JAX adapter does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_tpu_torch.models.coca.coca_model import CoCaModel
from multimodal_tpu_torch.modules.layers.attention_pooler import CascadedAttentionPooler
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.serving.engine import InferenceEngine, Request, RequestOutput


class CoCaCaptionAdapter(nn.Module):
    """CoCa's captioning decode path with the engine's call surface:
    ``adapter(tokens, positions=, past_key_values=, cache_index=,
    attention_mask=, use_cache=, conditioning=)`` returns the vocabulary
    logits (and the new per-layer caches with ``use_cache``). Its
    parameters are the CoCa model's own."""

    def __init__(self, model: CoCaModel):
        super().__init__()
        td, md = model.text_decoder, model.multimodal_decoder
        if md.output_dim is None:
            raise ValueError("captioning requires multimodal_output_projection_dim (the vocab "
                             "logits projection)")
        if td.embedding_dim != md.text_embedding_dim:
            raise ValueError("text decoder hidden dim must equal multimodal decoder input dim "
                             f"({td.embedding_dim} != {md.text_embedding_dim})")
        if td.n_head != md.n_head:
            raise ValueError("engine KV geometry is uniform across layers: text and fusion head "
                             f"counts must match ({td.n_head} != {md.n_head})")
        self.model = model
        self.n_text_layers = td.n_layer
        self.n_layer = td.n_layer + md.n_layer
        self.n_head = td.n_head
        self.head_dim = td.embedding_dim // td.n_head
        # the CLS token takes the position table's last slot
        self.max_positions = td.num_positions - 1 if td.embed_cls else td.num_positions
        self.vocab_size = md.output_dim

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                past_key_values: Optional[tuple] = None, cache_index=None,
                attention_mask: Optional[torch.Tensor] = None, use_cache: bool = False,
                conditioning: Optional[torch.Tensor] = None):
        td, md = self.model.text_decoder, self.model.multimodal_decoder
        emb = td.embeddings
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        positions = positions.clamp(0, self.max_positions - 1)
        dt = emb.dtype or emb.token_embeddings.weight.dtype
        x = emb.token_embeddings.weight.to(dt)[tokens] + emb.position_embeddings.to(dt)[positions]
        n = self.n_text_layers
        text_pkv = past_key_values[:n] if past_key_values is not None else None
        mm_pkv = past_key_values[n:] if past_key_values is not None else None
        kw = dict(attention_mask=attention_mask, use_cache=use_cache,
                  is_causal=attention_mask is None, cache_index=cache_index)
        t_out = td.transformer_decoder(x, past_key_values=text_pkv, **kw)
        m_out = md.transformer_decoder(t_out.last_hidden_state,
                                       encoder_hidden_states=conditioning,
                                       past_key_values=mm_pkv, **kw)
        hidden = m_out.last_hidden_state
        logits = dense(md.output_projection, hidden, hidden.dtype)
        if use_cache:
            return logits, tuple(t_out.current_key_values) + tuple(m_out.current_key_values)
        return logits


def _captioning_geometry(model: CoCaModel) -> Tuple[int, int]:
    """``(n_ctx, dim)`` of the captioning image tokens the vision pooler
    emits: the shape of a conditioning row."""
    pooler = model.vision_pooler
    if isinstance(pooler, CascadedAttentionPooler):
        first = pooler.poolers[0]
        return first.n_queries, first.output_embed_dim
    return pooler.n_queries - 1, pooler.output_embed_dim


class CoCaCaptionServer:
    """Continuous-batching image captioning over ``InferenceEngine``.

    ``encode(images)`` gives each image's captioning tokens and contrastive
    embedding; ``submit(prompt, image= | image_tokens=)`` queues a caption
    request whose conditioning row is its image's tokens; ``run()`` drains.
    ``max_len`` is the text position table's (``num_text_positions``, less
    the CLS slot); ``engine_kwargs`` go to the engine (``device`` among them:
    CUDA unless ``"cpu"`` is given, and the model's device).
    """

    def __init__(self, model: CoCaModel, n_slots: int = 8, **engine_kwargs: Any):
        self.model = model
        self.adapter = CoCaCaptionAdapter(model)
        emb = model.text_decoder.embeddings
        self.engine = InferenceEngine(
            self.adapter, n_slots=n_slots, max_len=self.adapter.max_positions,
            n_layer=self.adapter.n_layer, n_head=self.adapter.n_head,
            head_dim=self.adapter.head_dim,
            conditioning_spec=(_captioning_geometry(model),
                               emb.dtype or emb.token_embeddings.weight.dtype),
            **engine_kwargs)

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One vision forward for a batch of NHWC images: per image the
        captioning tokens ``(b, n_ctx, d)`` and the contrastive embedding
        ``(b, d)``, on the engine's device."""
        return self.model.encode_image(torch.as_tensor(images).to(self.engine.device))

    def submit(self, prompt: Sequence[int], image=None,
               image_tokens: Optional[torch.Tensor] = None, request_id: Any = None,
               max_new_tokens: Optional[int] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, on_token: Optional[Any] = None) -> None:
        """Queue a caption request: ``prompt`` the BOS/prompt ids, and
        ``image`` (one image, encoded here) or ``image_tokens`` (one row of
        :meth:`encode`'s captioning tokens)."""
        if (image is None) == (image_tokens is None):
            raise ValueError("pass exactly one of image / image_tokens")
        if image is not None:
            image_tokens = self.encode(torch.as_tensor(image)[None])[0][0]
        budget = self.adapter.max_positions - len(prompt)
        if max_new_tokens is None:
            max_new_tokens = budget
        if max_new_tokens > budget:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds the text position table ({self.adapter.max_positions})")
        self.engine.submit(Request(
            list(prompt), max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_id=eos_id, request_id=request_id, on_token=on_token,
            conditioning=torch.as_tensor(image_tokens)))

    def run(self) -> List[RequestOutput]:
        return self.engine.run()
