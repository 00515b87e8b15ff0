"""Continuous-batching image captioning for BLIP-2. Counterpart of
``multimodal_tpu/serving/blip2_caption_server.py`` (``Blip2CaptionAdapter``,
``Blip2CaptionServer``).

Only the query tokens cross-attend the image; the text sees it through the
queries' keys and values in each layer's self-attention. Once those rows
are primed (one Q-Former forward over the query embeddings and the image),
captioning is a causal LM over a cache whose first ``num_query_token``
positions are per-request rows: the engine's ``kv_prefix_len`` feature.
``prime()`` computes the rows (and the ITC image features);
``submit()`` hands a request's rows to the engine as ``Request.kv_prefix``;
the prompt prefills from position ``num_query_token`` and decode attends
the rows through the valid-prefix mask, which is the Q-Former's causal mask
over a query prefix (``qformer_utils.py:get_causal_mask``). The adapter
runs each layer's self-attention and text feed-forward branch and the
prediction head; the query branch (cross-attention, ``feedforward_query``)
never runs in decode.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_tpu_torch.models.blip2.blip2 import BLIP2
from multimodal_tpu_torch.models.coca.coca_model import l2norm
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.serving.engine import InferenceEngine, Request, RequestOutput


class Blip2CaptionAdapter(nn.Module):
    """The Q-Former's text-only causal LM with the engine's call surface;
    its parameters are the BLIP-2 model's own. Cache positions count the
    ``num_query_token`` seeded rows, so the text position embeddings index
    ``positions - num_query_token``."""

    def __init__(self, blip2: BLIP2):
        super().__init__()
        q = blip2.qformer
        self.blip2 = blip2
        self.query_length = blip2.num_query_token
        self.n_layer = q.num_hidden_layers
        self.n_head = q.num_heads
        self.head_dim = q.dim_q // q.num_heads
        self.vocab_size = q.vocab_size
        self.max_text_positions = q.max_position_embeddings

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                past_key_values: Optional[tuple] = None, cache_index=None,
                attention_mask: Optional[torch.Tensor] = None, use_cache: bool = False):
        q = self.blip2.qformer
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        text_pos = (positions - self.query_length).clamp(0, self.max_text_positions - 1)
        x = q.model.embeddings(input_ids=tokens, position_ids=text_pos)
        new_kvs = []
        for i, layer in enumerate(q.model.encoder.layers):
            out = layer.self_attention(
                x, x, x, attn_mask=attention_mask,
                past_key_value=past_key_values[i] if past_key_values is not None else None,
                use_cache=True, is_causal=attention_mask is None, cache_index=cache_index)
            new_kvs.append(out.past_key_value)
            # post-norm residuals, the text feed-forward branch only
            x = layer.self_attn_layernorm(out.attn_output + x)
            x = layer.feedforward_layernorm(layer.feedforward(x) + x)
        logits = q.head(x)
        return (logits, tuple(new_kvs)) if use_cache else logits


class Blip2CaptionServer:
    """Continuous-batching BLIP-2 captioning over ``InferenceEngine``.

    ``prime(images)`` gives each image's per-layer query rows and its ITC
    features; ``submit(prompt, image= | kv_prefix=)`` queues a caption
    request; ``run()`` drains. ``max_text_len`` bounds a request's prompt
    and generated tokens (the cache holds ``num_query_token + max_text_len``
    positions); ``engine_kwargs`` go to the engine (``device`` among them:
    CUDA unless ``"cpu"`` is given, and the model's device).
    """

    def __init__(self, blip2: BLIP2, n_slots: int = 8, max_text_len: int = 32,
                 **engine_kwargs: Any):
        q = blip2.qformer
        if max_text_len > q.max_position_embeddings:
            raise ValueError(f"max_text_len ({max_text_len}) exceeds the text position table "
                             f"({q.max_position_embeddings})")
        self.blip2 = blip2
        self.adapter = Blip2CaptionAdapter(blip2)
        self.max_text_len = max_text_len
        p = self.adapter.query_length
        self.engine = InferenceEngine(
            self.adapter, n_slots=n_slots, max_len=p + max_text_len, n_layer=self.adapter.n_layer,
            n_head=self.adapter.n_head, head_dim=self.adapter.head_dim, kv_prefix_len=p,
            **engine_kwargs)

    @torch.no_grad()
    def prime(self, images: torch.Tensor) -> Tuple[List[tuple], torch.Tensor]:
        """One forward for a batch of NHWC images: ``(kv_prefixes,
        image_features)``, ``kv_prefixes[i]`` image i's per-layer ``(k, v)``
        rows (each ``(heads, num_query_token, head_dim)``, on the device),
        ready for :meth:`submit`; ``image_features`` the ``(b,
        num_query_token, embed)`` normalized ITC features."""
        m = self.blip2
        image_embeds = m.encode_image(torch.as_tensor(images).to(self.engine.device))
        query_tokens = m.query_tokens.to(m.compute_dtype).expand(image_embeds.shape[0], -1, -1)
        query_out, kvs = m.qformer.model(query_embeds=query_tokens,
                                         encoder_hidden_states=image_embeds, use_cache=True)
        feats = l2norm(dense(m.vision_proj, query_out, m.compute_dtype))
        per_image = [tuple((k[i], v[i]) for k, v in kvs) for i in range(image_embeds.shape[0])]
        return per_image, feats

    def submit(self, prompt: Sequence[int], image=None, kv_prefix: Optional[tuple] = None,
               request_id: Any = None, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, eos_id: Optional[int] = None,
               on_token: Optional[Any] = None) -> None:
        """Queue a caption request: ``prompt`` the prompt ids (the
        reference's convention starts them with ``decoder_bos_token_id``),
        and ``image`` (one image, primed here) or ``kv_prefix`` (one entry
        of :meth:`prime`)."""
        if (image is None) == (kv_prefix is None):
            raise ValueError("pass exactly one of image / kv_prefix")
        if image is not None:
            kv_prefix = self.prime(torch.as_tensor(image)[None])[0][0]
        budget = self.max_text_len - len(prompt)
        if max_new_tokens is None:
            max_new_tokens = budget
        if max_new_tokens > budget:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds max_text_len ({self.max_text_len})")
        self.engine.submit(Request(
            list(prompt), max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_id=eos_id, request_id=request_id, on_token=on_token,
            kv_prefix=kv_prefix))

    def run(self) -> List[RequestOutput]:
        return self.engine.run()
