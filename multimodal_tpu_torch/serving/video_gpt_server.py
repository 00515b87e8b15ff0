"""Continuous-batching serving of ``MultimodalGPT`` generation (text to
video, video to video). Counterpart of
``multimodal_tpu/serving/video_gpt_server.py``.

``VideoGPTServingAdapter`` gives the GPT the serving engine's causal-LM
surface (``model(tokens, positions=, past_key_values=, cache_index=,
attention_mask=, use_cache=True) -> (logits, kvs)``), so generation
requests get continuous batching, bucketed prefill and the int8 cache
while the tokens stay the sampler's (``utils/generate.py``):

- The GPT is trained right-shifted: the input at sequence position q is
  ``emb(token(q - 1)) + pos_emb(q - 1)``, and position 0's is the learned
  start vector alone. The token fed at write position p therefore takes
  its own modality's position index ``p - 1`` (input) or ``p - 1 -
  in_seq_len`` (output), clipped to each table, and the logits at p
  predict the token at p: the engine's next-token contract.
- The start row is a registered prefix: ``VideoGPTServer`` registers the
  one-token prefix ``[SOS]`` once and every request rides it, so the
  adapter stays a plain next-token LM.
- One id space: ids below ``num_in`` are input modality, the output
  modality's are offset by ``num_in``, and SOS is ``num_in + num_out``.
  The logits are masked to the output modality (``get_logits_mask``), as
  the sampler's are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from multimodal_tpu_torch.serving.engine import InferenceEngine, Request
from multimodal_tpu_torch.utils.generate import get_logits_mask


class VideoGPTServingAdapter(nn.Module):
    """A ``MultimodalGPT`` (child ``gpt``) behind the engine's decode
    surface. ``in_seq_len`` is the fixed input-modality prompt length, the
    modality boundary; ``in_positions`` / ``out_positions`` bound the
    per-modality position tables (default: their ``num_positions``)."""

    def __init__(self, gpt: nn.Module, in_seq_len: int, in_positions: Optional[int] = None,
                 out_positions: Optional[int] = None):
        super().__init__()
        self.gpt = gpt
        self.in_seq_len = in_seq_len
        dec = gpt.mm_decoder
        self.in_positions = in_positions or dec.in_pos_emb.num_positions
        self.out_positions = out_positions or dec.out_pos_emb.num_positions
        self.register_buffer(
            "logits_mask", get_logits_mask(0, 1, gpt.num_in_tokens, gpt.num_out_tokens,
                                           device=gpt.to_logit.weight.device), persistent=False)

    @property
    def sos_id(self) -> int:
        return self.gpt.num_in_tokens + self.gpt.num_out_tokens

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                past_key_values=None, cache_index=None, attention_mask=None,
                use_cache: bool = False):
        gpt = self.gpt
        num_in, num_out = gpt.num_in_tokens, gpt.num_out_tokens
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        is_in = (tokens < num_in)[..., None]
        # both modalities' embeddings, selected (the other reads clipped ids)
        emb = torch.where(is_in, gpt._project(tokens.clamp(0, num_in - 1), "in"),
                          gpt._project((tokens - num_in).clamp(0, num_out - 1), "out"))
        dec = gpt.mm_decoder
        in_pos = (positions - 1).clamp(0, self.in_positions - 1)
        out_pos = (positions - 1 - self.in_seq_len).clamp(0, self.out_positions - 1)
        x = emb + torch.where(is_in, dec.in_pos_emb(in_pos).to(emb.dtype),
                              dec.out_pos_emb(out_pos).to(emb.dtype))
        # start rows: the learned start vector alone (the right shift of a
        # length-1 sequence is exactly it)
        x = torch.where((tokens == self.sos_id)[..., None],
                        dec.right_shift(torch.zeros_like(x[:, :1])), x)
        # not causal, as in JAX: the engine passes the mask or a cache index
        out = dec.decoder(x, attention_mask, None, use_cache, False,
                          past_key_values=past_key_values, cache_index=cache_index)
        return gpt.logit_projection(out.last_hidden_states, self.logits_mask), out.past_key_values


def wrap_gpt_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A GPT ``state_dict`` re-rooted under the adapter's ``gpt`` child."""
    return {f"gpt.{k}": v for k, v in state_dict.items()}


class VideoGPTServer:
    """Continuous-batching video generation server.

    Args:
        gpt: a ``MultimodalGPT`` on ``device``.
        in_seq_len: the fixed input-modality prompt length (MUGEN's text
            length); every prompt must have it.
        n_slots / max_new_tokens / engine_kwargs: the engine's pool;
            ``max_new_tokens`` defaults to the whole output latent volume.
        device: CUDA unless the caller passes ``"cpu"``.
    """

    def __init__(self, gpt: nn.Module, in_seq_len: int, n_slots: int = 8,
                 max_new_tokens: Optional[int] = None, device=None, **engine_kwargs: Any):
        self.gpt = gpt
        self.num_in = gpt.num_in_tokens
        self.in_seq_len = in_seq_len
        self.max_new_tokens = (max_new_tokens if max_new_tokens is not None
                               else math.prod(gpt.latent_shape))
        self.adapter = VideoGPTServingAdapter(gpt, in_seq_len)
        decoder = gpt.mm_decoder.decoder
        self.engine = InferenceEngine(
            self.adapter, n_slots=n_slots, max_len=1 + in_seq_len + self.max_new_tokens,
            n_layer=decoder.num_layers, n_head=decoder.n_head,
            head_dim=gpt.d_model // decoder.n_head, device=device, **engine_kwargs)
        self.engine.register_prefix("sos", [self.adapter.sos_id])

    def submit(self, in_tokens: Sequence[int], request_id: Any = None, temperature: float = 0.0,
               max_new_tokens: Optional[int] = None) -> None:
        """Queue a generation request: ``in_tokens`` are input-modality ids
        (``[0, num_in)``), exactly ``in_seq_len`` of them."""
        if len(in_tokens) != self.in_seq_len:
            raise ValueError(f"prompt must be exactly in_seq_len={self.in_seq_len} "
                             f"input-modality tokens, got {len(in_tokens)}")
        self.engine.submit(Request(list(in_tokens), max_new_tokens=max_new_tokens
                                   or self.max_new_tokens, temperature=temperature,
                                   request_id=request_id, prefix="sos"))

    def run(self) -> List:
        """Drain the queue; the outputs carry output-modality token ids (the
        unified ids less ``num_in``)."""
        outs = self.engine.run()
        for o in outs:
            o.tokens = [t - self.num_in for t in o.tokens]
        return outs

    @torch.no_grad()
    def decode_videos(self, tokens) -> torch.Tensor:
        """Output-modality latent ids ``(b, prod(latent_shape))`` -> pixels
        through the VQ-VAE decoder."""
        tokens = torch.as_tensor(np.asarray(tokens), device=self.engine.device)
        return self.gpt.decode(tokens)
