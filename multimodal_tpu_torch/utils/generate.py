"""Autoregressive generation. Counterpart of
``multimodal_tpu/utils/generate.py``: the logits mask and filters,
``filter_logits_per_row`` (which the serving engine samples with) and
``GenerationUtil``, the offline sampler over a ``MultimodalGPT``.

``GenerationUtil.sample`` follows the JAX sampler step for step: the
right-shifted input modality primes the cache, which then becomes one
preallocated full-length buffer per layer written in place at each step's
index and read through the valid-prefix mask; step 0 feeds the last input
token as input modality at position ``in_seq_len - 1``, the later steps
feed output-modality ids (the sample less ``num_in_tokens``) at position
``step - 1``; the tokens are VQ-decoded at the end. The JAX sampler's
``lax.scan`` is a Python loop here. Draws are Gumbel-max from a
``torch.Generator``: ``jax.random.categorical``'s cannot be reproduced, so
only greedy runs (``top_k=1``) compare with JAX.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch


class SampleOutput(NamedTuple):
    decoded: Any
    tokens: torch.Tensor


def get_logits_mask(in_seq_len: int = 0, out_seq_len: int = 0, num_in_tokens: int = 0,
                    num_out_tokens: int = 0, device=None) -> torch.Tensor:
    """1 = allowed: input positions may predict input tokens, output
    positions output tokens."""
    mask = torch.zeros(in_seq_len + out_seq_len, num_in_tokens + num_out_tokens, device=device)
    mask[in_seq_len:, num_in_tokens:] = 1
    mask[:in_seq_len, :num_in_tokens] = 1
    return mask


def logits_filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the ``top_k`` largest logits of each row (ties with the k-th
    too); the rest become -inf."""
    if top_k <= 0:
        return logits
    top_k = min(top_k, logits.shape[-1])
    kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
    return torch.where(logits < kth, -math.inf, logits)


def logits_filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p``; the most likely token always stays."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    threshold = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, -math.inf)


def filter_logits_per_row(logits: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Vectorized per-row top-k then nucleus filtering (continuous batching:
    every slot carries its own sampling parameters). ``top_k`` (b,) integers
    with 0 = disabled; ``top_p`` (b,) floats with >= 1.0 = disabled. Removed
    entries become ``-inf``."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = top_k.long().clamp(1, v)
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    k_masked = torch.where(logits < kth, -math.inf, logits)
    out = torch.where((top_k > 0)[:, None], k_masked, logits)

    # nucleus over the (possibly) k-filtered distribution, as applying the
    # top-k filter then the top-p filter in sequence
    sorted_out = torch.sort(out, dim=-1, descending=True).values
    probs = torch.softmax(sorted_out, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    threshold = torch.where(keep, sorted_out, math.inf).amin(dim=-1, keepdim=True)
    p_masked = torch.where(out >= threshold, out, -math.inf)
    return torch.where((top_p < 1.0)[:, None], p_masked, out)


def _filter_logits(logits: torch.Tensor, top_k: Optional[int], top_p: Optional[float]
                   ) -> torch.Tensor:
    if top_k is not None:
        logits = logits_filter_top_k(logits, top_k)
    if top_p is not None:
        logits = logits_filter_top_p(logits, top_p)
    return logits


def gumbel_sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max trick
    (``jax.random.categorical``'s method), from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits.float() - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(dim=-1)


class GenerationUtil:
    """Sampler over a ``MultimodalGPT``-style module (``encode``, ``fwd``,
    ``decode``, ``num_in_tokens``, ``num_out_tokens``)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.num_in_tokens = model.num_in_tokens
        self.num_out_tokens = model.num_out_tokens

    @torch.no_grad()
    def sample(self, x: Any, max_seq_len: int, generator: Optional[torch.Generator] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               **model_kwargs: Any) -> SampleOutput:
        """``max_seq_len`` output-modality tokens for each input in ``x``
        (what the input tokenizer encodes), and their decoding."""
        model, num_in = self.model, self.num_in_tokens
        in_tokens = model.encode(x, "in", **model_kwargs)
        b, in_seq_len = in_tokens.shape
        device = in_tokens.device
        total_len = in_seq_len + max_seq_len
        logits_mask = get_logits_mask(0, 1, num_in, self.num_out_tokens, device=device)

        prime = model.fwd(in_tokens=in_tokens, use_cache=True, causal=True, right_shift=True)

        def full_length(t: torch.Tensor) -> torch.Tensor:
            buf = t.new_zeros(t.shape[:2] + (total_len,) + t.shape[3:])
            buf[:, :, :in_seq_len] = t
            return buf

        caches = tuple((full_length(k), full_length(v)) for k, v in prime.past_key_values)
        keys = torch.arange(total_len, device=device)[None, None, None, :]

        def step(token, pos, is_in_modality: bool, write_idx: int) -> torch.Tensor:
            pos_ids = torch.full((b, 1), pos, dtype=torch.long, device=device)
            kwargs = dict(logits_mask=logits_mask, use_cache=True, attn_mask=keys <= write_idx,
                          past_key_values=caches, cache_index=write_idx)
            if is_in_modality:
                out = model(in_tokens=token, in_pos_ids=pos_ids, **kwargs)
            else:
                out = model(out_tokens=token, out_pos_ids=pos_ids, **kwargs)
            logits = _filter_logits(out.logits.reshape(b, -1), top_k, top_p)
            return (gumbel_sample(logits, generator) - num_in)[:, None]

        token = step(in_tokens[:, -1:], in_seq_len - 1, True, in_seq_len)
        tokens = [token]
        for s in range(1, max_seq_len):
            token = step(token, s - 1, False, in_seq_len + s)
            tokens.append(token)
        tokens = torch.cat(tokens, dim=1)
        return SampleOutput(decoded=model.decode(tokens), tokens=tokens)
