"""Sampling helpers. Counterpart of ``multimodal_tpu/utils/generate.py``:
``filter_logits_per_row`` only, which the serving engine samples with."""

from __future__ import annotations

import math

import torch


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
