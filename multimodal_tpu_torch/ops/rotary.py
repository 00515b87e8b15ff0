"""Rotary position embeddings (RoPE). Counterpart of
``multimodal_tpu/ops/rotary.py``: applied per head after the head split, in
fp32, NeoX-style half rotation. Only relative offsets reach ``q . k``, so
cached keys (rotated at their own write) stay valid as positions grow."""

from __future__ import annotations

import torch


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (b, h, s, d) by per-token ``positions`` (b, s) or (s,).

    Pairs dimension i with i + d/2 (rotate-half layout); d must be even.
    """
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rotary head dim must be even, got {d}")
    half = d // 2
    if positions.dim() == 1:
        positions = positions[None, :]
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None, :, None].float() * freqs  # (b, 1, s, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
