"""Quantized KV-cache storage format.

Counterpart of ``multimodal_tpu/ops/kv_cache.py``. Keys and values are
stored as int8 with one fp32 scale per ``(batch, head, position)`` over the
head dimension: half the bytes of a bf16 cache, which is what a decode tick
at batch reads. Quantization happens when a row is written; the read side
(``ops/quantized_attention.py``) applies the scales after its products, so
the dense cache never exists.

The rounding is the JAX package's, bit for bit: ``scale = max(amax / 127,
1e-8)``, ``round`` half to even, clip to +-127.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class QuantizedKV:
    """int8 cache tensor plus fp32 per-position scales.

    ``q``: int8, ``(..., positions, head_dim)``; ``scale``: fp32,
    ``(..., positions)``; ``dense ~= q * scale[..., None]``. The tensors are
    updated in place by the cache writes (``_write_fixed_cache``, the
    engine's row writes): a decode tick rewrites one position, not the cache.
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale[..., None]).to(dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8 over the trailing head dim: ``(q int8,
    scale fp32)`` with ``x ~= q * scale[..., None]``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantized_kv_zeros(shape, device=None) -> QuantizedKV:
    """Empty quantized cache buffer of dense-equivalent ``shape``
    ``(..., positions, head_dim)``."""
    return QuantizedKV(
        q=torch.zeros(shape, dtype=torch.int8, device=device),
        scale=torch.zeros(tuple(shape)[:-1], dtype=torch.float32, device=device),
    )


def is_quantized_kv(x) -> bool:
    return isinstance(x, QuantizedKV)
