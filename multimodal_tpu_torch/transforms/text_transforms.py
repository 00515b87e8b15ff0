"""Text sequence primitives. Counterpart of
``multimodal_tpu/transforms/text_transforms.py``.

Callables over token-id lists. ``ToTensor`` and ``PadTransform`` give CPU
``torch.int64`` tensors (the JAX package gives numpy int32 arrays of the
same values), which ``nn.Embedding`` takes as they are.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch
from torch.nn import functional as F

TokenList = List[int]


class Truncate:
    def __init__(self, max_seq_len: int):
        self.max_seq_len = max_seq_len

    def __call__(self, tokens: Union[TokenList, List[TokenList]]):
        if tokens and isinstance(tokens[0], list):
            return [t[: self.max_seq_len] for t in tokens]
        return tokens[: self.max_seq_len]


class AddToken:
    def __init__(self, token: int, begin: bool = True):
        self.token = token
        self.begin = begin

    def _one(self, t: TokenList) -> TokenList:
        return [self.token] + t if self.begin else t + [self.token]

    def __call__(self, tokens: Union[TokenList, List[TokenList]]):
        if tokens and isinstance(tokens[0], list):
            return [self._one(t) for t in tokens]
        return self._one(tokens)


class ToTensor:
    """Pad ragged lists of token ids into a (batch, max_len) tensor."""

    def __init__(self, padding_value: int = 0, dtype: torch.dtype = torch.int64):
        self.padding_value = padding_value
        self.dtype = dtype

    def __call__(self, tokens: Union[TokenList, List[TokenList]]) -> torch.Tensor:
        if not tokens or not isinstance(tokens[0], list):
            return torch.tensor(tokens, dtype=self.dtype)
        max_len = max(len(t) for t in tokens)
        out = np.full((len(tokens), max_len), self.padding_value, dtype=np.int64)
        for i, t in enumerate(tokens):
            out[i, : len(t)] = t
        return torch.from_numpy(out).to(self.dtype)


class PadTransform:
    """Pad the last dim of an int tensor to ``max_length`` with ``pad_value``
    (longer rows are cut to it)."""

    def __init__(self, max_length: int, pad_value: int = 0):
        self.max_length = max_length
        self.pad_value = pad_value

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        cur = x.shape[-1]
        if cur >= self.max_length:
            return x[..., : self.max_length]
        return F.pad(x, (0, self.max_length - cur), value=self.pad_value)
