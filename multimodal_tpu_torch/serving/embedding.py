"""Batched embedding service: bucketed micro-batching for encoder towers.

Counterpart of ``multimodal_tpu/serving/embedding.py``. A request batch is
padded (by repeating its first row) up to the next bucket of a fixed ladder,
powers of two up to ``max_batch`` by default, so the encoder sees a small
fixed set of batch shapes; batches above ``max_batch`` split into
``max_batch`` chunks. The padding rows are sliced off again.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from multimodal_tpu_torch.utils.device import resolve_device


class EmbeddingServer:
    """Shape-bucketed batching around an encode function.

    Args:
        encode_fn: tensor batch on ``device`` -> embeddings (e.g.
            ``model.encode_text``, or preprocessing followed by
            ``model.encode_image``). It runs under ``torch.inference_mode()``.
        device: where batches go; CUDA when not given.
        max_batch: the largest batch (the throughput bucket).
        buckets: explicit bucket ladder; default powers of two up to
            ``max_batch``.
    """

    def __init__(
        self,
        encode_fn: Callable[[torch.Tensor], torch.Tensor],
        device: Optional[Union[str, torch.device]] = None,
        max_batch: int = 256,
        buckets: Optional[Sequence[int]] = None,
    ):
        self._fn = encode_fn
        self.device = resolve_device(device)
        self.max_batch = max_batch
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(buckets))
        if self.buckets[-1] != max_batch:
            raise ValueError("largest bucket must equal max_batch")

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _run_padded(self, chunk: np.ndarray) -> np.ndarray:
        n = chunk.shape[0]
        bucket = self._bucket(n)
        if n < bucket:
            pad = np.repeat(chunk[:1], bucket - n, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        with torch.inference_mode():
            out = self._fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device))
        return out[:n].float().cpu().numpy()

    def encode(self, inputs: np.ndarray) -> np.ndarray:
        """Embed a batch of any size; returns fp32 embeddings row-aligned
        with ``inputs``."""
        inputs = np.asarray(inputs)
        outs = [
            self._run_padded(inputs[i : i + self.max_batch])
            for i in range(0, inputs.shape[0], self.max_batch)
        ]
        return np.concatenate(outs, axis=0)
