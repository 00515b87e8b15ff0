"""Device prefetch: the next batch's host-to-device copy runs under the
current step.

Counterpart of ``multimodal_tpu/data/device_prefetch.py``. A batch (a
tensor, a numpy array, or a tuple, list or dict of them) is copied one step
ahead: on CUDA from pinned host memory with ``non_blocking=True``, so the
copy is queued on the stream behind the running step and the host goes on.
On the CPU the batch is handed through as tensors.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np
import torch


def to_device(batch: Any, device: torch.device) -> Any:
    """``batch`` with every array leaf on ``device``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = torch.from_numpy(batch) if isinstance(batch, np.ndarray) else batch
    if not isinstance(t, torch.Tensor) or t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(batches: Iterable[Any], device: torch.device) -> Iterator[Any]:
    """Yield the batches of ``batches`` on ``device``, one copy ahead."""
    it = iter(batches)
    try:
        nxt = to_device(next(it), device)
    except StopIteration:
        return
    while True:
        cur = nxt
        try:
            nxt = to_device(next(it), device)
        except StopIteration:
            yield cur
            return
        yield cur
