"""Collectives with explicit gradient semantics.

Counterpart of ``multimodal_tpu/parallel/collectives.py``, over
``torch.distributed``:

- ``GLOBAL``: ``torch.distributed.nn.functional.all_gather``, whose
  backward is a reduce-scatter, as ``jax.lax.all_gather``'s VJP is;
- ``LOCAL``: gather without gradient, then put the live local shard back at
  this rank's offset, so gradients flow only through the local slice;
- ``NONE``: fully detached gather.

With no initialised process group, or ``group=None`` on a world of one
process, they return ``x``, as the JAX functions do with ``axis_name=None``.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


class BackpropType(enum.Enum):
    GLOBAL = 0
    LOCAL = 1
    NONE = 2


def _active(group: Optional[dist.ProcessGroup]) -> bool:
    if not (dist.is_available() and dist.is_initialized()):
        return False
    return group is not None or dist.get_world_size() > 1


def get_rank(group: Optional[dist.ProcessGroup] = None) -> int:
    """This process's rank in ``group`` (0 when nothing is distributed)."""
    return dist.get_rank(group) if _active(group) else 0


def all_gather_with_backprop_type(
    x: torch.Tensor,
    group: Optional[dist.ProcessGroup] = None,
    backprop_type: BackpropType = BackpropType.GLOBAL,
) -> torch.Tensor:
    """All-gather ``x`` over ``group``, concatenated on dim 0."""
    if not _active(group):
        return x
    if backprop_type == BackpropType.GLOBAL:
        return torch.cat(dist_nn.all_gather(x, group=group), dim=0)
    x_local = x.detach().contiguous()
    parts = [torch.empty_like(x_local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x_local, group=group)
    if backprop_type == BackpropType.LOCAL:
        parts[dist.get_rank(group)] = x
    return torch.cat(parts, dim=0)
