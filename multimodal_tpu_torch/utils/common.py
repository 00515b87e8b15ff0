"""Small shared utilities. Counterpart of ``multimodal_tpu/utils/common.py``:
``shift_dim``, ``to_tuple_tuple`` and momentum (EMA) copies of a module.

The JAX package threads a second parameter tree through its steps; here the
momentum copy is a second module whose parameters are registered buffers
(``momentum_copy``), so no optimizer or autograd sees them, and
``momentum_update`` moves them toward the trained module's parameters in
place: ``m = m * momentum + p * (1 - momentum)`` over matching names.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_tpu_torch.utils.device import resolve_device


def momentum_copy(module: nn.Module, device: Optional[Union[str, torch.device]] = None
                  ) -> nn.Module:
    """A deep copy of ``module`` on ``device`` (CUDA unless ``"cpu"`` is
    given; see ``utils/device.py``) whose parameters are buffers of the same
    names, detached, in eval mode."""
    dev = resolve_device(device)
    copied = copy.deepcopy(module).to(dev)
    for sub in copied.modules():
        for name, p in list(sub._parameters.items()):
            del sub._parameters[name]
            if p is not None:
                sub.register_buffer(name, p.detach().clone())
    return copied.eval()


@torch.no_grad()
def momentum_update(module: nn.Module, module_m: nn.Module, momentum: float) -> None:
    """The EMA step over every parameter of ``module`` and the buffer of the
    same name in ``module_m`` (a :func:`momentum_copy`), in place."""
    params = dict(module.named_parameters())
    buffers = dict(module_m.named_buffers())
    missing = [n for n in params if n not in buffers]
    if missing:
        raise ValueError(f"momentum copy lacks {missing[:4]}")
    m = [buffers[n] for n in params]
    p = [params[n].detach() for n in params]
    torch._foreach_mul_(m, momentum)
    torch._foreach_add_(m, p, alpha=1.0 - momentum)


def shift_dim(x: torch.Tensor, src_dim: int = -1, dest_dim: int = -1) -> torch.Tensor:
    """``x`` with dimension ``src_dim`` moved to position ``dest_dim`` (a
    view)."""
    return x.movedim(src_dim, dest_dim)


def to_tuple_tuple(param: Any, dim_tuple: int, num_tuple: int) -> Tuple:
    """An int or a tuple of ints as ``num_tuple`` tuples of length
    ``dim_tuple`` (the per-layer kernel sizes and strides of 3-D conv
    stacks); a tuple of tuples passes through."""
    if isinstance(param, int):
        param = (param,) * dim_tuple
    if isinstance(param, tuple) and all(isinstance(p, int) for p in param):
        param = (param,) * num_tuple
    return tuple(param)
