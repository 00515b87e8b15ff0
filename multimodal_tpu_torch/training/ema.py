"""EMA model tracking. Counterpart of ``multimodal_tpu/training/ema.py``:
an exponential moving average of a model's parameters, evaluated instead of
the live ones.

The JAX package keeps a second parameter tree; here the EMA is a copy of the
module whose parameters are buffers (``utils/common.py:momentum_copy``), on
the module's device, updated in place: ``e = e * decay + p * (1 - decay)``.
"""

from __future__ import annotations

from torch import nn

from multimodal_tpu_torch.utils.common import momentum_copy, momentum_update


def init_ema(module: nn.Module) -> nn.Module:
    """An EMA copy of ``module``, equal to it, in eval mode."""
    return momentum_copy(module, device=next(module.parameters()).device)


def update_ema(ema: nn.Module, module: nn.Module, decay: float = 0.999) -> nn.Module:
    """One EMA step of ``ema`` toward ``module``'s parameters, in place;
    returns ``ema``."""
    momentum_update(module, ema, decay)
    return ema
