"""ALBEF fine-tuning schedules. Counterpart of
``multimodal_tpu/examples/albef/recipes.py`` (``albef_alpha_schedule``,
``albef_cosine_lr``), as plain Python on floats.

- The distillation weight ``alpha`` ramps linearly from 0 over epoch 0,
  then stays.
- The learning rate follows ``CosineAnnealingWarmRestarts(T_0=max_epochs,
  eta_min)`` as the reference's loop steps it: in epoch 0 to ``batch //
  step_size`` while ``batch <= warmup_steps * step_size``, from epoch 1 once
  an epoch to ``epoch + warmup_steps``.
"""

from __future__ import annotations

import math


def albef_alpha_schedule(epoch: int, batch: int, batches_per_epoch: int,
                         alpha: float = 0.4) -> float:
    """Distillation weight: linear 0 -> ``alpha`` over epoch 0, then
    ``alpha``."""
    if epoch > 0:
        return alpha
    return alpha * min(1.0, batch / batches_per_epoch)


def albef_cosine_lr(epoch: int, batch: int, lr: float = 1e-5, min_lr: float = 1e-6,
                    max_epochs: int = 6, warmup_steps: int = 1, step_size: int = 100) -> float:
    """The learning rate at (epoch, batch) under the reference's stepping."""
    warmup_iterations = warmup_steps * step_size
    if epoch > 0:
        t_cur = epoch + warmup_steps
    else:
        t_cur = min(batch // step_size, warmup_iterations // step_size)
    cos = (1.0 + math.cos(math.pi * (t_cur % max_epochs) / max_epochs)) / 2.0
    return min_lr + (lr - min_lr) * cos
