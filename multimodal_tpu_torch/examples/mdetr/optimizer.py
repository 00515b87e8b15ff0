"""MDETR's three-group AdamW and its learning-rate schedules. Counterpart
of ``multimodal_tpu/examples/mdetr/optimizer.py``: the JAX package's
``optax.multi_transform`` over parameter-path labels is
``torch.optim.AdamW`` with one parameter group a label, and each group's
``step -> lr`` schedule a ``LambdaLR`` factor (each group's base rate 1).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

GROUPS = ("rest", "backbone", "text_encoder")


def mdetr_param_label(name: str) -> str:
    """'backbone' / 'text_encoder' / 'rest' by the parameter's name, as the
    JAX labels go by path."""
    if "backbone" in name:
        return "backbone"
    if "text_encoder" in name:
        return "text_encoder"
    return "rest"


def mdetr_param_labels(model: nn.Module) -> Dict[str, str]:
    return {name: mdetr_param_label(name) for name, _ in model.named_parameters()}


class MDETRSchedules(NamedTuple):
    rest: Callable[[int], float]          # transformer + heads ("lr")
    backbone: Callable[[int], float]      # "lr_backbone"
    text_encoder: Callable[[int], float]  # "text_encoder_lr"


def mdetr_lr_schedules(
    schedule: str,
    lr: float,
    lr_backbone: float,
    text_encoder_lr: float,
    num_training_steps: int,
    steps_per_epoch: int,
    lr_drop: int,
    epochs: int,
    fraction_warmup_steps: float = 0.01,
) -> MDETRSchedules:
    """Each group's ``step -> lr`` for the four schedules: ``step`` (every
    rate times ``0.1 ** (epoch // lr_drop)``), ``multistep`` (halved at
    ``lr_drop``, then every 50 epochs), ``linear_with_warmup`` (step decay
    for the backbone and the rest; the text encoder warms up linearly, then
    decays linearly to 0) and ``all_linear_with_warmup`` (that for all)."""
    num_warmup = round(fraction_warmup_steps * num_training_steps)
    milestones = list(range(lr_drop, epochs, 50))

    def step_gamma(step: int) -> float:
        return 0.1 ** ((step // steps_per_epoch) // lr_drop)

    def multistep_gamma(step: int) -> float:
        epoch = step // steps_per_epoch
        return 0.5 ** sum(epoch >= m for m in milestones)

    def linear_gamma(step: int) -> float:
        if step < num_warmup:
            return step / max(1, num_warmup)
        return max(0.0, (num_training_steps - step) / max(1, num_training_steps - num_warmup))

    gammas = {"step": (step_gamma, step_gamma), "multistep": (multistep_gamma, multistep_gamma),
              "linear_with_warmup": (step_gamma, linear_gamma),
              "all_linear_with_warmup": (linear_gamma, linear_gamma)}
    if schedule not in gammas:
        raise NotImplementedError(f"unknown schedule {schedule}")
    g, tg = gammas[schedule]
    return MDETRSchedules(rest=lambda step: lr * g(step),
                          backbone=lambda step: lr_backbone * g(step),
                          text_encoder=lambda step: text_encoder_lr * tg(step))


def build_mdetr_optimizer(
    model: nn.Module,
    schedules: MDETRSchedules,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``model``'s parameters in the groups ``GROUPS`` (a group
    with no parameter is left out), and the ``LambdaLR`` that sets each
    group's rate to its schedule: step it after each optimizer step. The
    update is optax's ``scale_by_adam``, ``add_decayed_weights`` and
    ``scale_by_schedule(-lr)`` in that order."""
    params: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        params[mdetr_param_label(name)].append(p)
    names = [g for g in GROUPS if params[g]]
    dev = next(model.parameters()).device
    opt = torch.optim.AdamW([{"params": params[g], "lr": 1.0, "name": g} for g in names],
                            betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                            fused=dev.type == "cuda")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, [getattr(schedules, g) for g in names])
    return opt, sched
