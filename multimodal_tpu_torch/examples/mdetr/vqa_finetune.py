"""MDETR VQA (GQA) fine-tuning and evaluation. Counterpart of
``multimodal_tpu/examples/mdetr/vqa_finetune.py``.

The objective is the detection loss (Hungarian match, then the soft-token
and L1 / GIoU box terms) plus the six GQA answer heads' cross entropies,
each gated by its answer-type mask, optimized by MDETR's three-group AdamW
(backbone / text encoder / the rest, ``examples/mdetr/optimizer.py``)
through ``training/trainer.py``, with an EMA of the parameters
(``training/ema.py``). The model runs deterministic (no dropout), as the
JAX loss does.

The EMA keeps the JAX recipe's contract exactly: training runs in chunks of
``min(16, num_steps)`` steps, and after each chunk the EMA takes as many
updates as the chunk had steps, all toward the chunk's final parameters.
That is not the per-step EMA of the reference's loop; it is the JAX
package's result, and this recipe reproduces it (ROADMAP.md, section C).

Batch format (host arrays or tensors): ``images`` (b, H, W, 3) float,
``image_mask`` (b, H, W) bool (True = padding), ``text`` (b, T) int,
``text_attention_mask`` (b, T) bool (True = padded), ``positive_map`` (b,
max_boxes, num_classes + 1), ``target_boxes`` (b, max_boxes, 4) cxcywh,
``valid`` (b, max_boxes) bool, ``answers[k]`` (b,) int per head and
``answer_type_mask[k]`` (b,) bool per head.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from multimodal_tpu_torch.data.device_prefetch import to_device
from multimodal_tpu_torch.examples.mdetr.optimizer import (
    build_mdetr_optimizer,
    mdetr_lr_schedules,
)
from multimodal_tpu_torch.modules.losses.mdetr import (
    build_weight_dict,
    masked_dict_accuracy,
    masked_dict_cross_entropy,
    mdetr_loss,
)
from multimodal_tpu_torch.training.ema import init_ema, update_ema
from multimodal_tpu_torch.training.trainer import Trainer

VQA_KEYS = ("answer_type", "answer_obj", "answer_rel", "answer_attr", "answer_cat",
            "answer_global")


def _inputs(batch: Dict[str, Any]):
    return (batch["images"], batch["image_mask"], batch["text"], batch["text_attention_mask"])


def vqa_loss_fn(weight_dict: Optional[Dict[str, float]] = None) -> Callable:
    """The trainer's ``(model, batch) -> (loss, aux)``: the detection terms
    weighted by ``weight_dict`` (default: MDETR's, without the contrastive
    term) plus the answer heads' cross entropies."""
    weights = weight_dict or build_weight_dict(vqa_keys=VQA_KEYS, include_contrastive_loss=False)

    def loss_fn(model: nn.Module, batch: Dict[str, Any]):
        out = model(*_inputs(batch))
        det = mdetr_loss(out.model_output.pred_logits, out.model_output.pred_boxes,
                         batch["positive_map"], batch["target_boxes"], batch["valid"])
        qa = masked_dict_cross_entropy(out.vqa_preds, batch["answers"],
                                       batch.get("answer_type_mask"))
        total = det.total(weights)
        for name, value in qa.items():
            total = total + weights.get(name, 1.0) * value
        acc = masked_dict_accuracy(out.vqa_preds, batch["answers"],
                                   batch.get("answer_type_mask"))
        aux = {"soft_token_loss": det.soft_token_loss, "l1_loss": det.l1_loss,
               "giou_loss": det.giou_loss, **qa,
               "answer_total_accuracy": acc["answer_total_accuracy"]}
        return total, {k: v.detach() for k, v in aux.items()}

    return loss_fn


def build_vqa_optimizer(
    model: nn.Module,
    num_training_steps: int,
    steps_per_epoch: int,
    lr: float = 5e-5,
    lr_backbone: float = 5e-6,
    text_encoder_lr: float = 5e-6,
    schedule: str = "linear_with_warmup",
    epochs: int = 25,
    lr_drop: int = 10,
    weight_decay: float = 1e-4,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """The per-group AdamW of the reference's VQA run (25 epochs, lr_drop
    10, ``linear_with_warmup``) and its schedule: step the schedule after
    each optimizer step."""
    schedules = mdetr_lr_schedules(schedule=schedule, lr=lr, lr_backbone=lr_backbone,
                                   text_encoder_lr=text_encoder_lr,
                                   num_training_steps=num_training_steps,
                                   steps_per_epoch=steps_per_epoch, lr_drop=lr_drop,
                                   epochs=epochs)
    return build_mdetr_optimizer(model, schedules, weight_decay=weight_decay)


def finetune_vqa(
    model: nn.Module,
    batches: Iterable[Dict[str, Any]],
    num_steps: int,
    steps_per_epoch: Optional[int] = None,
    ema_decay: Optional[float] = 0.9998,
    trainer_kwargs: Optional[Dict[str, Any]] = None,
    **optimizer_kwargs: Any,
) -> Tuple[nn.Module, Optional[nn.Module]]:
    """Fine-tune ``model`` in place for ``num_steps`` batches on its device;
    returns the model and its EMA copy (None without ``ema_decay``)."""
    opt, sched = build_vqa_optimizer(model, num_training_steps=num_steps,
                                     steps_per_epoch=steps_per_epoch or num_steps,
                                     **optimizer_kwargs)
    opt.register_step_post_hook(lambda *_: sched.step())
    device = next(model.parameters()).device
    trainer = Trainer(vqa_loss_fn(), opt, device=device, **(trainer_kwargs or {}))
    model = trainer.restore_or_init(model)
    ema = init_ema(model) if ema_decay else None
    data_iter = iter(batches)
    chunk = max(1, min(16, num_steps))
    done = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        trainer.fit(model, data_iter, num_steps=n)
        if ema is not None:
            for _ in range(n):
                update_ema(ema, model, ema_decay)
        done += n
    model.eval()
    return model, ema


@torch.no_grad()
def evaluate_vqa(model: nn.Module, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    """GQA accuracy: each head's masked accuracy and the combined
    ``answer_total_accuracy``, weighted over the stream by each head's
    active samples (the combined one by batch size)."""
    device = next(model.parameters()).device
    sums: Dict[str, float] = {}
    weights: Dict[str, float] = {}
    for batch in batches:
        batch = to_device(batch, device)
        preds = model(*_inputs(batch)).vqa_preds
        masks = batch.get("answer_type_mask") or {}
        acc = masked_dict_accuracy(preds, batch["answers"], masks or None)
        bsz = next(iter(batch["answers"].values())).shape[0]
        for k, v in acc.items():
            mask = masks.get(k.replace("_accuracy", ""))
            w = float(mask.sum()) if mask is not None else float(bsz)
            if k == "answer_total_accuracy":
                w = float(bsz)
            sums[k] = sums.get(k, 0.0) + float(v) * w
            weights[k] = weights.get(k, 0.0) + w
    return {k: sums[k] / max(weights[k], 1.0) for k in sums}
