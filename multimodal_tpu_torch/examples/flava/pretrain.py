"""FLAVA pretraining recipe on one device. Counterpart of
``multimodal_tpu/examples/flava/pretrain.py``.

Config is the JAX recipe's: ``DEFAULTS``, then a YAML file (``--config``),
then dotlist overrides (``utils/config.py``). The model is
``flava_model_for_pretraining`` at ``FLAVA_CONFIGS[model.size]`` plus
``model.overrides``, bf16 compute over fp32 weights when ``model.bf16``;
the optimizer AdamW (weight decay ``train.weight_decay``) under optax's
``warmup_cosine_decay_schedule`` (0 -> ``train.lr`` over
``train.warmup_steps``, cosine to 0 at ``max(train.steps, warmup + 1)``),
the rate of update n being the schedule at n, as in optax. It trains
through the port's single-device ``Trainer`` on synthetic image/text
batches drawn as the JAX recipe draws them (the same numpy stream from one
seed). ``train.strategy`` is accepted on one device.

Usage::

    python -m multimodal_tpu_torch.examples.flava.pretrain model.size=base \\
        data.batch_size=64 train.steps=100
    python -m multimodal_tpu_torch.examples.flava.pretrain --device cpu \\
        --config multimodal_tpu_torch/examples/flava/configs/debug.yaml train.steps=2

Not here yet, each refused with ``NotImplementedError`` naming its queue in
ROADMAP.md: ``data.path`` (the real-data layer, A3), ``data.imagenet_path``
/ ``data.coco_path`` / ``train.eval_every`` (zero-shot eval needs the
``ImageDataModule`` of ``data.imagenet_path`` and ``coco_zero_shot``, A3;
the tokenizers and the ImageNet protocol are ported), ``train.pure_bf16``
(AnyPrecision AdamW, A3), the MoE
configs and ``train.ep`` (A4, A7), ``train.checkpoint_dir`` (A8), and more
than one device (A7).
"""

from __future__ import annotations

import argparse
import math
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodal_tpu_torch.models.flava.configs import FLAVA_CONFIGS
from multimodal_tpu_torch.models.flava.model import FLAVAForPreTraining, flava_model_for_pretraining
from multimodal_tpu_torch.training.mlm_collator import MLMCollator
from multimodal_tpu_torch.training.trainer import Trainer
from multimodal_tpu_torch.utils.config import build_config

DEFAULTS: Dict[str, Any] = {
    "model": {
        "size": "base",          # key into FLAVA_CONFIGS
        "vocab_size": 30522,
        "image_size": 224,
        "patch_size": 16,
        "bf16": True,
        "overrides": {},         # extra flava_model kwargs (debug scale-downs)
    },
    "data": {
        "path": None,
        "image_key": "image",
        "text_key": "text",
        "vocab_path": None,
        "itm_probability": 0.1,
        "batch_size": 8,
        "text_len": 77,
        "mlm_probability": 0.15,
        "seed": 0,
        "imagenet_path": None,
        "coco_path": None,
        "eval_batch_size": 64,
        "zero_shot_templates": None,
    },
    "train": {
        "steps": 10,
        "lr": 1e-3,
        "warmup_steps": 2,
        "weight_decay": 0.1,
        "strategy": "fsdp",
        "pure_bf16": False,
        "ep": 1,
        "grad_accum_steps": 1,
        "skip_nonfinite_updates": True,
        "checkpoint_dir": None,
        "checkpoint_every": None,
        "eval_every": None,
        "log_dir": None,
        "log_interval": 1,
    },
}


def synthetic_batches(cfg: Dict[str, Any]) -> Iterator[Dict[str, np.ndarray]]:
    """Random image/text pairs with MLM masking and ITM labels, drawn from
    ``np.random.RandomState(data.seed)`` in the JAX recipe's order."""
    d, m = cfg["data"], cfg["model"]
    rng = np.random.RandomState(d["seed"])
    collator = MLMCollator(
        vocab_size=m["vocab_size"], mask_token_id=103,
        mlm_probability=d["mlm_probability"], special_token_ids=(0, 101, 102),
        ignore_index=-1, rng=rng,
    )
    b, s = d["batch_size"], d["text_len"]
    while True:
        low = min(1000, m["vocab_size"] // 2)
        text = rng.randint(low, m["vocab_size"], (b, s))
        text_masked, mlm_labels = collator(text)
        yield {
            "image": rng.rand(b, m["image_size"], m["image_size"], 3).astype(np.float32),
            "text": text.astype(np.int32),
            "text_masked": text_masked.astype(np.int32),
            "mlm_labels": mlm_labels.astype(np.int32),
            "itm_labels": rng.randint(0, 2, (b,)).astype(np.int32),
        }


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span)) + alpha)

    return schedule


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose learning rate at update n is ``schedule(n)``, n counting
    from 0, as optax's ``scale_by_schedule`` reads its count before the
    update (``optax.adamw(schedule, weight_decay)``)."""

    def __init__(self, params, schedule: Callable[[int], float], **kwargs):
        super().__init__(params, lr=schedule(0), **kwargs)
        self.schedule = schedule
        self.updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.updates)
        for group in self.param_groups:
            group["lr"] = lr
        self.updates += 1
        return super().step(closure)


def _model_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    kwargs = dict(FLAVA_CONFIGS[cfg["model"]["size"]])
    kwargs.update(cfg["model"]["overrides"])
    return kwargs


def _refuse(cfg: Dict[str, Any]) -> None:
    d, t = cfg["data"], cfg["train"]
    multi_device = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    for on, what, queue in (
        (d["path"], "data.path (the real-data layer)", "A3"),
        (d["imagenet_path"] or d["coco_path"] or t["eval_every"],
         "zero-shot eval (data.imagenet_path, data.coco_path, train.eval_every), which needs "
         "data.imagenet_path's ImageDataModule and coco_zero_shot,", "A3"),
        (t["pure_bf16"], "train.pure_bf16 (AnyPrecision AdamW)", "A3"),
        (_model_kwargs(cfg).get("moe_num_experts") or int(t["ep"]) > 1,
         "MoE FLAVA (the MoE configs, train.ep)", "A4 and A7"),
        (t["checkpoint_dir"], "train.checkpoint_dir", "A8"),
        (multi_device, f"train.strategy={t['strategy']} over more than one device", "A7"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue {queue})")


def build_model(cfg: Dict[str, Any], device=None, seed: int = 0) -> FLAVAForPreTraining:
    m = cfg["model"]
    return flava_model_for_pretraining(
        device=device, dtype=torch.bfloat16 if m["bf16"] else torch.float32,
        param_dtype=torch.float32, seed=seed, vocab_size=m["vocab_size"],
        image_size=m["image_size"], patch_size=m["patch_size"], **_model_kwargs(cfg))


def loss_fn(model: FLAVAForPreTraining, batch: Dict[str, torch.Tensor]):
    """The total of the pretraining losses, and each loss as a metric."""
    out = model(image=batch["image"], text=batch["text"], text_masked=batch["text_masked"],
                itm_labels=batch["itm_labels"], mlm_labels=batch["mlm_labels"],
                image_for_codebook=batch.get("image_for_codebook"),
                image_patches_mask=batch.get("image_patches_mask"))
    losses = out.losses
    aux = {k: v.detach() for k, v in losses._asdict().items() if v is not None}
    return losses.total(), aux


def build_trainer_and_state(cfg: Dict[str, Any], device=None,
                            model: Optional[FLAVAForPreTraining] = None):
    """The recipe's ``Trainer`` and model (the model is the state: the
    trainer updates it in place). ``model`` defaults to ``build_model(cfg,
    device)``; the trainer runs on the model's device."""
    _refuse(cfg)
    t = cfg["train"]
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    schedule = warmup_cosine_decay_schedule(
        0.0, t["lr"], t["warmup_steps"], max(t["steps"], t["warmup_steps"] + 1))
    opt = ScheduledAdamW(model.parameters(), schedule, weight_decay=t["weight_decay"],
                         fused=dev.type == "cuda")
    trainer = Trainer(loss_fn, opt, device=dev, log_dir=t["log_dir"],
                      log_interval=t["log_interval"],
                      skip_nonfinite_updates=t["skip_nonfinite_updates"],
                      grad_accum_steps=t["grad_accum_steps"])
    return trainer, model


def main(argv=None):
    """Train as the JAX recipe's ``main`` does, on one device; returns the
    model and its ``Trainer`` (whose logger holds the metrics)."""
    parser = argparse.ArgumentParser(description="FLAVA pretraining")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--device", default=None,
                        help="default CUDA; 'cpu' runs the kernels' plain versions")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides a.b=c")
    args = parser.parse_args(argv)
    cfg = build_config(args.config, args.overrides, defaults=DEFAULTS)

    trainer, model = build_trainer_and_state(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model={cfg['model']['size']} params={n_params / 1e6:.1f}M devices=1 "
          f"({trainer.device}) strategy={cfg['train']['strategy']}", flush=True)
    trainer.fit(model, synthetic_batches(cfg), num_steps=int(cfg["train"]["steps"]))
    print(f"finished at step {trainer.step}", flush=True)
    return model, trainer


if __name__ == "__main__":
    main()
