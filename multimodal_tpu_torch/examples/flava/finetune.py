"""FLAVA classification finetuning recipe on one device. Counterpart of
``multimodal_tpu/examples/flava/finetune.py``.

Multimodal (image + text) classification with a fresh MLP head over the
multimodal CLS token (``flava_model_for_classification``), AdamW at a
constant rate, the port's ``Trainer``; config as the pretraining recipe's
(``DEFAULTS``, a YAML file, dotlist overrides). Synthetic batches unless
``data.path`` names a labelled dataset ({image, text, label} samples),
which goes through ``ClassificationVLDataModule`` (the FLAVA train
transform's encoder view, the recipe's tokenizer, the label). With
``train.checkpoint_dir`` the trainer's state is saved every
``train.checkpoint_every`` steps and after the last one, and a run started
on a directory with a checkpoint resumes from it and trains the remaining
steps.

    python -m multimodal_tpu_torch.examples.flava.finetune data.path=memes.jsonl \\
        train.steps=100 train.checkpoint_dir=ckpt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from multimodal_tpu_torch.data.datamodules import VLDataModule
from multimodal_tpu_torch.examples.flava.pretrain import build_text_transform
from multimodal_tpu_torch.models.flava.configs import FLAVA_CONFIGS
from multimodal_tpu_torch.models.flava.model import (
    FLAVAForClassification,
    flava_model_for_classification,
)
from multimodal_tpu_torch.training.trainer import Trainer
from multimodal_tpu_torch.utils.config import build_config

DEFAULTS: Dict[str, Any] = {
    "model": {
        "size": "base",
        "num_classes": 2,
        "vocab_size": 30522,
        "image_size": 224,
        "patch_size": 16,
        "overrides": {},
    },
    "data": {
        "batch_size": 8, "text_len": 77, "seed": 0,
        "path": None,
        "image_key": "image",
        "text_key": "text",
        "label_key": "label",
        "vocab_path": None,
    },
    "train": {"steps": 10, "lr": 1e-4, "weight_decay": 0.1, "strategy": "fsdp",
              "log_dir": None, "log_interval": 1, "checkpoint_dir": None,
              "checkpoint_every": None},
}


def synthetic_batches(cfg: Dict[str, Any], start_step: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX recipe's synthetic batches, from batch ``start_step`` on."""
    d, m = cfg["data"], cfg["model"]
    rng = np.random.RandomState(d["seed"])
    b, s = d["batch_size"], d["text_len"]
    n = 0
    while True:
        batch = {
            "image": rng.rand(b, m["image_size"], m["image_size"], 3).astype(np.float32),
            "text": rng.randint(1, m["vocab_size"], (b, s)).astype(np.int32),
            "labels": rng.randint(0, m["num_classes"], (b,)).astype(np.int32),
        }
        n += 1
        if n > start_step:
            yield batch


class ClassificationVLDataModule(VLDataModule):
    """``VLDataModule`` (no ITM, no MLM) that passes each sample's label on
    as ``labels``."""

    def __init__(self, dataset, label_key: str = "label", **kwargs):
        super().__init__(dataset, **kwargs)
        self.label_key = label_key

    def process(self, sample, rng):
        out = super().process(sample, rng)
        out["labels"] = np.asarray(sample[self.label_key], np.int32)
        return out


def real_batches(cfg: Dict[str, Any], start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Labelled image + text batches over ``data.path`` from batch
    ``start_step`` on; each image's crop draws from its batch's
    RandomState."""
    from multimodal_tpu_torch.data.datasets import load_dataset
    from multimodal_tpu_torch.transforms.flava_transform import FLAVAImageTransform

    d, m = cfg["data"], cfg["model"]
    transform = FLAVAImageTransform(
        is_train=True, encoder_input_size=m["image_size"], codebook_input_size=8,
        mask_num_patches=1, mask_window_size=1, mask_min_patches=1,
        rng=np.random.RandomState(d["seed"]))
    dm = ClassificationVLDataModule(
        load_dataset(d["path"], split="train"), image_transform=transform,
        text_transform=build_text_transform(cfg), mlm_collator=None, itm_probability=0.0,
        image_key=d["image_key"], text_key=d["text_key"], label_key=d["label_key"],
        batch_size=d["batch_size"], seed=d["seed"])
    unused = ("image_for_codebook", "image_patches_mask")
    return ({k: v for k, v in b.items() if k not in unused}
            for b in dm.train_batches(start_step=start_step))


def build_model(cfg: Dict[str, Any], device=None, seed: int = 0) -> FLAVAForClassification:
    m = cfg["model"]
    kwargs = dict(FLAVA_CONFIGS[m["size"]])
    kwargs.update(m["overrides"])
    hidden = kwargs.get("multimodal_hidden_size", 768)
    return flava_model_for_classification(
        num_classes=m["num_classes"], classifier_in_dim=hidden,
        classifier_hidden_sizes=hidden, device=device, seed=seed,
        vocab_size=m["vocab_size"], image_size=m["image_size"], patch_size=m["patch_size"],
        **kwargs)


def loss_fn(model: FLAVAForClassification, batch: Dict[str, torch.Tensor]):
    out = model(image=batch["image"], text=batch["text"], labels=batch["labels"])
    acc = (out.logits.argmax(-1) == batch["labels"]).float().mean()
    return out.loss, {"accuracy": acc.detach()}


def build_trainer_and_state(cfg: Dict[str, Any], device=None,
                            model: Optional[FLAVAForClassification] = None):
    """The recipe's ``Trainer`` and model, restored from
    ``train.checkpoint_dir`` when it holds a checkpoint."""
    t = cfg["train"]
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=t["lr"], weight_decay=t["weight_decay"],
                            fused=dev.type == "cuda")
    trainer = Trainer(loss_fn, opt, device=dev, log_dir=t["log_dir"],
                      log_interval=t["log_interval"], checkpoint_dir=t["checkpoint_dir"])
    return trainer, trainer.restore_or_init(model)


def main(argv=None):
    """Finetune as the JAX recipe's ``main`` does, on one device; returns
    the model and its ``Trainer``."""
    parser = argparse.ArgumentParser(description="FLAVA classification finetuning")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="default CUDA; 'cpu' runs the kernels' plain versions")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = build_config(args.config, args.overrides, defaults=DEFAULTS)

    trainer, model = build_trainer_and_state(cfg, device=args.device)
    t = cfg["train"]
    start = trainer.step
    data = (real_batches(cfg, start_step=start) if cfg["data"]["path"]
            else synthetic_batches(cfg, start_step=start))
    trainer.fit(model, data, num_steps=max(0, int(t["steps"]) - start),
                checkpoint_every=t["checkpoint_every"])
    if trainer.ckpt is not None and trainer.ckpt.latest_step() != trainer.step:
        trainer.save(model)
    print(f"finished at step {trainer.step}", flush=True)
    return model, trainer


if __name__ == "__main__":
    main()
