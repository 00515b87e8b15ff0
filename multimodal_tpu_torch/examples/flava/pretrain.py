"""FLAVA pretraining recipe on one device. Counterpart of
``multimodal_tpu/examples/flava/pretrain.py``.

Config is the JAX recipe's: ``DEFAULTS``, then a YAML file (``--config``),
then dotlist overrides (``utils/config.py``). The model is
``flava_model_for_pretraining`` at ``FLAVA_CONFIGS[model.size]`` plus
``model.overrides``, bf16 compute over fp32 weights when ``model.bf16``;
the optimizer AdamW (weight decay ``train.weight_decay``) under optax's
``warmup_cosine_decay_schedule`` (0 -> ``train.lr`` over
``train.warmup_steps``, cosine to 0 at ``max(train.steps, warmup + 1)``),
the rate of update n being the schedule at n, as in optax. With
``train.pure_bf16`` the weights are bf16 and the optimizer is AnyPrecision
AdamW (bf16 moments, Kahan compensation; the rate of update n is the
schedule at n + 1, as the JAX transform reads it).

Data: with ``data.path`` (a jsonl of {image, text} samples, an image
folder, an arrow dataset, or ``.tar`` shards) the real-data layer: the
two-way FLAVA image transform (encoder view, dVAE codebook view, block
mask: MIM labels; PIL's resampling in C++ on a thread pool), the HashTokenizer (or WordPiece with
``data.vocab_path``), MLM masking and ITM negatives, all six losses.
Each image's crop and mask draw from its batch's RandomState (the JAX
recipe draws them from one running stream and an unseeded generator), so a
resumed run sees the batches the uninterrupted one would have. Without a
path, synthetic batches drawn as the JAX recipe draws them (the same numpy
stream from one seed). ``data.imagenet_path`` (an image folder) and
``data.coco_path`` (a caption dataset) add zero-shot ImageNet and COCO
retrieval evals every ``train.eval_every`` steps and at the end.
``train.checkpoint_dir`` saves the trainer's state every
``train.checkpoint_every`` steps; a run started on a directory that holds a
checkpoint resumes from it and trains the remaining steps, on the batches
the interrupted run would have seen next. ``train.strategy`` is accepted
on one device.

Usage::

    python -m multimodal_tpu_torch.examples.flava.pretrain model.size=base \\
        data.batch_size=64 train.steps=100 data.path=pairs.jsonl
    python -m multimodal_tpu_torch.examples.flava.pretrain --device cpu \\
        --config multimodal_tpu_torch/examples/flava/configs/debug.yaml train.steps=2

Not here yet, each refused with ``NotImplementedError`` naming its queue in
ROADMAP.md: the MoE configs and ``train.ep`` (A4, A7), and more than one
device (A7).
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import zlib
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodal_tpu_torch.models.flava.configs import FLAVA_CONFIGS
from multimodal_tpu_torch.models.flava.model import FLAVAForPreTraining, flava_model_for_pretraining
from multimodal_tpu_torch.modules.optimizers.anyprecision import AnyPrecisionAdamW
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


def synthetic_batches(cfg: Dict[str, Any], start_step: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Random image/text pairs with MLM masking and ITM labels, drawn from
    ``np.random.RandomState(data.seed)`` in the JAX recipe's order, from
    batch ``start_step`` on (the earlier ones are drawn and dropped)."""
    d, m = cfg["data"], cfg["model"]
    rng = np.random.RandomState(d["seed"])
    collator = MLMCollator(
        vocab_size=m["vocab_size"], mask_token_id=103,
        mlm_probability=d["mlm_probability"], special_token_ids=(0, 101, 102),
        ignore_index=-1, rng=rng,
    )
    b, s = d["batch_size"], d["text_len"]
    n = 0
    while True:
        low = min(1000, m["vocab_size"] // 2)
        text = rng.randint(low, m["vocab_size"], (b, s))
        text_masked, mlm_labels = collator(text)
        batch = {
            "image": rng.rand(b, m["image_size"], m["image_size"], 3).astype(np.float32),
            "text": text.astype(np.int32),
            "text_masked": text_masked.astype(np.int32),
            "mlm_labels": mlm_labels.astype(np.int32),
            "itm_labels": rng.randint(0, 2, (b,)).astype(np.int32),
        }
        n += 1
        if n > start_step:
            yield batch


class HashTokenizer:
    """A vocab-free tokenizer: each whitespace word -> a stable id in
    [base, vocab_size) by CRC32, between [CLS] 101 and [SEP] 102, padded
    with 0 to ``max_length``. ``data.vocab_path`` swaps in WordPiece."""

    def __init__(self, vocab_size: int, max_length: int):
        self.max_length = max_length
        self.base = min(1000, max(104, vocab_size // 2))  # ids below are specials
        self.span = vocab_size - self.base
        if self.span < 1:
            raise ValueError(f"vocab_size={vocab_size} too small")

    def __call__(self, texts) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length), np.int64)
        for i, t in enumerate(texts):
            ids = [101] + [self.base + zlib.crc32(w.lower().encode()) % self.span
                           for w in t.split()][: self.max_length - 2] + [102]
            out[i, : len(ids)] = ids
        return out


def build_text_transform(cfg: Dict[str, Any]) -> Callable:
    """texts -> (n, data.text_len) int64 ids: WordPiece over
    ``data.vocab_path`` (padded with its [PAD]) or the HashTokenizer."""
    d, m = cfg["data"], cfg["model"]
    if d["vocab_path"]:
        from multimodal_tpu_torch.examples.mugen.bert_text_transform import BertTextTransform

        bert = BertTextTransform(d["vocab_path"], max_length=d["text_len"])

        def transform(texts):
            ids = np.asarray(bert(list(texts)))
            out = np.full((len(texts), d["text_len"]), bert.pad_id, np.int64)
            out[:, : ids.shape[1]] = ids[:, : d["text_len"]]
            return out

        return transform
    return HashTokenizer(m["vocab_size"], d["text_len"])


def _is_streaming(d: Dict[str, Any]) -> bool:
    """Whether ``data.path`` names ``.tar`` shards: the ``data.streaming``
    flag, a directory holding ``.tar`` files, or a file or glob of them."""
    path = str(d["path"])
    if d.get("streaming") is not None:
        return bool(d["streaming"])
    if os.path.isdir(path):
        return any(f.endswith(".tar") for f in os.listdir(path))
    matches = glob.glob(path) if any(c in path for c in "*?[") else [path]
    return bool(matches) and all(p.endswith(".tar") for p in matches)


def flava_train_transform(cfg: Dict[str, Any]):
    """The recipe's two-way FLAVA transform: the encoder at the model's
    image size, the codebook at 8 pixels a patch-grid cell (the dVAE
    downsamples 8x), 75 of 196 patches masked (scaled to the grid)."""
    from multimodal_tpu_torch.transforms.flava_transform import FLAVAImageTransform

    d, m = cfg["data"], cfg["model"]
    n_patches = m["image_size"] // m["patch_size"]
    mask_patches = max(1, round(75 / 196 * n_patches * n_patches))
    return FLAVAImageTransform(
        is_train=True, encoder_input_size=m["image_size"], codebook_input_size=n_patches * 8,
        mask_window_size=n_patches, mask_num_patches=mask_patches,
        mask_min_patches=min(16, mask_patches), rng=np.random.RandomState(d["seed"]))


def real_batches(cfg: Dict[str, Any], start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of the real-data layer over ``data.path`` from batch
    ``start_step`` on: a ``VLDataModule`` over a jsonl, an image folder or
    an arrow dataset, or a ``StreamingVLDataModule`` over ``.tar`` shards.
    Each image's crop and mask draw from its batch's RandomState, so the
    batches from ``start_step`` on are those of the whole stream."""
    from multimodal_tpu_torch.data.datamodules import VLDataModule
    from multimodal_tpu_torch.data.datasets import load_dataset
    from multimodal_tpu_torch.data.webdataset import StreamingVLDataModule

    d, m = cfg["data"], cfg["model"]
    common = dict(image_transform=flava_train_transform(cfg),
                  text_transform=build_text_transform(cfg),
                  mlm_collator=MLMCollator(
                      vocab_size=m["vocab_size"], mask_token_id=103,
                      mlm_probability=d["mlm_probability"], special_token_ids=(0, 101, 102),
                      ignore_index=-1),
                  itm_probability=d["itm_probability"], batch_size=d["batch_size"],
                  seed=d["seed"])
    if _is_streaming(d):
        dm = StreamingVLDataModule(
            d["path"], shuffle_buffer=d.get("shuffle_buffer", 1000), **common)
    else:
        dm = VLDataModule(load_dataset(d["path"], split="train"), image_key=d["image_key"],
                          text_key=d["text_key"], **common)
    return dm.train_batches(start_step=start_step)


def flava_eval_image_transform(cfg: Dict[str, Any]) -> Callable:
    """image -> the encoder view of the FLAVA eval transform (resize, no
    crop), as the JAX evals build it."""
    from multimodal_tpu_torch.data.datamodules import _to_image
    from multimodal_tpu_torch.transforms.flava_transform import FLAVAImageTransform

    t = FLAVAImageTransform(is_train=False, encoder_input_size=cfg["model"]["image_size"],
                            codebook_input_size=8, mask_num_patches=1, mask_window_size=1,
                            mask_min_patches=1)
    return lambda img: t.transform(_to_image(img))["image"]


def _encoders(model: FLAVAForPreTraining):
    """The contrastive projections of a batch on the model's device."""
    dev = next(model.parameters()).device

    def encode_image(images):
        return model.encode_image(torch.as_tensor(images).to(dev))

    def encode_text(tokens):
        return model.encode_text(torch.as_tensor(tokens).to(dev))

    return encode_image, encode_text


def build_zero_shot_eval(cfg: Dict[str, Any]) -> Callable[[FLAVAForPreTraining], Dict[str, float]]:
    """``eval_fn(model)`` for ``Trainer.fit``: ImageNet zero-shot top-1 and
    top-5 over ``data.imagenet_path`` (its ``val`` split when it has one)
    with the class names x templates protocol; the class names are the
    folder's when it has them, else ImageNet's 1,000."""
    from multimodal_tpu_torch.data.datamodules import ImageDataModule
    from multimodal_tpu_torch.data.datasets import load_dataset
    from multimodal_tpu_torch.data.imagenet_zeroshot import (
        imagenet_classnames,
        imagenet_templates,
        imagenet_zero_shot_eval,
    )

    d = cfg["data"]
    dataset = load_dataset(d["imagenet_path"], split="val")
    if len(dataset) and isinstance(dataset[0], dict) and "classname" in dataset[0]:
        classnames = sorted({dataset[i]["classname"] for i in range(len(dataset))})
    else:
        classnames = imagenet_classnames()
    templates = imagenet_templates()
    if d["zero_shot_templates"]:
        templates = templates[: d["zero_shot_templates"]]
    transform = flava_eval_image_transform(cfg)
    dm = ImageDataModule(dataset, image_transform=lambda img: {"image": transform(img)},
                         batch_size=d["eval_batch_size"], shuffle=False, drop_last=False,
                         prefetch=0)
    tokenize = build_text_transform(cfg)

    def eval_fn(model):
        encode_image, encode_text = _encoders(model)
        return imagenet_zero_shot_eval(encode_image, encode_text, tokenize, dm.eval_batches(),
                                       classnames=classnames, templates=templates)

    return eval_fn


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

    def state_dict(self):
        sd = super().state_dict()
        sd["updates"] = self.updates
        return sd

    def load_state_dict(self, state_dict):
        self.updates = int(state_dict["updates"])
        super().load_state_dict(state_dict)

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
    t = cfg["train"]
    multi_device = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    for on, what, queue in (
        (_model_kwargs(cfg).get("moe_num_experts") or int(t["ep"]) > 1,
         "MoE FLAVA (the MoE configs, train.ep)", "A4 and A7"),
        (multi_device, f"train.strategy={t['strategy']} over more than one device", "A7"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue {queue})")


def build_model(cfg: Dict[str, Any], device=None, seed: int = 0) -> FLAVAForPreTraining:
    """The recipe's model: bf16 weights under ``train.pure_bf16``, fp32
    otherwise (LayerNorms and the logit scale fp32 either way)."""
    m = cfg["model"]
    return flava_model_for_pretraining(
        device=device, dtype=torch.bfloat16 if m["bf16"] else torch.float32,
        param_dtype=torch.bfloat16 if cfg["train"]["pure_bf16"] else torch.float32,
        seed=seed, vocab_size=m["vocab_size"], image_size=m["image_size"],
        patch_size=m["patch_size"], **_model_kwargs(cfg))


def loss_fn(model: FLAVAForPreTraining, batch: Dict[str, torch.Tensor]):
    """The total of the pretraining losses, and each loss as a metric. An
    image-text batch gives ITM, MMM (text, and image with codebook labels)
    and the contrastive loss; an image-only batch (``image``,
    ``image_for_codebook``, ``image_patches_mask``) MIM; a text-only batch
    (``text``, ``text_masked``, ``mlm_labels``) MLM."""
    out = model(**{k: batch.get(k) for k in (
        "image", "text", "text_masked", "itm_labels", "mlm_labels", "image_for_codebook",
        "image_patches_mask")})
    losses = out.losses
    aux = {k: v.detach() for k, v in losses._asdict().items() if v is not None}
    return losses.total(), aux


def build_trainer_and_state(cfg: Dict[str, Any], device=None,
                            model: Optional[FLAVAForPreTraining] = None):
    """The recipe's ``Trainer`` and model (the model is the state: the
    trainer updates it in place), restored from ``train.checkpoint_dir``
    when it holds a checkpoint. ``model`` defaults to ``build_model(cfg,
    device)``; the trainer runs on the model's device."""
    _refuse(cfg)
    t = cfg["train"]
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    schedule = warmup_cosine_decay_schedule(
        0.0, t["lr"], t["warmup_steps"], max(t["steps"], t["warmup_steps"] + 1))
    if t["pure_bf16"]:
        opt = AnyPrecisionAdamW(model.parameters(), lr=schedule, weight_decay=t["weight_decay"],
                                use_kahan_summation=True, momentum_dtype=torch.bfloat16)
    else:
        opt = ScheduledAdamW(model.parameters(), schedule, weight_decay=t["weight_decay"],
                             fused=dev.type == "cuda")
    trainer = Trainer(loss_fn, opt, device=dev, log_dir=t["log_dir"],
                      log_interval=t["log_interval"],
                      skip_nonfinite_updates=t["skip_nonfinite_updates"],
                      grad_accum_steps=t["grad_accum_steps"],
                      checkpoint_dir=t["checkpoint_dir"])
    return trainer, trainer.restore_or_init(model)


def build_eval(cfg: Dict[str, Any]) -> Optional[Callable[[FLAVAForPreTraining], Dict[str, float]]]:
    """The evals the config asks for (ImageNet zero-shot, COCO retrieval)
    as one ``eval_fn``, or None."""
    fns = []
    if cfg["data"]["imagenet_path"]:
        fns.append(build_zero_shot_eval(cfg))
    if cfg["data"].get("coco_path"):
        from multimodal_tpu_torch.examples.flava.coco_zero_shot import build_coco_eval

        fns.append(build_coco_eval(cfg))
    if not fns:
        return None

    def eval_fn(model):
        merged: Dict[str, float] = {}
        for fn in fns:
            merged.update(fn(model))
        return merged

    return eval_fn


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
    t = cfg["train"]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model={cfg['model']['size']} params={n_params / 1e6:.1f}M devices=1 "
          f"({trainer.device}) strategy={t['strategy']}", flush=True)
    start = trainer.step
    data = (real_batches(cfg, start_step=start) if cfg["data"]["path"]
            else synthetic_batches(cfg, start_step=start))
    # a resumed run trains the remaining steps, so the schedule ends where
    # the uninterrupted run's does
    trainer.fit(model, data, num_steps=max(0, int(t["steps"]) - start),
                eval_fn=build_eval(cfg), eval_every=t["eval_every"],
                checkpoint_every=t["checkpoint_every"])
    print(f"finished at step {trainer.step}", flush=True)
    return model, trainer


if __name__ == "__main__":
    main()
