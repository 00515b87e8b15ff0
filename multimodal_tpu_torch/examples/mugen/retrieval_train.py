"""MUGEN VideoCLIP retrieval training. Counterpart of
``multimodal_tpu/examples/mugen/retrieval_train.py``.

The S3D-video x DistilBERT-text towers train with a learnable-temperature
contrastive loss (logit scale 0.07, at most 100: the JAX module's MUGEN
defaults, raw values of the log scale), AdamW (lr 1e-3, weight decay 1e-3)
over both towers and the temperature in one step; validation reports
Recall@{1,5,10} both ways over the val split. One device: the port's
``Trainer``, ``MUGENDataModule`` and ``training/retrieval_eval.py``.
S3D's BatchNorm statistics are buffers that the training-mode forward
updates in place (the JAX recipe's ``mutable_state`` channel).
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_tpu_torch.examples.mugen.bert_text_transform import BertTextTransform
from multimodal_tpu_torch.examples.mugen.data import MUGENDataModule
from multimodal_tpu_torch.examples.mugen.video_clip import TextEncoder, VideoEncoder
from multimodal_tpu_torch.models.clip.model import _l2_normalize
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
    ContrastiveLossWithTemperature,
)
from multimodal_tpu_torch.training.retrieval_eval import retrieval_recall_at_k
from multimodal_tpu_torch.training.trainer import Trainer
from multimodal_tpu_torch.utils.config import build_config
from multimodal_tpu_torch.utils.device import resolve_device
from multimodal_tpu_torch.utils.init import init_parameters_

# Copy of the JAX recipe's DEFAULTS.
DEFAULTS: Dict[str, Any] = {
    "model": {
        "video_proj_out": 256,
        "text_proj_out": 256,
        "vocab_size": 30522,
        "bf16": False,
        "logit_scale": 0.07,
        "logit_scale_max": 100.0,
    },
    "data": {
        "path": None,              # dir with {split}.json release metadata
        "frames_dir": None,        # {id}.npy pre-rendered clips
        "vocab_path": None,        # WordPiece vocab; tiny hash fallback if None
        "sequence_length": 32,
        "sample_every_n_frames": 3,
        "text_len": 32,
        "batch_size": 16,
        "eval_batch_size": 16,
        "seed": 0,
    },
    "train": {
        "steps": 1000,
        "lr": 1e-3,
        "weight_decay": 1e-3,
        "strategy": "fsdp",
        "checkpoint_dir": None,
        "checkpoint_every": None,
        "eval_every": None,
        "log_dir": None,
        "log_interval": 10,
    },
}


class VideoCLIPForRetrieval(nn.Module):
    """VideoCLIP towers (``encoder_a`` video, ``encoder_b`` text) and the
    learnable temperature in one module, so one optimizer step covers all
    three. ``dtype`` is the compute dtype."""

    def __init__(self, video_proj_out: int = 256, text_proj_out: int = 256,
                 vocab_size: int = 30522, logit_scale_init: float = 0.07,
                 logit_scale_max: float = 100.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder_a = VideoEncoder(video_proj_out, dtype)
        self.encoder_b = TextEncoder(text_proj_out, vocab_size, dtype)
        self.contrastive_loss = ContrastiveLossWithTemperature(
            logit_scale=logit_scale_init, logit_scale_min=None, logit_scale_max=logit_scale_max)

    def encode_video(self, video: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return _l2_normalize(self.encoder_a(video, deterministic))

    def encode_text(self, text: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return _l2_normalize(self.encoder_b(text, deterministic))

    def forward(self, video: torch.Tensor, text: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        v = self.encode_video(video, deterministic)
        t = self.encode_text(text, deterministic)
        return self.contrastive_loss(v, t)


def build_model(cfg: Dict[str, Any], device=None, seed: int = 0) -> VideoCLIPForRetrieval:
    """The recipe's model, fp32 weights (bf16 compute under
    ``model.bf16``), random from ``seed`` (drawn on the CPU)."""
    m = cfg["model"]
    dev = resolve_device(device)
    model = VideoCLIPForRetrieval(
        m["video_proj_out"], m["text_proj_out"], m["vocab_size"], m["logit_scale"],
        m["logit_scale_max"], dtype=torch.bfloat16 if m["bf16"] else torch.float32)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    for mod in model.modules():
        if isinstance(mod, Fp32LayerNorm):
            mod.float()
    return model.to(dev)


def build_text_transform(cfg: Dict[str, Any]) -> Callable:
    d = cfg["data"]
    if d["vocab_path"]:
        return BertTextTransform(d["vocab_path"], max_length=d["text_len"])

    # the JAX recipe's fallback without a vocab file: Python's string hash,
    # stable within a process only
    vocab_size = cfg["model"]["vocab_size"]

    def transform(texts):
        out = np.zeros((len(texts), d["text_len"]), np.int32)
        for i, t in enumerate(texts):
            words = str(t).lower().split()[: d["text_len"] - 2]
            ids = [101] + [1000 + (hash(w) % (vocab_size - 2000)) for w in words] + [102]
            out[i, : len(ids)] = ids
        return out

    return transform


def build_datamodule(cfg: Dict[str, Any], split: str) -> MUGENDataModule:
    d = cfg["data"]
    return MUGENDataModule(
        d["path"],
        d["frames_dir"],
        split=split,
        text_transform=build_text_transform(cfg),
        sequence_length=d["sequence_length"],
        sample_every_n_frames=d["sample_every_n_frames"],
        fixed_start_idx=split != "train",
        random_text=split == "train",
        text_len=d["text_len"],
        batch_size=d["batch_size"] if split == "train" else d["eval_batch_size"],
        shuffle=split == "train",
        drop_last=split == "train",
        seed=d["seed"],
    )


def retrieval_loss(model: VideoCLIPForRetrieval, batch: Dict[str, torch.Tensor]):
    """The training step's loss: both towers in training mode (dropout,
    batch statistics that move S3D's running ones)."""
    return model(batch["video"], batch["text"], deterministic=False), {}


def build_retrieval_eval(cfg: Dict[str, Any]
                         ) -> Callable[[VideoCLIPForRetrieval], Dict[str, float]]:
    """``eval_fn(model)``: encode the val split, Recall@{1,5,10} both ways
    (``v2t``: the video is the query)."""
    val_dm = build_datamodule(cfg, split="val")

    def eval_fn(model) -> Dict[str, float]:
        dev = next(model.parameters()).device
        v_emb, t_emb = [], []
        with torch.no_grad():
            for batch in val_dm.eval_batches():
                v_emb.append(model.encode_video(batch["video"].to(dev)).float())
                t_emb.append(model.encode_text(batch["text"].to(dev)).float())
        recalls = retrieval_recall_at_k(torch.cat(v_emb), torch.cat(t_emb))
        return {
            **{f"v2t_recall_{k}": recalls[f"a2b_recall_{k}"] for k in (1, 5, 10)},
            **{f"t2v_recall_{k}": recalls[f"b2a_recall_{k}"] for k in (1, 5, 10)},
        }

    return eval_fn


def build_trainer_and_state(cfg: Dict[str, Any], device=None,
                            model: Optional[VideoCLIPForRetrieval] = None):
    """The recipe's ``Trainer`` (AdamW, as ``optax.adamw(lr,
    weight_decay=...)``) and model, restored from ``train.checkpoint_dir``
    when it holds a checkpoint."""
    t = cfg["train"]
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=t["lr"], weight_decay=t["weight_decay"],
                            fused=dev.type == "cuda")
    trainer = Trainer(retrieval_loss, opt, device=dev, log_dir=t["log_dir"],
                      log_interval=t["log_interval"], checkpoint_dir=t["checkpoint_dir"])
    return trainer, trainer.restore_or_init(model)


def main(argv=None):
    parser = argparse.ArgumentParser(description="MUGEN VideoCLIP retrieval training")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--device", default=None,
                        help="default CUDA; 'cpu' runs the kernels' plain versions")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides a.b=c")
    args = parser.parse_args(argv)
    cfg = build_config(args.config, args.overrides, defaults=DEFAULTS)
    if not cfg["data"]["path"] or not cfg["data"]["frames_dir"]:
        raise SystemExit("set data.path=<release json dir> data.frames_dir=<npy dir>")
    trainer, model = build_trainer_and_state(cfg, device=args.device)
    start = trainer.step
    trainer.fit(model, build_datamodule(cfg, split="train").train_batches(start_step=start),
                num_steps=max(0, int(cfg["train"]["steps"]) - start),
                eval_fn=build_retrieval_eval(cfg), eval_every=cfg["train"]["eval_every"],
                checkpoint_every=cfg["train"]["checkpoint_every"])
    print(f"finished at step {trainer.step}", flush=True)
    return model, trainer


if __name__ == "__main__":
    main()
