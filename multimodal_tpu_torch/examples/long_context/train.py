"""Long-context LM training recipe on one device. Counterpart of
``multimodal_tpu/examples/long_context/train.py``.

Data: a flat token stream (.npy / .bin int32 memmap, or synthetic when no
path is given) chunked into (seq_len + 1)-token windows, or packed documents
(``--packed-docs``: a jsonl of token-id lists, or ``synthetic``) with
segment ids, per-document positions and a boundary-masked loss. The model is
``LongContextLM`` with remat; the optimizer global-norm clipping (1.0) in
front of AdamW, as ``optax.chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=0.1))``; the port's ``Trainer`` skips non-finite updates.

Usage::

    python -m multimodal_tpu_torch.examples.long_context.train --bf16 \\
        --seq-len 8192 --batch-size 8 --steps 100 --tokens data/tokens.npy

``--checkpoint-dir`` saves the trainer's state every ``--checkpoint-every``
steps (500, as the JAX recipe); a run started on a directory that holds a
checkpoint resumes from it, skips the batches already trained on and
trains the remaining steps, so it ends as the uninterrupted run would.

Not here yet: the mesh (``--dp``, ``--fsdp``; ROADMAP.md A7), context,
expert and pipeline parallelism and MoE (``--cp``, ``--ep``, ``--pp``,
``--moe-experts``; A4): each raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Iterator, Optional

import numpy as np
import torch

from multimodal_tpu_torch.data.packing import packed_batches
from multimodal_tpu_torch.examples.long_context.model import (
    LongContextLM,
    long_context_lm,
    next_token_loss,
    packed_next_token_loss,
)
from multimodal_tpu_torch.training.trainer import Trainer


class TokenWindowDataset:
    """(seq_len + 1)-token windows over a flat int32 token stream."""

    def __init__(self, tokens: np.ndarray, seq_len: int):
        self.tokens = tokens
        self.seq_len = seq_len
        self.n = max(0, (len(tokens) - 1) // seq_len)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        start = i * self.seq_len
        return np.asarray(self.tokens[start:start + self.seq_len + 1], np.int32)


def token_batches(dataset: TokenWindowDataset, batch_size: int, seed: int = 0) -> Iterator[dict]:
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(len(dataset), size=batch_size)
        yield {"tokens": np.stack([dataset[int(i)] for i in idx])}


def synthetic_tokens(vocab_size: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(vocab_size, size=n).astype(np.int32)


def packed_document_batches(
    docs_path: Optional[str],
    vocab_size: int,
    seq_len: int,
    batch_size: int,
    seed: int = 0,
) -> Iterator[dict]:
    """Packed batches from a jsonl of per-document token-id lists (or a
    synthetic ragged document stream) via ``data/packing.pack_documents``;
    the extra +1 column keeps the recipe's shift-by-one loss layout."""

    def doc_stream():
        if docs_path:
            while True:  # infinite epochs over the file
                with open(docs_path) as f:
                    for line in f:
                        ids = json.loads(line)
                        if isinstance(ids, dict):
                            ids = ids["tokens"]
                        yield ids
        else:
            rng = np.random.RandomState(seed)
            while True:
                n = int(rng.randint(seq_len // 8, seq_len))
                yield rng.randint(1, vocab_size, size=n).astype(np.int32)

    yield from packed_batches(doc_stream(), seq_len + 1, batch_size)


class ClipByGlobalNormAdamW(torch.optim.AdamW):
    """AdamW behind global-norm clipping, as ``optax.chain(
    clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps, weight_decay))``:
    before each step the gradients are scaled by ``max_norm / norm`` when
    their global norm reaches ``max_norm``, with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm). The norm and
    the scale stay on the device."""

    def __init__(self, params, lr: float = 3e-4, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.1, max_norm: float = 1.0, **kwargs):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         **kwargs)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            torch._foreach_mul_(grads, scale)
        return super().step(closure)


def build_trainer(
    model: LongContextLM,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    log_dir: Optional[str] = None,
    log_interval: int = 10,
    checkpoint_dir: Optional[str] = None,
) -> Trainer:
    """The recipe's ``Trainer`` for ``model`` on its own device: next-token
    loss (packed batches, those with ``segment_ids``, take the
    boundary-masked loss and per-document positions), clipping + AdamW,
    non-finite updates skipped."""

    def loss_fn(model, batch):
        tokens = batch["tokens"]
        kwargs = {}
        packed = "segment_ids" in batch
        if packed:
            kwargs = dict(segment_ids=batch["segment_ids"][:, :-1],
                          positions=batch["positions"][:, :-1])
        logits = model(tokens[:, :-1], deterministic=False, **kwargs)
        if packed:
            loss = packed_next_token_loss(logits, tokens[:, 1:], batch["segment_ids"])
        else:
            loss = next_token_loss(logits, tokens[:, 1:])
        return loss, {"perplexity": torch.exp(loss.detach())}

    device = next(model.parameters()).device
    opt = ClipByGlobalNormAdamW(model.parameters(), lr=learning_rate,
                                weight_decay=weight_decay, fused=device.type == "cuda")
    return Trainer(loss_fn, opt, device=device, log_dir=log_dir, log_interval=log_interval,
                   skip_nonfinite_updates=True, checkpoint_dir=checkpoint_dir)


def _refuse(args) -> None:
    for on, flag, queue in ((args.dp > 1 or args.fsdp > 1, "--dp/--fsdp", "A7"),
                            (args.cp > 1, "--cp", "A4"), (args.ep > 1, "--ep", "A4"),
                            (args.pp > 1, "--pp", "A4/A7"),
                            (args.moe_experts, "--moe-experts", "A4")):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, queue {queue})")


def main(argv=None):
    """Train as the JAX recipe's ``main`` does on one device; returns the
    model and its ``Trainer`` (whose logger holds the metrics)."""
    p = argparse.ArgumentParser()
    p.add_argument("--tokens", default=None, help=".npy/.bin int32 token stream")
    p.add_argument("--packed-docs", default=None,
                   help="jsonl of per-document token-id lists -> packed training "
                        "(segment-id attention, boundary-masked loss); 'synthetic' for a "
                        "generated ragged stream")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-layer", type=int, default=12)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-head", type=int, default=12)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=-1)
    p.add_argument("--cp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp-virtual", type=int, default=1)
    p.add_argument("--pp-microbatches", type=int, default=0)
    p.add_argument("--moe-experts", type=int, default=0, help="0 = dense")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-interval", type=int, default=2)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default=None, help="default CUDA; 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    _refuse(args)

    model = long_context_lm(
        device=args.device, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        param_dtype=torch.float32, vocab_size=args.vocab_size, max_seq_len=args.seq_len,
        n_layer=args.n_layer, d_model=args.d_model, n_head=args.n_head,
        dim_feedforward=4 * args.d_model, remat=True,
    )
    if args.packed_docs:
        data = packed_document_batches(
            None if args.packed_docs == "synthetic" else args.packed_docs,
            args.vocab_size, args.seq_len, args.batch_size)
    else:
        if args.tokens:
            stream = (np.load(args.tokens, mmap_mode="r") if args.tokens.endswith(".npy")
                      else np.memmap(args.tokens, dtype=np.int32))
        else:
            stream = synthetic_tokens(args.vocab_size, args.batch_size * args.seq_len * 64)
        data = token_batches(TokenWindowDataset(stream, args.seq_len), args.batch_size)
    trainer = build_trainer(model, learning_rate=args.lr, log_dir=args.log_dir,
                            checkpoint_dir=args.checkpoint_dir)
    trainer.restore_or_init(model)
    start = trainer.step
    trainer.fit(model, itertools.islice(data, start, None), max(0, args.steps - start),
                checkpoint_every=args.checkpoint_every)
    return model, trainer


if __name__ == "__main__":
    main()
