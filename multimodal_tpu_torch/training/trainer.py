"""Single-device training loop.

Counterpart of ``multimodal_tpu/training/trainer.py`` for one device: a
step is prefetch the batch to the device, zero grad, ``loss_fn(model,
batch) -> (loss, aux)``, backward, optimizer step. It logs items/s and
keeps the metrics on the device between log boundaries, as the JAX loop
does. ``skip_nonfinite_updates`` drops a step whose loss or any gradient is
non-finite, leaving the parameters, the optimizer state and any gradient
accumulation as they were; ``grad_accum_steps`` averages the gradients of
that many steps before one optimizer step, as ``optax.MultiSteps`` does.

With ``checkpoint_dir`` the trainer saves its state every
``checkpoint_every`` steps of ``fit`` (``training/checkpoint.py``) and
``restore_or_init`` loads the newest one. The state is the model's
``state_dict``, the optimizer's (its schedule count included), the step,
the gradient-accumulation buffers and the torch RNG states, so a resumed
run is the uninterrupted run: on the CPU bitwise.

Not here yet (ROADMAP A7, A8): the mesh and its strategies (ddp, fsdp, tp,
custom), checkpointing on preemption, ``mutable_state`` and multihost
input.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_tpu_torch.data.device_prefetch import device_prefetch
from multimodal_tpu_torch.training.checkpoint import CheckpointManager
from multimodal_tpu_torch.utils.device import resolve_device


class MetricsLogger:
    """JSONL metrics file plus stdout; every record is also kept in
    ``records``."""

    def __init__(self, log_dir: Optional[str] = None, log_interval: int = 10):
        self.log_interval = log_interval
        self.records: List[Dict[str, float]] = []
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if step % self.log_interval == 0:
            parts = " ".join(f"{k}={v:.4f}" for k, v in record.items() if k != "step")
            print(f"[step {step}] {parts}", flush=True)


def _items(batch: Any) -> int:
    """Leading dimension of the batch's first array."""
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (tuple, list)):
        for b in batch:
            n = _items(b)
            if n:
                return n
        return 0
    return batch.shape[0] if getattr(batch, "ndim", 0) > 0 else 0


class Trainer:
    """Args:
        loss_fn: ``(model, batch) -> (loss, aux_metrics_dict)``.
        optimizer: a ``torch.optim.Optimizer`` over the model's parameters.
        device: where batches go; CUDA when None (raises without it).
    """

    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Any], Tuple[torch.Tensor, Dict[str, Any]]],
        optimizer: torch.optim.Optimizer,
        device: Optional[Union[str, torch.device]] = None,
        log_dir: Optional[str] = None,
        log_interval: int = 10,
        skip_nonfinite_updates: bool = False,
        grad_accum_steps: int = 1,
        checkpoint_dir: Optional[str] = None,
        max_checkpoints: int = 3,
    ):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_accum_steps = grad_accum_steps
        self.logger = MetricsLogger(log_dir, log_interval)
        self.step = 0
        self._mini_step = 0
        self._acc: Optional[List[Optional[torch.Tensor]]] = None
        self.ckpt = CheckpointManager(checkpoint_dir, max_checkpoints) if checkpoint_dir else None

    def state_dict(self, model: nn.Module) -> Dict[str, Any]:
        """Everything a resumed run needs to continue as this one would."""
        rng = {"torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"model": model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "mini_step": self._mini_step, "acc": self._acc,
                "rng": rng}

    def load_state_dict(self, model: nn.Module, state: Dict[str, Any]) -> None:
        model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self._mini_step = int(state["mini_step"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            None if a is None else a.to(p.device) for a, p in zip(acc, self._params())]
        torch.set_rng_state(state["rng"]["torch"])
        if "cuda" in state["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["rng"]["cuda"], self.device)

    def restore_or_init(self, model: nn.Module) -> nn.Module:
        """Loads the newest checkpoint of ``checkpoint_dir`` into ``model``,
        the optimizer and this trainer, if there is one; ``model`` as it is
        otherwise."""
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.load_state_dict(model, self.ckpt.restore())
            print(f"resumed from checkpoint step {self.step}", flush=True)
        return model

    def save(self, model: nn.Module) -> None:
        self.ckpt.save(self.step, self.state_dict(model))

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _finite(self, loss: torch.Tensor, params: List[torch.Tensor]) -> bool:
        checks = [torch.isfinite(loss).all()]
        checks += [torch.isfinite(p.grad).all() for p in params if p.grad is not None]
        return bool(torch.stack(checks).all())

    def _apply(self, params: List[torch.Tensor]) -> None:
        """Optimizer step on this step's gradients, or on the mean of the
        last ``grad_accum_steps`` steps' gradients once they are all in."""
        k = self.grad_accum_steps
        if k > 1:
            grads = [p.grad for p in params]
            if self._acc is None:
                self._acc = grads
            else:
                self._acc = [a if g is None else (g if a is None else a.add_(g))
                             for a, g in zip(self._acc, grads)]
            self._mini_step += 1
            if self._mini_step < k:
                return
            for p, a in zip(params, self._acc):
                p.grad = None if a is None else a.div_(k)
            self._acc, self._mini_step = None, 0
        self.optimizer.step()

    def fit(
        self,
        model: nn.Module,
        data: Iterable,
        num_steps: int,
        eval_fn: Optional[Callable[[nn.Module], Dict[str, float]]] = None,
        eval_every: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
    ) -> nn.Module:
        """Train ``model`` in place for ``num_steps`` batches of ``data``;
        the last step's gradients stay in ``.grad``. ``eval_fn(model) ->
        metrics`` runs under ``torch.no_grad()`` every
        ``eval_every`` steps and at the end; its metrics are logged with an
        ``eval_`` prefix. With a ``checkpoint_dir``, the state is saved
        after every step that ``checkpoint_every`` divides."""
        model.train()
        params = self._params()
        data_iter = device_prefetch(
            (b for _, b in zip(range(num_steps), data)), self.device)
        t0 = time.perf_counter()
        items = 0
        pending = []  # (step, device metrics, items/s): pulled to the host at log boundaries

        def flush():
            for s, m, ips in pending:
                self.logger.log(s, {**m, "items_per_sec": ips})
            pending.clear()

        for i, batch in enumerate(data_iter):
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self.loss_fn(model, batch)
            loss.backward()
            metrics = {"loss": loss.detach(), **aux}
            if self.skip_nonfinite_updates:
                ok = self._finite(loss, params)
                if ok:
                    self._apply(params)
                metrics["nonfinite_skipped"] = 0.0 if ok else 1.0
            else:
                self._apply(params)
            items += _items(batch)
            self.step += 1
            pending.append((self.step, metrics, items / max(time.perf_counter() - t0, 1e-9)))
            last = i == num_steps - 1
            if self.step % self.logger.log_interval == 0 or last:
                flush()
            if eval_fn is not None and ((eval_every and self.step % eval_every == 0) or last):
                flush()
                with torch.no_grad():
                    eval_metrics = eval_fn(model)
                self.logger.log(self.step, {f"eval_{k}": v for k, v in eval_metrics.items()})
            if self.ckpt is not None and checkpoint_every and self.step % checkpoint_every == 0:
                flush()
                self.save(model)
        flush()  # data ran out before num_steps
        return model
