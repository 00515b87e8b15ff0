"""AnyPrecision AdamW. Counterpart of
``multimodal_tpu/modules/optimizers/anyprecision.py`` (``anyprecision_adamw``,
an optax transformation there).

AdamW whose momentum, variance and Kahan compensation buffer are held in
chosen dtypes (bf16 halves the optimizer's memory), with the update applied
through the compensation buffer so that bf16 parameters keep the small
updates that rounding would drop. The arithmetic is the JAX transform's, in
fp32 per parameter: update n (counting from 1) uses the learning rate at n
(a schedule is called with the count after its increment) and bias
corrections at n; the decay is decoupled. Parameters without a gradient
are left alone.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch


class AnyPrecisionAdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Callable[[int], float]] = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 use_kahan_summation: bool = False,
                 momentum_dtype: torch.dtype = torch.float32,
                 variance_dtype: torch.dtype = torch.bfloat16,
                 compensation_buffer_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(betas=betas, eps=eps, weight_decay=weight_decay))
        self.lr = lr
        self.use_kahan_summation = use_kahan_summation
        self.momentum_dtype = momentum_dtype
        self.variance_dtype = variance_dtype
        self.compensation_buffer_dtype = compensation_buffer_dtype
        self.count = 0

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        self.count = int(state_dict["count"])
        super().load_state_dict(state_dict)
        # the base class casts floating state to its parameter's dtype: the
        # saved tensors go back as they were saved
        saved = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(saved, params):
            if i in state_dict["state"]:
                self.state[p] = {k: v.to(p.device, copy=True)
                                 for k, v in state_dict["state"][i].items()}

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        self.count += 1
        f32 = np.float32
        count = f32(self.count)
        lr = f32(self.lr(self.count) if callable(self.lr) else self.lr)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            step_size = -(lr / (f32(1) - f32(b1) ** count))
            bc2_sqrt = np.sqrt(f32(1) - f32(b2) ** count)
            decay_rate = -lr * f32(group["weight_decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["momentum"] = torch.zeros_like(p, dtype=self.momentum_dtype)
                    st["variance"] = torch.zeros_like(p, dtype=self.variance_dtype)
                    if self.use_kahan_summation:
                        st["compensation"] = torch.zeros_like(
                            p, dtype=self.compensation_buffer_dtype)
                g = p.grad.float()
                m = (b1 * st["momentum"].float() + (1 - b1) * g).to(self.momentum_dtype)
                v = (b2 * st["variance"].float() + (1 - b2) * g * g).to(self.variance_dtype)
                st["momentum"], st["variance"] = m, v
                p32 = p.float()
                upd = step_size * m.float() / (v.float().sqrt() / bc2_sqrt + group["eps"])
                full = decay_rate * p32 + upd
                if self.use_kahan_summation:
                    compensated = full + st["compensation"].float()
                    new_p = (p32 + compensated).to(p.dtype)
                    realized = new_p.float() - p32
                    st["compensation"] = (compensated - realized).to(
                        self.compensation_buffer_dtype)
                    p.add_(realized.to(p.dtype))
                else:
                    p.add_(full.to(p.dtype))
        return loss
