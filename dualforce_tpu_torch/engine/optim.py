"""AdamW with global-norm clipping and warmup schedules (counterpart of
`dualforce_tpu/engine/optim.py`).

The JAX package's default optimizer is optax's
`chain(clip_by_global_norm(max_grad_norm), adamw(schedule, ...))`. Here it
is `torch.optim.AdamW` driven so that it computes the same updates:
- the learning rate of the n-th update (n from 0) is schedule(n), as optax
  counts, so the first update has lr = schedule(0), which is 0 under warmup;
- the gradients are clipped as `clip_by_global_norm` clips them: left alone
  while the global norm is below the maximum, else scaled by max / norm
  (`torch.nn.utils.clip_grad_norm_` would scale by max / (norm + 1e-6));
- every parameter gets a gradient at every step (zeros where the loss does
  not reach it, as `jax.grad` gives), so AdamW moves each parameter's
  moments, weight decay and step count on every step, as optax does with its
  one global count. `torch.optim.AdamW` would skip a parameter whose grad is
  None.
The 8-bit AdamW and the other optimizers of the JAX registry are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps`, then end."""
    return lambda n: (init - end) * (1 - min(max(n, 0), steps) / steps) + end


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda n: first(n) if n < boundary else second(n - boundary)


def warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    kind: str = "cosine", min_lr_ratio: float = 0.0) -> Schedule:
    """The JAX package's `warmup_schedule` (optax's warmup-cosine-decay, and
    the "linear" and "constant" kinds), as a function of the update count."""
    warmup = max(warmup_steps, 1)
    if kind == "cosine":
        decay_steps = max(total_steps, warmup_steps + 1) - warmup
        end = base_lr * min_lr_ratio
        alpha = 0.0 if base_lr == 0.0 else end / base_lr

        def cosine(n):
            frac = min(n, decay_steps) / decay_steps
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

        return _join(_linear(0.0, base_lr, warmup), cosine, warmup)
    if kind == "linear":
        return _join(_linear(0.0, base_lr, warmup),
                     _linear(base_lr, base_lr * min_lr_ratio,
                             max(total_steps - warmup_steps, 1)), warmup)
    if kind == "constant":
        return _join(_linear(0.0, base_lr, warmup), lambda n: base_lr, warmup)
    raise ValueError(f"unknown schedule kind {kind}")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the tensors' device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """(clipped grads, global norm before clipping), as optax clips: g while
    norm < max_norm, else (g / norm) * max_norm. No host synchronisation."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads], norm


class AdamW:
    """`torch.optim.AdamW` under optax's clip-then-AdamW chain (see above).
    `step(grads)` takes one gradient per parameter, in order, applies the
    update in place and returns the global norm of the unclipped gradients."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2,
                 max_grad_norm: Optional[float] = 1.0,
                 schedule: Optional[Schedule] = None):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda n: lr)
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=tuple(betas), eps=eps,
                                     weight_decay=weight_decay)

    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm:
            grads, norm = clip_by_global_norm(grads, self.max_grad_norm)
        else:
            norm = global_norm(grads)
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adamw"])


def build_optimizer(name: str, params: List[torch.Tensor], **kwargs) -> AdamW:
    """The trainer's `optimizer` setting: "AdamW"; "AdamW8bit" (block-wise
    int8 moments) is not ported yet."""
    if name == "AdamW":
        return AdamW(params, **kwargs)
    if name == "AdamW8bit":
        raise NotImplementedError("AdamW8bit is not ported")
    raise ValueError(f"unknown optimizer {name!r}")
