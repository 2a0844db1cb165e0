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

`AdamW8bit` is the counterpart of `adamw_8bit`: optax's chain of
`clip_by_global_norm`, `scale_by_adam_8bit` (both Adam moments stored as
block-256 absmax int8 codes with fp32 block scales, dequantized, updated in
fp32 and requantized at every step), `add_decayed_weights` and
`scale_by_learning_rate`, written out in that order. One deliberate
deviation (ROADMAP C, caveat 10): a parameter whose gradient is zero
everywhere in a step is left as it is, moments included, as PyTorch's
optimizers leave a parameter without a gradient. Under JAX's chain such a
step divides the dequantized first moment by a second moment whose small
entries the int8 codes have rounded to 0, so the update is ~mu / eps: the
LoRA of the expert not trained in a step (every other step, or for
`expert_switch_interval` steps under offload) would jump by ~1e3 x lr per
step. The other optimizers of the JAX registry are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


BLOCK = 256         # elements per quantization block of a moment


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_q8` of the JAX package: x flattened, zero-padded to whole blocks of
    256 -> (int8 codes [blocks, 256], fp32 scales [blocks, 1]). scale =
    max|block| / 127 (a zero block gets scale 0 and divides by 1); codes =
    round-half-to-even(block / scale) clipped to +-127."""
    flat = x.reshape(-1).float()
    pad = -flat.numel() % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, BLOCK)
    # JAX runs the optimizer under jit, where XLA turns `max|x| / 127.0` into
    # a product with the fp32 reciprocal (a Python scalar enters an fp32
    # product rounded to fp32)
    scale = blocks.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(blocks / safe).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor
                      ) -> torch.Tensor:
    """`_dq8`: the fp32 values of `quantize_blocks`' codes, in `like`'s shape."""
    return (q.float() * scale).reshape(-1)[:like.numel()].view(like.shape)


class AdamW8bit:
    """The JAX package's `adamw_8bit` (see the module docstring). `step(grads)`
    takes one gradient per parameter, in order, updates the parameters in
    place and returns the global norm of the unclipped gradients. The
    moments live as int8 codes and fp32 block scales on the parameters'
    device: (1 + 4 / 256) bytes per element each, against 4 in fp32."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2,
                 max_grad_norm: Optional[float] = 1.0,
                 schedule: Optional[Schedule] = None):
        self.params = list(params)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps, self.weight_decay = eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda n: lr)
        self.count = 0
        self.mu = [quantize_blocks(torch.zeros_like(p, dtype=torch.float32))
                   for p in self.params]
        self.nu = [(q.clone(), s.clone()) for q, s in self.mu]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm:
            grads, norm = clip_by_global_norm(grads, self.max_grad_norm)
        else:
            norm = global_norm(grads)
        # fp32 scalars, as XLA computes them; the Adam count starts at 1 on
        # the first update, the learning rate's at 0 (`scale_by_learning_rate`)
        t = np.float32(self.count + 1)
        c1 = float(np.float32(1) - np.float32(self.b1) ** t)
        c2 = float(np.float32(1) - np.float32(self.b2) ** t)
        neg_lr = float(-np.float32(self.schedule(self.count)))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g32 = g.float()
            mu = dequantize_blocks(*self.mu[i], g32)
            nu = dequantize_blocks(*self.nu[i], g32)
            mu = self.b1 * mu + (1 - self.b1) * g32
            nu = self.b2 * nu + (1 - self.b2) * g32.square()
            # mu_hat / (sqrt(nu_hat) + eps), as XLA rewrites it: (a / b) / c
            # becomes a / (b * c)
            update = mu / (c1 * (torch.sqrt(nu / c2) + self.eps))
            update = (update + self.weight_decay * p.float()) * neg_lr
            # a gradient zero everywhere leaves the parameter and its moments
            # as they are (caveat 10), decided on the device without a sync
            live = g32.abs().amax() > 0
            self.mu[i] = tuple(torch.where(live, new, old)
                               for new, old in zip(quantize_blocks(mu), self.mu[i]))
            self.nu[i] = tuple(torch.where(live, new, old)
                               for new, old in zip(quantize_blocks(nu), self.nu[i]))
            p.copy_(torch.where(live, p.float() + update, p.float()))
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mu = [(q.to(p.device), s.to(p.device)) for (q, s), p in zip(state["mu"], self.params)]
        self.nu = [(q.to(p.device), s.to(p.device)) for (q, s), p in zip(state["nu"], self.params)]


OPTIMIZERS = {"AdamW": AdamW, "AdamW8bit": AdamW8bit}


def build_optimizer(name: str, params: List[torch.Tensor], **kwargs):
    """The trainer's `optimizer` setting: "AdamW" or "AdamW8bit" (block-wise
    int8 moments). The JAX registry's other optimizers are not ported."""
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported "
                                  f"(ported: {', '.join(OPTIMIZERS)})")
    return OPTIMIZERS[name](params, **kwargs)
