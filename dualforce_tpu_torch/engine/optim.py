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
step.

The registry's other fourteen (`OPTIMIZERS`, the `registry.OPTIMIZERS`
registry; `build_optimizer`) are the
optax families the JAX package registers under torch's names, computed as
their optax chains compute them (not as the `torch.optim` class of the
same name does): `clip_by_global_norm` outermost, then
`add_decayed_weights(weight_decay)`, which adds the decay to the gradient
before the family scales it (torch's coupled `weight_decay`), then the
family's transform. NAdamW, Lion, LAMB, Adadelta, Adafactor and Novograd
take the decay into their own transform instead. Each factory raises
`TypeError` on a keyword it does not take (`betas` for SGD, RMSprop,
Adagrad, Adadelta and Adafactor), as the JAX factories do; the trainer then
builds it again without `betas`. They share optax's one global step count
and `schedule(count)`; the state lives per parameter in the parameter's
dtype, as optax keeps it, and the arithmetic is plain PyTorch.

Under fsdp (`shards`: per parameter its `parallel.sharding.Shard`, or None
where it is whole) each optimizer updates this rank's slice of a sharded
weight and computes what it computes over the whole tensor in one process:
the clipping norm sums the shards' squares over the fsdp axis; AdamW and
the elementwise families need nothing more; `AdamW8bit`'s 256-blocks
follow the whole tensor's flattened order (a shard whose rows of the
whole are whole blocks quantizes its own blocks; any other holds the whole
moments and updates the gathered tensor); LAMB, Adafactor and Novograd,
whose updates read norms or means over the whole tensor, update the
gathered tensor from whole state.

Every optimizer's `step(grads, frozen=None)` takes optional per-parameter
flags: a flagged parameter and its state are left as they are while the
count advances for all, which is what the JAX package's full fine-tuning
step does to the video expert a step does not train (it zeroes that
expert's update and puts its moments back).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dualforce_tpu_torch.registry import OPTIMIZERS

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


def global_norm(tensors: Sequence[torch.Tensor], shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the tensors' device.
    With `shards`, a sharded tensor's squares are summed over its fsdp axis
    (the whole tensor's), a whole one's counted once."""
    if not shards or all(s is None for s in shards):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    from dualforce_tpu_torch.parallel import mesh as pm

    whole = [t for t, s in zip(tensors, shards) if s is None]
    parts = [t for t, s in zip(tensors, shards) if s is not None]
    axis = next(s.axis for s in shards if s is not None)
    total = pm.psum(sum(t.float().square().sum() for t in parts), axis)
    if whole:
        total = total + sum(t.float().square().sum() for t in whole)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, shards=None):
    """(clipped grads, global norm before clipping), as optax clips: g while
    norm < max_norm, else (g / norm) * max_norm. No host synchronisation.
    `shards` as `global_norm`'s."""
    norm = global_norm(grads, shards)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads], norm


def _gathered(x: torch.Tensor, shard) -> torch.Tensor:
    """The whole tensor of this rank's fsdp slice x (no autograd)."""
    from dualforce_tpu_torch.parallel import mesh as pm

    return pm.all_gather(x.detach(), shard.axis, shard.dim)


def _mine(x: torch.Tensor, shard) -> torch.Tensor:
    """This rank's slice of the whole tensor x."""
    from dualforce_tpu_torch.parallel import mesh as pm

    n = x.shape[shard.dim] // pm.axis_size(shard.axis)
    return x.narrow(shard.dim, pm.axis_index(shard.axis) * n, n)


def _whole_blocks(shard) -> bool:
    """True where each row of the whole tensor that this shard cuts (the
    dims before the sharded one) holds whole 256-blocks of the whole
    tensor's flattened order, so that the shard's own flattened order is a
    run of whole blocks."""
    from dualforce_tpu_torch.parallel import mesh as pm

    shape = shard.whole_shape
    row = math.prod(shape[shard.dim:])
    return row % BLOCK == 0 and (row // pm.axis_size(shard.axis)) % BLOCK == 0


class AdamW:
    """`torch.optim.AdamW` under optax's clip-then-AdamW chain (see above).
    `step(grads)` takes one gradient per parameter, in order, applies the
    update in place and returns the global norm of the unclipped gradients."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2,
                 max_grad_norm: Optional[float] = 1.0,
                 schedule: Optional[Schedule] = None, shards=None):
        self.params = list(params)
        self.shards = list(shards) if shards is not None else None
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda n: lr)
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=tuple(betas), eps=eps,
                                     weight_decay=weight_decay)

    def step(self, grads: Sequence[torch.Tensor],
             frozen: Optional[Sequence[bool]] = None) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm:
            grads, norm = clip_by_global_norm(grads, self.max_grad_norm, self.shards)
        else:
            norm = global_norm(grads, self.shards)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            # torch.optim leaves a parameter without a gradient as it is
            p.grad = None if frozen is not None and frozen[i] else g.to(p.dtype)
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        for i, p in enumerate(self.params):
            if frozen is not None and frozen[i]:
                self._advance_held(p)
        self.count += 1
        return norm

    def _advance_held(self, p: torch.Tensor) -> None:
        """A held parameter's step follows optax's one global count, its
        moments stay (zeros if it has none yet, as optax starts them)."""
        state = self.opt.state[p]
        if not state:
            state["step"] = torch.tensor(float(self.count), dtype=torch.float32)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["step"] += 1

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
                 schedule: Optional[Schedule] = None, shards=None):
        self.params = list(params)
        self.shards = list(shards) if shards is not None else [None] * len(self.params)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps, self.weight_decay = eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda n: lr)
        self.count = 0
        # a shard whose own order is not a run of whole blocks keeps the whole
        # tensor's moments and updates the gathered tensor (`_whole_blocks`)
        self.gather = [s is not None and not _whole_blocks(s) for s in self.shards]
        self.mu = [quantize_blocks(torch.zeros(s.whole_shape if gather else p.shape,
                                               dtype=torch.float32, device=p.device))
                   for p, s, gather in zip(self.params, self.shards, self.gather)]
        self.nu = [(q.clone(), s.clone()) for q, s in self.mu]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             frozen: Optional[Sequence[bool]] = None) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm:
            grads, norm = clip_by_global_norm(grads, self.max_grad_norm, self.shards)
        else:
            norm = global_norm(grads, self.shards)
        # fp32 scalars, as XLA computes them; the Adam count starts at 1 on
        # the first update, the learning rate's at 0 (`scale_by_learning_rate`)
        t = np.float32(self.count + 1)
        c1 = float(np.float32(1) - np.float32(self.b1) ** t)
        c2 = float(np.float32(1) - np.float32(self.b2) ** t)
        neg_lr = float(-np.float32(self.schedule(self.count)))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if frozen is not None and frozen[i]:
                continue
            shard, gather = self.shards[i], self.gather[i]
            g32 = (_gathered(g, shard) if gather else g).float()
            p32 = (_gathered(p, shard) if gather else p).float()
            mu = dequantize_blocks(*self.mu[i], g32)
            nu = dequantize_blocks(*self.nu[i], g32)
            mu = self.b1 * mu + (1 - self.b1) * g32
            nu = self.b2 * nu + (1 - self.b2) * g32.square()
            # mu_hat / (sqrt(nu_hat) + eps), as XLA rewrites it: (a / b) / c
            # becomes a / (b * c)
            update = mu / (c1 * (torch.sqrt(nu / c2) + self.eps))
            update = (update + self.weight_decay * p32) * neg_lr
            # a gradient zero everywhere leaves the parameter and its moments
            # as they are (caveat 10), decided on the device without a sync
            live = g32.abs().amax()
            if shard is not None and not gather:
                from dualforce_tpu_torch.parallel import mesh as pm

                live = pm.pmax(live, shard.axis)       # over the whole tensor
            live = live > 0
            self.mu[i] = tuple(torch.where(live, new, old)
                               for new, old in zip(quantize_blocks(mu), self.mu[i]))
            self.nu[i] = tuple(torch.where(live, new, old)
                               for new, old in zip(quantize_blocks(nu), self.nu[i]))
            new_p = torch.where(live, p32 + update, p32)
            p.copy_(_mine(new_p, shard) if gather else new_p)
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mu = [(q.to(p.device), s.to(p.device)) for (q, s), p in zip(state["mu"], self.params)]
        self.nu = [(q.to(p.device), s.to(p.device)) for (q, s), p in zip(state["nu"], self.params)]


# --- the registry's optax families -----------------------------------------

def _f32(x: float) -> float:
    """x rounded to fp32, as optax computes its count-dependent scalars."""
    return float(np.float32(x))


def _pow(base: float, t: int) -> np.float32:
    """base ** t for an integer count t, in fp32 by repeated squaring, as
    `jnp.power` computes a float to an int32 power."""
    b, acc = np.float32(base), np.float32(1)
    while t:
        if t & 1:
            acc = np.float32(acc * b)
        b, t = np.float32(b * b), t >> 1
    return acc


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay ** t in fp32 (optax's `tree_bias_correction`)."""
    return _f32(np.float32(1) - _pow(decay, t))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm: sqrt of the sum of squares, in x's dtype."""
    return torch.sqrt((x * x).sum())


class _Family:
    """One optax family's transform: `init(p)` gives a parameter's state;
    `update(g, state, p, t, lr)` updates the state in place and returns the
    update to add to p (the learning rate applied and the sign flipped), for
    the t-th step (t from 1) at learning rate `lr` = schedule(t - 1)."""

    def init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, g, state, p, t: int, lr: float) -> torch.Tensor:
        raise NotImplementedError


class _Adam(_Family):
    """`scale_by_adam` (`nesterov`: NAdam's mu_hat), then
    `add_decayed_weights(weight_decay)` where given (NAdamW, LAMB), then
    `scale_by_trust_ratio` for LAMB."""

    def __init__(self, b1, b2, eps, nesterov=False, weight_decay=0.0, trust_ratio=False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov
        self.weight_decay, self.trust_ratio = weight_decay, trust_ratio
        self.elementwise = not trust_ratio

    def init(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def adam(self, g, state, t):
        b1, b2 = self.b1, self.b2
        mu = state["mu"] = (1 - b1) * g + b1 * state["mu"]
        nu = state["nu"] = (1 - b2) * (g * g) + b2 * state["nu"]
        if self.nesterov:
            mu_hat = b1 * (mu / _bias_correction(b1, t + 1)) + (1 - b1) * (
                g / _bias_correction(b1, t))
        else:
            mu_hat = mu / _bias_correction(b1, t)
        return mu_hat, nu / _bias_correction(b2, t)

    def update(self, g, state, p, t, lr):
        mu_hat, nu_hat = self.adam(g, state, t)
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p
        if self.trust_ratio:
            p_norm, u_norm = _norm(p), _norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            u = u * ratio
        return u * -lr


class _Adamax(_Family):
    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, g, state, p, t, lr):
        mu = state["mu"] = (1 - self.b1) * g + self.b1 * state["mu"]
        nu = state["nu"] = torch.maximum(g.abs() + self.eps, self.b2 * state["nu"])
        return (mu / _bias_correction(self.b1, t)) / nu * -lr


class _RAdam(_Adam):
    """`scale_by_radam`: the rectified step where the SMA length ro reaches
    the threshold (5), else the bias-corrected first moment alone."""

    def __init__(self, b1, b2, eps, threshold=5.0):
        super().__init__(b1, b2, eps)
        self.threshold = threshold

    def update(self, g, state, p, t, lr):
        mu_hat, nu_hat = self.adam(g, state, t)
        # fp32 scalars, as optax computes them, but the constants of ro_inf
        # alone in float64 (Python floats there)
        f = np.float32
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _pow(self.b2, t)
        ro = f(ro_inf) - f(2 * t) * b2t / (f(1) - b2t)
        if ro < self.threshold:
            return mu_hat * -lr
        r = float(np.sqrt((ro - f(4)) * (ro - f(2)) * f(ro_inf)
                          / (f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return r * mu_hat / (torch.sqrt(nu_hat) + self.eps) * -lr


class _AdaBelief(_Family):
    def __init__(self, b1, b2, eps, eps_root=1e-16):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, g, state, p, t, lr):
        b1, b2 = self.b1, self.b2
        mu = state["mu"] = (1 - b1) * g + b1 * state["mu"]
        err = g - mu
        nu = state["nu"] = ((1 - b2) * (err * err) + b2 * state["nu"]) + self.eps_root
        mu_hat, nu_hat = mu / _bias_correction(b1, t), nu / _bias_correction(b2, t)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps) * -lr


class _Trace:
    """optax's `trace`: t = g + decay * t; the update is t, or g + decay * t
    with `nesterov`."""

    def __init__(self, decay, nesterov=False):
        self.decay, self.nesterov = decay, nesterov

    def __call__(self, u, state):
        tr = state["trace"] = u + self.decay * state["trace"]
        return u + self.decay * tr if self.nesterov else tr


class _SGD(_Family):
    def __init__(self, momentum=None, nesterov=False):
        self.trace = None if momentum is None else _Trace(momentum, nesterov)

    def init(self, p):
        return {} if self.trace is None else {"trace": torch.zeros_like(p)}

    def update(self, g, state, p, t, lr):
        u = g if self.trace is None else self.trace(g, state)
        return u * -lr


class _RMSprop(_Family):
    """`scale_by_rms` (eps inside the square root, no bias correction, nu
    from 0), the learning rate, then `trace(momentum)` when one is given."""

    def __init__(self, decay, eps, momentum=None):
        self.decay, self.eps = decay, eps
        self.trace = None if momentum is None else _Trace(momentum)

    def init(self, p):
        state = {"nu": torch.zeros_like(p)}
        if self.trace is not None:
            state["trace"] = torch.zeros_like(p)
        return state

    def update(self, g, state, p, t, lr):
        nu = state["nu"] = (1 - self.decay) * (g * g) + self.decay * state["nu"]
        u = torch.rsqrt(nu + self.eps) * g * -lr
        return u if self.trace is None else self.trace(u, state)


class _Adagrad(_Family):
    """`scale_by_rss`: the sum of squares starts at
    `initial_accumulator_value` (0.1); u = g / sqrt(sum + eps) (eps 1e-7)."""

    def __init__(self, initial_accumulator_value, eps):
        self.init_value, self.eps = initial_accumulator_value, eps

    def init(self, p):
        return {"sum_of_squares": torch.full_like(p, self.init_value)}

    def update(self, g, state, p, t, lr):
        s = state["sum_of_squares"] = g * g + state["sum_of_squares"]
        scale = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
        return scale * g * -lr


class _Adadelta(_Family):
    """`add_decayed_weights(weight_decay)`, then `scale_by_adadelta`."""

    def __init__(self, rho, eps, weight_decay):
        self.rho, self.eps, self.weight_decay = rho, eps, weight_decay

    def init(self, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def update(self, g, state, p, t, lr):
        if self.weight_decay:
            g = g + self.weight_decay * p
        rho = self.rho
        e_g = state["e_g"] = (1 - rho) * (g * g) + rho * state["e_g"]
        u = (torch.sqrt(state["e_x"] + self.eps) / torch.sqrt(e_g + self.eps)) * g
        state["e_x"] = (1 - rho) * (u * u) + rho * state["e_x"]
        return u * -lr


class _Lion(_Family):
    def __init__(self, b1, b2, weight_decay):
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def init(self, p):
        return {"mu": torch.zeros_like(p)}

    def update(self, g, state, p, t, lr):
        u = torch.sign((1.0 - self.b1) * g + self.b1 * state["mu"])
        state["mu"] = (1 - self.b2) * g + self.b2 * state["mu"]
        if self.weight_decay:
            u = u + self.weight_decay * p
        return u * -lr


class _Adafactor(_Family):
    """optax's `adafactor` with its defaults: `scale_by_factored_rms` (decay
    1 - t^-0.8; the second moment of a parameter with two dims of at least
    128 factored into row and column means over its two largest dims, eps
    1e-30), `clip_by_block_rms(1.0)`, the learning rate (not negated),
    `scale_by_param_block_rms` (the parameter's RMS, at least 1e-3), then
    `add_decayed_weights(weight_decay_rate)` where one is given, and the
    sign flipped."""

    MIN_DIM = 128
    EPS = 1e-30
    elementwise = False

    def __init__(self, weight_decay_rate=None, decay_rate=0.8):
        self.weight_decay_rate, self.decay_rate = weight_decay_rate, decay_rate

    def _factored(self, shape):
        """(d1, d0): the second largest dim and the largest, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.MIN_DIM:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, p):
        dims = self._factored(tuple(p.shape))
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        shape = list(p.shape)
        return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:])}

    def update(self, g, state, p, t, lr):
        f = np.float32
        decay = float(f(1.0) - f(t) ** f(-self.decay_rate))
        g2 = g * g + self.EPS
        dims = self._factored(tuple(p.shape))
        if dims is None:
            v = state["v"] = decay * state["v"] + (1.0 - decay) * g2
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = state["v_row"] = decay * state["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
            v_col = state["v_col"] = decay * state["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
            row_dim = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=row_dim, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        u = u / torch.clamp(torch.sqrt((u * u).mean()), min=1.0)
        u = lr * u
        rms = torch.sqrt((p * p).mean())
        u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        if self.weight_decay_rate is not None:
            u = u + self.weight_decay_rate * p
        return -1 * u


class _Novograd(_Family):
    """`scale_by_novograd`: a scalar second moment per parameter (the squared
    norm of its gradient), the decay inside the first moment."""

    elementwise = False

    def __init__(self, b1, b2, eps, weight_decay):
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, p):
        return {"mu": torch.zeros_like(p), "nu": p.new_zeros(())}

    def update(self, g, state, p, t, lr):
        sq = _norm(g) ** 2
        nu = state["nu"] = sq if t == 1 else (1 - self.b2) * sq + self.b2 * state["nu"]
        step = g / (torch.sqrt(nu) + self.eps) + self.weight_decay * p
        mu = state["mu"] = step if t == 1 else self.b1 * state["mu"] + step
        return mu * -lr


class OptaxChain:
    """The chain `_register_optax` builds around a family: `clip_by_global_norm(
    max_grad_norm)`, `add_decayed_weights(weight_decay)` (on the gradient),
    the family. `step(grads, frozen=None)` takes one gradient per parameter,
    in order, updates the parameters in place and returns the global norm of
    the unclipped gradients."""

    def __init__(self, params: List[torch.Tensor], family: _Family, lr: float = 1e-4,
                 max_grad_norm: Optional[float] = 1.0, schedule: Optional[Schedule] = None,
                 weight_decay: float = 0.0, shards=None):
        self.params = list(params)
        self.shards = list(shards) if shards is not None else [None] * len(self.params)
        self.family = family
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda n: lr)
        self.weight_decay = weight_decay
        self.count = 0
        # a family that reads the whole tensor updates a shard's gathered one
        self.gather = [s is not None and not family.elementwise for s in self.shards]
        with torch.no_grad():
            self.state = [family.init(_gathered(p, s) if gather else p.detach())
                          for p, s, gather in zip(self.params, self.shards, self.gather)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             frozen: Optional[Sequence[bool]] = None) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm:
            grads, norm = clip_by_global_norm(grads, self.max_grad_norm, self.shards)
        else:
            norm = global_norm(grads, self.shards)
        t, lr = self.count + 1, _f32(self.schedule(self.count))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if frozen is not None and frozen[i]:
                continue
            shard, gather = self.shards[i], self.gather[i]
            w = _gathered(p, shard) if gather else p.detach()
            g = (_gathered(g, shard) if gather else g).to(p.dtype)
            if self.weight_decay:
                g = g + self.weight_decay * w
            u = self.family.update(g, self.state[i], w, t, lr)
            p.add_(_mine(u, shard) if gather else u)
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.state = [{k: v.to(p.device) for k, v in s.items()}
                      for s, p in zip(state["state"], self.params)]


def _betas(kw, default=(0.9, 0.999)):
    return tuple(float(b) for b in kw.pop("betas", default))


def _register(name: str, make: Callable[[Dict[str, Any]], _Family]):
    """A factory like `_register_optax`'s: `make` pops the family's keywords
    (its own weight decay among them), the rest of `weight_decay` goes to
    the chain, and anything left raises TypeError."""

    def factory(params, lr: float = 1e-4, max_grad_norm: Optional[float] = 1.0,
                schedule: Optional[Schedule] = None, shards=None, **kw) -> OptaxChain:
        family = make(kw)
        weight_decay = kw.pop("weight_decay", 0.0)
        if kw:
            raise TypeError(f"{name}: unknown kwargs {sorted(kw)}")
        return OptaxChain(params, family, lr=lr, max_grad_norm=max_grad_norm,
                          schedule=schedule, weight_decay=weight_decay, shards=shards)

    factory.__name__ = name.lower()
    return factory


def _adam(kw, **extra):
    b1, b2 = _betas(kw)
    return _Adam(b1, b2, kw.pop("eps", extra.pop("eps", 1e-8)), **extra)


for _name, _factory in {
    "AdamW": AdamW,
    "AdamW8bit": AdamW8bit,
    "Adam": _register("Adam", lambda kw: _adam(kw)),
    "Adamax": _register("Adamax", lambda kw: _Adamax(*_betas(kw), kw.pop("eps", 1e-8))),
    "NAdam": _register("NAdam", lambda kw: _adam(kw, nesterov=True)),
    "NAdamW": _register("NAdamW", lambda kw: _adam(
        kw, nesterov=True, weight_decay=kw.pop("weight_decay", 1e-2))),
    "RAdam": _register("RAdam", lambda kw: _RAdam(*_betas(kw), kw.pop("eps", 1e-8))),
    "AdaBelief": _register("AdaBelief", lambda kw: _AdaBelief(*_betas(kw),
                                                              kw.pop("eps", 1e-16))),
    "SGD": _register("SGD", lambda kw: _SGD(kw.pop("momentum", None),
                                            kw.pop("nesterov", False))),
    "RMSprop": _register("RMSprop", lambda kw: _RMSprop(
        kw.pop("alpha", 0.99), kw.pop("eps", 1e-8), kw.pop("momentum", None) or None)),
    "Adagrad": _register("Adagrad", lambda kw: _Adagrad(
        kw.pop("initial_accumulator_value", 0.1), kw.pop("eps", 1e-7))),
    "Adadelta": _register("Adadelta", lambda kw: _Adadelta(
        kw.pop("rho", 0.9), kw.pop("eps", 1e-6), kw.pop("weight_decay", 0.0))),
    "Lion": _register("Lion", lambda kw: _Lion(*_betas(kw, (0.9, 0.99)),
                                               kw.pop("weight_decay", 1e-3))),
    "LAMB": _register("LAMB", lambda kw: _adam(
        kw, eps=1e-6, weight_decay=kw.pop("weight_decay", 0.0), trust_ratio=True)),
    "Adafactor": _register("Adafactor", lambda kw: _Adafactor(kw.pop("weight_decay", None))),
    "Novograd": _register("Novograd", lambda kw: _Novograd(
        *_betas(kw, (0.9, 0.25)), kw.pop("eps", 1e-8), kw.pop("weight_decay", 0.0))),
}.items():
    OPTIMIZERS.register_module(name=_name, module=_factory)


def build_optimizer(name: str, params: List[torch.Tensor], **kwargs):
    """The trainer's `optimizer` setting: a name of the JAX package's
    registry (`OPTIMIZERS`). Raises TypeError for a keyword the optimizer
    does not take, KeyError for a name the registry lacks."""
    if name not in OPTIMIZERS:
        raise KeyError(f"{name!r} not found in the optimizer registry; available: "
                       f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](params, **kwargs)
