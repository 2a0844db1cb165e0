"""Flow-matching schedulers.

A copy of the JAX package's numpy schedulers (its
`diffusion/flow_match.py`), registered in the port's
`registry.DIFFUSION_SCHEDULERS` under the same names and kept here so that
the port imports nothing of the JAX package. Tables are host-side numpy and
static per generation config; the sampler reads its sigma columns.
`FlowMatchEulerDiscreteScheduler` is the diffusers-API scheduler; its
`step` and `scale_noise` take torch tensors or numpy arrays.

Formulas (flow_match.py):
  sigmas = linspace(sigma_start, sigma_min, N[+1][:-1])
  shift warp: sigma <- s*sigma / (1 + (s-1)*sigma)      (or exponential mu warp)
  timesteps = sigmas * num_train_timesteps
  Euler step: x_next = x + v * (sigma_next - sigma)
  add_noise: x_t = (1-sigma)*x0 + sigma*noise
  training target: v = noise - x0
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from dualforce_tpu_torch.config import SchedulerConfig
from dualforce_tpu_torch.registry import DIFFUSION_SCHEDULERS


def _build_sigmas(
    cfg: SchedulerConfig,
    num_steps: int,
    denoising_strength: float = 1.0,
    shift: Optional[float] = None,
    mu: Optional[float] = None,
) -> np.ndarray:
    shift = cfg.shift if shift is None else shift
    sigma_start = cfg.sigma_min + (cfg.sigma_max - cfg.sigma_min) * denoising_strength
    if cfg.extra_one_step:
        sigmas = np.linspace(sigma_start, cfg.sigma_min, num_steps + 1, dtype=np.float64)[:-1]
    else:
        sigmas = np.linspace(sigma_start, cfg.sigma_min, num_steps, dtype=np.float64)
    if cfg.inverse_timesteps:
        sigmas = np.flip(sigmas, axis=0)
    if cfg.exponential_shift:
        mu_value = mu if mu is not None else cfg.exponential_shift_mu
        if mu_value is None:
            raise RuntimeError("exponential_shift enabled but no mu provided")
        sigmas = math.exp(mu_value) / (math.exp(mu_value) + (1 / sigmas - 1))
    else:
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    if cfg.shift_terminal is not None:
        one_minus = 1 - sigmas
        scale_factor = one_minus[-1] / (1 - cfg.shift_terminal)
        sigmas = 1 - (one_minus / scale_factor)
    if cfg.reverse_sigmas:
        sigmas = 1 - sigmas
    return sigmas.astype(np.float32)


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 8192,
    base_shift: float = 0.5,
    max_shift: float = 0.9,
) -> float:
    """Dynamic exponential-shift mu by sequence length (flow_match.py:122-133)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


@DIFFUSION_SCHEDULERS.register_module()
class FlowMatchScheduler:
    """Single-modality flow-matching Euler scheduler."""

    def __init__(self, config: Optional[SchedulerConfig] = None, **overrides):
        if config is None:
            config = SchedulerConfig()
        if overrides:
            config = replace(config, **overrides)
        self.config = config
        self.num_train_timesteps = config.num_train_timesteps
        self.shift = config.shift
        self.training = False
        self.linear_timesteps_weights: Optional[np.ndarray] = None
        # Train tables cached from the FIRST set_timesteps call (reference
        # caches whatever was set first; constructor sets train tables first —
        # flow_match.py:37-40,65-68).
        self.train_sigmas: Optional[np.ndarray] = None
        self.train_timesteps: Optional[np.ndarray] = None
        self.set_timesteps(config.num_train_timesteps)
        self.set_timesteps(config.num_inference_steps)

    def set_timesteps(
        self,
        num_inference_steps: int = 100,
        denoising_strength: float = 1.0,
        training: bool = False,
        shift: Optional[float] = None,
        dynamic_shift_len: Optional[int] = None,
    ) -> None:
        if shift is not None:
            self.shift = shift
            self.config = replace(self.config, shift=shift)
        mu = None
        if self.config.exponential_shift and dynamic_shift_len is not None:
            mu = calculate_shift(dynamic_shift_len)
        self.sigmas = _build_sigmas(self.config, num_inference_steps,
                                    denoising_strength, self.shift, mu)
        self.timesteps = self.sigmas * self.num_train_timesteps
        if self.train_timesteps is None:
            self.train_timesteps = self.timesteps
            self.train_sigmas = self.sigmas
        if training:
            x = self.timesteps.astype(np.float64)
            y = np.exp(-2 * ((x - num_inference_steps / 2) / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            self.linear_timesteps_weights = (
                y_shifted * (num_inference_steps / y_shifted.sum())
            ).astype(np.float32)
        self.training = training

    # --- lookup helpers ---------------------------------------------------
    def _timestep_id(self, timestep: float) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def sigma_of(self, timestep: float) -> float:
        return float(self.sigmas[self._timestep_id(timestep)])

    def timestep_to_sigma(self, timestep: float) -> float:
        """Nearest lookup against TRAIN tables (flow_match_pair.py:198-219)."""
        idx = int(np.argmin(np.abs(self.train_timesteps - float(timestep))))
        return float(self.train_sigmas[idx])

    # --- numerics (work on numpy or jnp arrays transparently) -------------
    def step(self, model_output, timestep: float, sample, to_final: bool = False):
        tid = self._timestep_id(timestep)
        sigma = float(self.sigmas[tid])
        if to_final or tid + 1 >= len(self.timesteps):
            sigma_next = 1.0 if (self.config.inverse_timesteps or self.config.reverse_sigmas) else 0.0
        else:
            sigma_next = float(self.sigmas[tid + 1])
        return sample + model_output * (sigma_next - sigma)

    def return_to_timestep(self, timestep: float, sample, sample_stablized):
        sigma = self.sigma_of(timestep)
        return (sample - sample_stablized) / sigma

    def add_noise(self, original_samples, noise, timestep: float):
        sigma = self.sigma_of(timestep)
        return (1 - sigma) * original_samples + sigma * noise

    def training_target(self, sample, noise, timestep=None):
        return noise - sample

    def training_weight(self, timestep: float) -> float:
        tid = self._timestep_id(timestep)
        return float(self.linear_timesteps_weights[tid])


@DIFFUSION_SCHEDULERS.register_module()
class FlowMatchPairScheduler(FlowMatchScheduler):
    """Paired (visual, audio) timesteps with optionally independent sigma
    columns per modality ("dual_sigma_shift", flow_match_pair.py:74-149)."""

    def __init__(self, config: Optional[SchedulerConfig] = None, **overrides):
        self._pair_postprocess = None
        super().__init__(config, **overrides)

    # --- pair construction -------------------------------------------------
    def set_pair_postprocess_by_name(self, name: Optional[str], **kwargs) -> None:
        if name is None or str(name).lower() in ("none", "off", "false", "no"):
            self._pair_postprocess = None
            return
        if name == "dual_sigma_shift":
            self._pair_postprocess = dict(
                visual_shift=float(kwargs.get("visual_shift", self.shift)),
                audio_shift=float(kwargs.get("audio_shift", self.shift)),
                visual_denoising_strength=float(kwargs.get("visual_denoising_strength", 1.0)),
                audio_denoising_strength=float(kwargs.get("audio_denoising_strength", 1.0)),
                visual_mu=kwargs.get("visual_exponential_shift_mu", self.config.exponential_shift_mu),
                audio_mu=kwargs.get("audio_exponential_shift_mu", self.config.exponential_shift_mu),
            )
            return
        raise ValueError(f"Unsupported pair postprocessing name: {name}")

    def _pair_columns(self, source: str) -> np.ndarray:
        base = self.timesteps if source == "timesteps" else self.sigmas
        n = len(base)
        if self._pair_postprocess is None:
            return np.stack([base, base], axis=1)
        pp = self._pair_postprocess

        def col(shift, strength, mu):
            sig = _build_sigmas(self.config, n, strength, shift, mu)
            return sig * self.num_train_timesteps if source == "timesteps" else sig

        visual = col(pp["visual_shift"], pp["visual_denoising_strength"], pp["visual_mu"])
        audio = col(pp["audio_shift"], pp["audio_denoising_strength"], pp["audio_mu"])
        return np.stack([visual, audio], axis=1)

    def get_pairs(self, source: str = "timesteps") -> np.ndarray:
        """[N, 2] array of (visual, audio) timesteps or sigmas."""
        if source not in ("timesteps", "sigmas"):
            raise ValueError("source only supports 'timesteps' or 'sigmas'")
        return self._pair_columns(source)

    @property
    def visual_timesteps(self) -> np.ndarray:
        return self.get_pairs()[:, 0]

    @property
    def audio_timesteps(self) -> np.ndarray:
        return self.get_pairs()[:, 1]

    def step_from_to(self, model_output, timestep_from: float,
                     timestep_to: Optional[float], sample):
        """x_to = x_from + v * (sigma(to) - sigma(from)); sigma via nearest
        train-table lookup (flow_match_pair.py:221-235)."""
        sigma_from = self.timestep_to_sigma(timestep_from)
        if timestep_to is None:
            sigma_to = 1.0 if (self.config.inverse_timesteps or self.config.reverse_sigmas) else 0.0
        else:
            sigma_to = self.timestep_to_sigma(timestep_to)
        return sample + model_output * (sigma_to - sigma_from)

    def pair_sigma_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-step (from, to) sigma tables for both modalities, resolved via
        the same nearest-train-timestep lookup the per-step path uses — the
        jitted sampler consumes these directly.

        Returns (visual_sigmas[N+1], audio_sigmas[N+1]) with terminal sigma
        appended (0.0 for the standard direction).
        """
        pairs = self.get_pairs("timesteps")
        terminal = 1.0 if (self.config.inverse_timesteps or self.config.reverse_sigmas) else 0.0
        vis = np.array([self.timestep_to_sigma(t) for t in pairs[:, 0]] + [terminal], np.float32)
        aud = np.array([self.timestep_to_sigma(t) for t in pairs[:, 1]] + [terminal], np.float32)
        return vis, aud


@DIFFUSION_SCHEDULERS.register_module()
class FlowMatchEulerDiscreteScheduler:
    """Diffusers-API flow-match Euler scheduler: set_timesteps(N),
    `.timesteps`/`.sigmas` float32 arrays, `index_for_timestep`,
    `scale_noise`, and step(..., return_dict=False) -> (prev_sample,).
    sigmas = t / num_train_timesteps warped by `shift`, a terminal 0
    appended."""

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0, **_ignored):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        t = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float64)[::-1]
        self._set_from_sigmas(t / num_train_timesteps)

    def _set_from_sigmas(self, sigmas: np.ndarray) -> None:
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        self._step_index = None

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.num_inference_steps = num_inference_steps
        sigmas = np.linspace(1.0, 1.0 / self.num_train_timesteps, num_inference_steps,
                             dtype=np.float64)
        self._set_from_sigmas(sigmas)

    def index_for_timestep(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def scale_noise(self, sample, timestep, noise):
        sigma = float(self.sigmas[self.index_for_timestep(timestep)])
        return (1 - sigma) * sample + sigma * noise

    def step(self, model_output, timestep, sample, return_dict: bool = False):
        if return_dict:
            # raised before the index moves: a failed call leaves the trajectory as it was
            raise NotImplementedError("return_dict output objects unsupported; "
                                      "call with return_dict=False")
        i = (self._step_index if self._step_index is not None
             else self.index_for_timestep(timestep))
        prev = sample + model_output * float(self.sigmas[i + 1] - self.sigmas[i])
        self._step_index = i + 1
        return (prev,)
