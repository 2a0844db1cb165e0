"""The flow-matching schedule of a MOVA generation, for the reference's
Euler update: N inference sigmas on a shifted linear ramp, each step's
timestep t = 1000 sigma, and the sigma the update uses looked up in the
1000-step training table nearest to t (the reference's pair scheduler), with
a terminal sigma of 0. Computed in float64 from the scheduler's settings."""

from __future__ import annotations

import numpy as np


def shifted(cfg: dict, n: int, shift: float) -> np.ndarray:
    ramp = np.linspace(cfg["sigma_max"], cfg["sigma_min"], n + 1)[:-1]
    return (shift * ramp / (1 + (shift - 1) * ramp)).astype(np.float32)


def plan(cfg: dict, steps: int, shift: float, boundary_ratio: float):
    """(timesteps [N], sigmas [N + 1], boundary step): the step at which the
    low-noise expert takes over is the first whose timestep falls below
    boundary_ratio * 1000."""
    sc = cfg["scheduler"]
    if (sc["inverse_timesteps"] or sc["reverse_sigmas"] or sc["exponential_shift"]
            or sc["shift_terminal"] is not None or not sc["extra_one_step"]):
        raise ValueError("the reference has the plain shifted schedule only")
    ttrain = sc["num_train_timesteps"]
    train_sigmas = shifted(sc, ttrain, sc["shift"])
    train_t = train_sigmas * ttrain
    timesteps = shifted(sc, steps, shift) * ttrain
    nearest = np.abs(train_t[None, :].astype(np.float64)
                     - timesteps[:, None].astype(np.float64)).argmin(axis=1)
    sigmas = np.concatenate([train_sigmas[nearest], [0.0]]).astype(np.float32)
    below = np.nonzero(timesteps < boundary_ratio * ttrain)[0]
    boundary = int(below[0]) if len(below) else steps
    return timesteps, sigmas, boundary
