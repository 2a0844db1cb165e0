"""Faults planted under the timed path, to show that a cell's check fails
them: the CPU tests drive whole runs with one planted, and
`calibrate.py --fault` reads them on the card at the cell's size. The
benchmark's own runs never plant one.

- `unchanged`: a step that returns its state as it was (the denoise step
  its latents, the optimizer step the factors).
- `altered`: an answer altered where it is produced (the denoise step's
  first latent frame left as it came in; the first factor's gradient
  doubled).
- `no_negative`: a denoise step that leaves out its negative pass (CFG
  scale 1), the part of the work the cached negative makes optional.
"""

from __future__ import annotations

import contextlib

FAULTS = {"denoise": ("unchanged", "altered", "no_negative"),
          "train": ("unchanged", "altered")}


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """The fault `fault` planted in the program for the body of the block."""
    if fault not in FAULTS[entry]:
        raise ValueError(f"no fault {fault!r} for a {entry} cell")
    if entry == "denoise":
        from dualforce_tpu_torch.diffusion import sampler as target

        name = "denoise_steps"
        orig = target.denoise_steps

        def broken(run, lat, cond, alat, *args, **kw):
            if fault == "no_negative":
                kw["cfg_scale"] = 1.0
            lat2, alat2, neg = orig(run, lat, cond, alat, *args, **kw)
            if fault == "unchanged":
                return lat, alat, neg
            if fault == "altered":
                lat2 = lat2.clone()
                lat2[:, :, 0] = lat[:, :, 0]
            return lat2, alat2, neg
    else:
        from dualforce_tpu_torch.engine.trainer import LoRATrainer as target

        name = "_apply" if fault == "unchanged" else "_grads"
        orig = getattr(target, name)

        def broken(self, *args, **kw):
            if fault == "unchanged":
                from dualforce_tpu_torch.engine.optim import global_norm

                return global_norm(args[0])
            grads, metrics = orig(self, *args, **kw)
            return [g * 2 if i == 0 else g for i, g in enumerate(grads)], metrics
    setattr(target, name, broken)
    try:
        yield
    finally:
        setattr(target, name, orig)
