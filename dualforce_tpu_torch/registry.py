"""Named registries (counterpart of `dualforce_tpu/registry.py`).

Six registries map a `type` string to a callable, and `build` instantiates
one from a config dict ({"type": name, **kwargs}), the convention of the
reference's training configs. Each registry knows the modules that register
into it (`locations`) and imports them at its first miss, so a lookup works
whatever was imported before and this module imports nothing of the
package itself. The keys are the JAX package's; where the JAX package
registers a function that builds a parameter tree (MODELS), the port
registers the module class that holds those parameters.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterator, Optional, Sequence


class Registry:
    def __init__(self, name: str, locations: Sequence[str] = ()):
        self.name = name
        self._items: Dict[str, Callable] = {}
        self._locations = list(locations)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Register a callable. Usable as a decorator (with or without a
        name) or as a direct call."""
        if module is not None:
            key = name or module.__name__
            if key in self._items and self._items[key] is not module:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._items[key] = module
            return module

        def _decorator(mod):
            self.register_module(name=name, module=mod)
            return mod

        return _decorator

    def _import_locations(self) -> None:
        while self._locations:
            importlib.import_module(self._locations.pop())

    def get(self, key: str) -> Callable:
        if key not in self._items:
            self._import_locations()
        if key not in self._items:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; available: {sorted(self._items)}")
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        if key not in self._items:
            self._import_locations()
        return key in self._items

    def build(self, cfg: Dict[str, Any], **extra):
        """Instantiate from a config dict: {'type': <name>, **kwargs}."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"build() needs a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        cls = self.get(cfg.pop("type"))
        return cls(**cfg, **extra)

    def keys(self):
        return self._items.keys()

    # read as a name table too (`sorted(OPTIMIZERS)`, `OPTIMIZERS[name]`), every
    # location imported first
    def __getitem__(self, key: str) -> Callable:
        return self.get(key)

    def __iter__(self) -> Iterator[str]:
        self._import_locations()
        return iter(list(self._items))

    def __len__(self) -> int:
        self._import_locations()
        return len(self._items)


DATASETS = Registry("datasets", locations=["dualforce_tpu_torch.data.dataset"])
TRANSFORMS = Registry("transforms", locations=["dualforce_tpu_torch.data.transforms"])
DIFFUSION_PIPELINES = Registry(
    "diffusion_pipelines", locations=["dualforce_tpu_torch.diffusion.pipeline"])
MODELS = Registry("models", locations=[
    "dualforce_tpu_torch.models.factory", "dualforce_tpu_torch.models.dac_vae"])
DIFFUSION_SCHEDULERS = Registry(
    "diffusion_schedulers", locations=["dualforce_tpu_torch.diffusion.flow_match"])
OPTIMIZERS = Registry("optimizers", locations=["dualforce_tpu_torch.engine.optim"])
