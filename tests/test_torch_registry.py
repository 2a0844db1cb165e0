"""The port's registries (`dualforce_tpu_torch/registry.py`), its
`FlowMatchEulerDiscreteScheduler` and its config JSON helpers against the
JAX package's on the CPU.

- The six registries hold JAX's key sets once both sides' `locations` are
  imported; `build({"type": ...})` builds an entry of each; `Registry`
  behaves as JAX's class does (decorator with and without a name, direct
  call, duplicate and missing keys, a config without `type`, lazy
  locations). MODELS maps JAX's names to the port's module classes (JAX's
  to functions that build parameter trees).
- `FlowMatchEulerDiscreteScheduler` for N in {1, 4, 50} and shift in
  {1, 5}: `timesteps` and `sigmas` equal in float32, and a whole trajectory
  of `scale_noise` then `step` within 1e-6 absolute of JAX's, on numpy
  arrays and on torch tensors; `return_dict=True` raises before the index
  moves, in both.
- `save_json`/`load_json` across packages into equal dataclasses, the JSON
  text byte-equal; `mova_720p() == mova_360p()`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from dualforce_tpu import config as jax_config
from dualforce_tpu import registry as jax_registry
from dualforce_tpu.diffusion import flow_match as jax_fm

from dualforce_tpu_torch import config, registry
from dualforce_tpu_torch.diffusion import flow_match as fm
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

NAMES = ("MODELS", "DATASETS", "DIFFUSION_PIPELINES", "DIFFUSION_SCHEDULERS", "OPTIMIZERS",
         "TRANSFORMS")
TRAJECTORY_ATOL = 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_registry_keys_match_jax(name):
    mine, theirs = getattr(registry, name), getattr(jax_registry, name)
    theirs._import_locations()
    assert mine.name == theirs.name
    assert set(mine) == set(theirs.keys())
    assert set(mine.keys()) == set(theirs.keys())
    assert len(mine) == len(theirs.keys())


def _build_case(name, tmp_path):
    """(config dict, check of what `build` returned) for one entry of the
    registry `name`."""
    cfg = config.tiny_test_config()
    if name == "MODELS":
        from dualforce_tpu_torch.models.wan_vae import WanVAE

        return ({"type": "WanVAE", "cfg": cfg.video_vae, "device": "meta"},
                lambda m: isinstance(m, WanVAE) and m.cfg == cfg.video_vae)
    if name == "DATASETS":
        meta = tmp_path / "metadata.json"
        meta.write_text(json.dumps([{"video_path": "a.npz", "caption": "x"}]))
        return ({"type": "VideoAudioDataset", "metadata_path": str(meta), "height": 32,
                 "width": 48, "num_frames": 5},
                lambda d: len(d) == 1 and (d.height, d.width, d.num_frames) == (32, 48, 5))
    if name == "DIFFUSION_PIPELINES":
        modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
        return ({"type": "MOVAPipeline", "cfg": cfg, "modules": modules, "device": "cpu",
                 "attn_impl": "ref", "vae_encode_dtype": "bf16"},
                lambda p: p.modules is modules and p.vae_encode_dtype == torch.bfloat16)
    if name == "DIFFUSION_SCHEDULERS":
        want = jax_registry.DIFFUSION_SCHEDULERS.build(
            {"type": "FlowMatchEulerDiscreteScheduler", "shift": 5.0})
        want.set_timesteps(7)

        def check(s):
            s.set_timesteps(7)
            return (np.array_equal(s.timesteps, want.timesteps)
                    and np.array_equal(s.sigmas, want.sigmas))

        return {"type": "FlowMatchEulerDiscreteScheduler", "shift": 5.0}, check
    if name == "OPTIMIZERS":
        from dualforce_tpu_torch.engine.optim import OptaxChain

        return ({"type": "Lion", "params": [torch.zeros(4, 4)], "lr": 1e-3},
                lambda o: isinstance(o, OptaxChain))
    image = Image.fromarray(np.random.default_rng(0).integers(0, 256, (20, 30, 3), np.uint8))
    want = np.asarray(jax_registry.TRANSFORMS.build({"type": "TVCenterCrop", "size": 8})(image))
    return ({"type": "TVCenterCrop", "size": 8},
            lambda t: np.array_equal(np.asarray(t(image)), want))


@pytest.mark.parametrize("name", NAMES)
def test_build_one_entry_of_each(name, tmp_path):
    cfg, check = _build_case(name, tmp_path)
    assert check(getattr(registry, name).build(cfg))
    with pytest.raises(TypeError, match="'type' key"):
        getattr(registry, name).build({k: v for k, v in cfg.items() if k != "type"})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_registry_class_behaves_as_jax(pkg):
    cls = registry.Registry if pkg == "port" else jax_registry.Registry
    r = cls("things")

    @r.register_module()
    def plain(x=1):
        return ("plain", x)

    @r.register_module(name="Named")
    def other(x=2):
        return ("named", x)

    r.register_module(name="Direct", module=plain)
    r.register_module(module=plain)                      # the same object again: no error
    with pytest.raises(KeyError, match="already registered"):
        r.register_module(name="plain", module=other)
    assert sorted(r.keys()) == ["Direct", "Named", "plain"]
    assert "Named" in r and "absent" not in r
    assert r.build({"type": "Named", "x": 5}) == ("named", 5)
    assert r.build({"type": "plain"}, x=7) == ("plain", 7)
    with pytest.raises(KeyError, match="'absent' not found in registry 'things'"):
        r.get("absent")
    with pytest.raises(TypeError, match="'type' key"):
        r.build(["plain"])
    # a location is imported at the first miss, once
    lazy = cls("lazy", locations=["json"])
    assert "nothing" not in lazy and lazy._locations == []


@pytest.mark.parametrize("shift", [1.0, 5.0])
@pytest.mark.parametrize("steps", [1, 4, 50])
def test_euler_scheduler_matches_jax(steps, shift):
    mine, theirs = fm.FlowMatchEulerDiscreteScheduler(shift=shift), \
        jax_fm.FlowMatchEulerDiscreteScheduler(shift=shift)
    for a, b in ((mine.timesteps, theirs.timesteps), (mine.sigmas, theirs.sigmas)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    mine.set_timesteps(steps)
    theirs.set_timesteps(steps)
    assert len(mine.timesteps) == steps and len(mine.sigmas) == steps + 1
    for a, b in ((mine.timesteps, theirs.timesteps), (mine.sigmas, theirs.sigmas)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for t in mine.timesteps:
        assert mine.index_for_timestep(t) == theirs.index_for_timestep(float(t))

    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)

    def trajectory(sched, to):
        sched.set_timesteps(steps)
        x = sched.scale_noise(to(x0), sched.timesteps[0], to(noise))
        for t in sched.timesteps:
            v = to(noise) - to(x0) + 0.1 * x           # depends on the sample
            x = sched.step(v, t, x, return_dict=False)[0]
        return x

    want = trajectory(theirs, np.asarray)
    got_np = trajectory(mine, np.asarray)
    got_t = trajectory(mine, torch.from_numpy)
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
    np.testing.assert_allclose(got_np, want, rtol=0, atol=TRAJECTORY_ATOL)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=TRAJECTORY_ATOL)


def test_euler_step_return_dict_raises_before_the_index_moves():
    for cls in (fm.FlowMatchEulerDiscreteScheduler, jax_fm.FlowMatchEulerDiscreteScheduler):
        s = cls(shift=5.0)
        s.set_timesteps(4)
        x = np.ones(3, np.float32)
        s.step(x, s.timesteps[0], x)
        with pytest.raises(NotImplementedError, match="return_dict=False"):
            s.step(x, s.timesteps[1], x, return_dict=True)
        assert s._step_index == 1


def _configs(mod):
    return [mod.mova_360p(), mod.mova_720p(),
            mod.tiny_test_config(visual_layers=3, audio_layers=2, dim=64,
                                 interaction_strategy="distributed", apply_cross_rope=False)]


@pytest.mark.parametrize("index", [0, 1, 2], ids=["mova_360p", "mova_720p", "tiny"])
def test_config_json_across_packages(index, tmp_path):
    mine, theirs = _configs(config)[index], _configs(jax_config)[index]
    assert config.to_dict(mine) == jax_config.to_dict(theirs)
    config.save_json(mine, str(tmp_path / "port.json"))
    jax_config.save_json(theirs, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    got = jax_config.load_json(jax_config.MOVAConfig, str(tmp_path / "port.json"))
    back = config.load_json(config.MOVAConfig, str(tmp_path / "jax.json"))
    assert got == theirs and back == mine
    assert dataclasses.asdict(back) == dataclasses.asdict(got)
    sub = config.load_json(config.WanVAEConfig, str(tmp_path / "jax.json"))
    assert sub == config.WanVAEConfig()          # no field of its own in the file


def test_mova_720p_is_mova_360p():
    assert config.mova_720p() == config.mova_360p()
    assert dataclasses.asdict(config.mova_720p()) == dataclasses.asdict(jax_config.mova_720p())
