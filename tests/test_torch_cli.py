"""The port's inference CLIs (`dualforce_tpu_torch/cli/`) on the CPU: `--help`
without JAX, PIL or transformers; every flag of the JAX package's CLIs
accepted with the same destination, default and choices; the flags once
refused with a ROADMAP item now passing; one tiny request through
`inference_single.run` against the JAX package's pipeline; the same
request through `--offload group` (with its group size, resident audio and
bridge, resident groups) and a disk store, bit-equal to it; and through
`--vae_encode_dtype bf16`, bit-equal to the in-process bf16 pipeline.

The tiny request reads an fp32 checkpoint written by the port's writer and
a PNG written with PIL, in fp32 weights and compute with `--attn_type ref`.
The JAX pipeline reads the same files (its own loader and transforms). The
two draw their noise differently (torch and jax generators), so JAX denoises
from the port's noise: condition and text contexts within 1e-4 / 1e-5, the
uint8 video at most 1 level off in under 1 % of its values and the audio
within 1e-4, the tolerances of `tests/test_torch_pipeline.py`.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dualforce_tpu.convert import load_checkpoint as jax_lc
from dualforce_tpu.data import transforms as jax_transforms
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline

from dualforce_tpu_torch.cli import inference_single as cli
from dualforce_tpu_torch.cli import inference_single_lora as lora_cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.utils.av_io import read_mjpeg_avi

from test_torch_pipeline import FakeTokenizer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
CLIS = {"inference_single.py": cli, "inference_single_lora.py": lora_cli}


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_help_loads_neither_jax_pil_nor_transformers():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['prog', '--help']\n"
        "try:\n"
        "    runpy.run_module(MODULE, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'dualforce_tpu', 'PIL', 'transformers')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code.replace("MODULE", repr(m))],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for m in ("dualforce_tpu_torch.cli.inference_single",
                       "dualforce_tpu_torch.cli.inference_single_lora")]
    for p, flag in zip(procs, ("--ckpt_path", "--lora_path")):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
        assert flag in out and "--device" in out and "BAD []" in out


class _Grabbed(Exception):
    pass


def _jax_parser(script, monkeypatch):
    """The argparse parser the JAX package's CLI script builds (captured as
    its `parse_args` parses)."""
    spec = importlib.util.spec_from_file_location(f"_jax_cli_{script[:-3]}",
                                                  REPO / "scripts" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise _Grabbed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Grabbed):
        mod.parse_args()
    monkeypatch.undo()
    return grabbed["parser"]


@pytest.mark.parametrize("script", sorted(CLIS))
def test_flags_are_a_superset_of_the_jax_cli(script, monkeypatch):
    jax_parser = _jax_parser(script, monkeypatch)
    port = {s: a for a in CLIS[script].build_parser()._actions for s in a.option_strings}
    for action in jax_parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        for s in action.option_strings:
            assert s in port, s
            mine = port[s]
            assert (mine.dest, mine.choices, mine.required) == \
                (action.dest, action.choices, action.required), s
            if action.dest != "compile_cache":   # a path under ~ in JAX's; unused here
                assert mine.default == action.default, s
    assert "--device" in port and port["--device"].default == "cuda"


# the flags that once exited naming the ROADMAP item that would port them; all are
# ported now
UNPORTED = [
    (["--vae_encode_dtype", "bf16"], "A1"),
]


@pytest.mark.parametrize("extra,item", UNPORTED, ids=lambda x: "-".join(x)
                         if isinstance(x, list) else x)
def test_unported_flags_exit_with_their_roadmap_item(extra, item, tmp_path):
    """No flag of `UNPORTED` exits any more: each passes `refuse_unported`
    and the run goes on to read the (absent) checkpoint."""
    base = ["--prompt", "x", "--ref_path", "x.png", "--device", "cpu"]
    args = cli.parse_args(["--ckpt_path", str(tmp_path / "absent")] + base + extra)
    cli.refuse_unported(args)
    with pytest.raises(FileNotFoundError):
        cli.run(args)


def test_accepted_no_op_flags_parse(tmp_path):
    args = cli.parse_args(["--ckpt_path", "c", "--prompt", "x", "--ref_path", "r",
                           "--remove_video_dit", "--compile_cache", str(tmp_path),
                           "--vae_encode_dtype", "fp32", "--offload", "cpu"])
    cli.refuse_unported(args)
    assert cli.offload_mode(args) == "component"


REQUEST = ["--height", "32", "--width", "32", "--num_frames", "5",
           "--num_inference_steps", "2", "--cfg_scale", "5", "--sigma_shift", "5",
           "--visual_shift", "4", "--seed", "7", "--negative_prompt", "blurry",
           "--prompt", "a cat playing piano", "--attn_type", "ref", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(root / "ckpt"))
    png = root / "ref.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (40, 48, 3), np.uint8)).save(png)
    args = cli.parse_args(["--ckpt_path", str(root / "ckpt"), "--ref_path", str(png),
                           "--output", str(root / "out.mp4")] + REQUEST)
    result, pipe = cli.run(args, tokenizer=FakeTokenizer(), dtype=torch.float32)
    return dict(args=args, result=result, pipe=pipe, root=root)


def test_tiny_request_matches_jax(tiny_run):
    args, res, pipe = tiny_run["args"], tiny_run["result"], tiny_run["pipe"]
    with Image.open(args.ref_path) as im:
        jframe = jax_transforms.image_to_tensor(
            jax_transforms.crop_and_resize(im.convert("RGB"), args.height, args.width))
    frame = cli.first_frame(args)
    np.testing.assert_array_equal(frame, jframe)
    kw = dict(height=32, width=32, num_frames=5, num_inference_steps=2, sigma_shift=5.0,
              visual_shift=4.0, cfg_scale=5.0)
    state = pipe.prepare_state([args.prompt], [frame], negative_prompts=["blurry"],
                               seeds=[7], **kw)
    jparams = jax_lc.load_pipeline_params(args.ckpt_path, dtype=jnp.float32,
                                          to_device=False)
    jpipe = JaxPipeline(jax_lc.config_from_checkpoint(args.ckpt_path), jparams,
                        tokenizer=FakeTokenizer(), compute_dtype=jnp.float32,
                        attn_impl="ref")
    jstate = jpipe.prepare_state([args.prompt], [jframe], negative_prompts=["blurry"],
                                 seeds=[7], **kw)
    for key in ("condition", "ctx_pos", "ctx_neg"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    jstate = dict(jstate, latents=state["latents"].numpy(),
                  audio_latents=state["audio_latents"].numpy())
    want = jpipe.finalize_state(jpipe.denoise_state(jstate))[0]
    assert res.video.shape == want.video.shape == (5, 32, 32, 3)
    diff = np.abs(res.video.astype(np.int16) - want.video.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.01
    np.testing.assert_allclose(res.audio, want.audio, rtol=1e-4, atol=1e-4)


def test_tiny_request_output_file(tiny_run):
    out = cli.save(tiny_run["args"], tiny_run["result"])
    video, audio, sample_rate, fps = read_mjpeg_avi(out)
    assert video.shape == tiny_run["result"].video.shape
    assert audio.shape == tiny_run["result"].audio.shape
    assert (sample_rate, fps) == (48000, 24.0)


def test_vae_encode_dtype_bf16_serves(tiny_run):
    """`--vae_encode_dtype bf16` reaches the pipeline, and the request gives
    the bits of the same request through an in-process
    `MOVAPipeline(vae_encode_dtype="bf16")` on the loaded modules; the LoRA
    CLI has no such flag, as the JAX script has none."""
    args = cli.parse_args(["--ckpt_path", str(tiny_run["root"] / "ckpt"),
                           "--ref_path", tiny_run["args"].ref_path, "--vae_encode_dtype",
                           "bf16"] + REQUEST)
    result, pipe = cli.run(args, tokenizer=FakeTokenizer(), dtype=torch.float32)
    assert pipe.vae_encode_dtype == torch.bfloat16
    mine = MOVAPipeline(pipe.cfg, pipe.modules, tokenizer=FakeTokenizer(),
                        compute_dtype=torch.float32, device="cpu", attn_impl="ref",
                        vae_encode_dtype="bf16")
    want = mine(prompt=args.prompt, image=cli.first_frame(args),
                negative_prompt=args.negative_prompt, seed=args.seed, height=args.height,
                width=args.width, num_frames=args.num_frames, video_fps=args.fps,
                num_inference_steps=args.num_inference_steps, sigma_shift=args.sigma_shift,
                visual_shift=args.visual_shift, cfg_scale=args.cfg_scale)
    np.testing.assert_array_equal(result.video, want.video)
    np.testing.assert_array_equal(result.audio, want.audio)
    assert not np.array_equal(result.video, tiny_run["result"].video)
    with pytest.raises(SystemExit):
        lora_cli.parse_args(["--base_model", "c", "--lora_path", "l", "--prompt", "x",
                             "--ref_path", "r", "--vae_encode_dtype", "bf16"])


# the flags A9 opened (once refused), each on the tiny request of `tiny_run`
GROUP_FLAGS = {
    "offload_group": ["--offload", "group"],
    "offload_resident_small": ["--offload", "group", "--offload_resident_small",
                               "--offload_group_size", "1"],
    "offload_resident_groups": ["--offload", "group", "--offload_resident_groups", "1",
                                "--offload_group_size", "1"],
    "offload_to_disk_path": ["--offload", "group", "--offload_to_disk_path", "STORE"],
}


@pytest.mark.parametrize("name", sorted(GROUP_FLAGS))
def test_group_and_disk_flags_serve_the_same_bits(tiny_run, name):
    """Each flag parses as the JAX CLI parses it into the pipeline's offload
    arguments, and the request gives `tiny_run`'s bits."""
    extra = [str(tiny_run["root"] / "store") if a == "STORE" else a
             for a in GROUP_FLAGS[name]]
    args = cli.parse_args(["--ckpt_path", str(tiny_run["root"] / "ckpt"),
                           "--ref_path", tiny_run["args"].ref_path] + REQUEST + extra)
    cli.refuse_unported(args)
    kw = cli.offload_kwargs(args)
    assert kw["offload"] == "group"
    assert kw["offload_resident_small"] == ("--offload_resident_small" in extra)
    assert kw["offload_resident_video_groups"] == (1 if name == "offload_resident_groups"
                                                   else 0)
    result, pipe = cli.run(args, tokenizer=FakeTokenizer(), dtype=torch.float32)
    assert pipe.offload == "group" and pipe.offload_group_size == args.offload_group_size
    np.testing.assert_array_equal(result.video, tiny_run["result"].video)
    np.testing.assert_array_equal(result.audio, tiny_run["result"].audio)
