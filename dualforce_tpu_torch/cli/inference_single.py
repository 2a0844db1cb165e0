"""Single-clip TI2VA inference from a MOVA checkpoint (counterpart of
`scripts/inference_single.py`, flag for flag, plus `--device`):

    python -m dualforce_tpu_torch.cli.inference_single --ckpt_path CKPT \\
        --prompt "a cat playing the piano" --ref_path first_frame.png \\
        --output out.mp4

It runs on the CUDA card unless `--device cpu` asks for the CPU (the plain
PyTorch path, for tiny checkpoints). Weights stay resident on the card
(`--offload none`), wait in page-locked host memory and are staged per
phase (`--offload cpu` or `component`), or besides stream the active expert
through the card in layer groups in every pass (`--offload group`);
`--offload_to_disk_path DIR` keeps them as memmaps of a store in DIR
instead (exported from the checkpoint on the first run). Flags of parts not
yet ported exit with a message that names their ROADMAP item. Importing
this module loads neither the model code, PIL nor transformers, so
`--help` is quick.

Sequence and weight parallelism run one process per rank under torchrun:

    torchrun --nproc-per-node 2 -m dualforce_tpu_torch.cli.inference_single \
        --ckpt_path CKPT --prompt ... --ref_path IMG --cp_size 2

`--cp_size` splits the token sequences, `--fsdp_size` the block weights;
the world must hold cp * fsdp processes. The backend is NCCL when each rank
has a card of its own and gloo otherwise (`parallel.mesh.choose_backend`);
only rank 0 writes the clip.
"""

from __future__ import annotations

import argparse

# the attention routes of `MOVAPipeline(attn_impl=...)` (`ops.attention.ATTN_IMPLS`)
ATTN_TYPES = ["auto", "fast", "sage", "pallas", "ref"]


def add_common_args(p: argparse.ArgumentParser, output: str, quantize) -> None:
    """The flags both inference CLIs share."""
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--ref_path", type=str, required=True,
                   help="reference first-frame image (read with PIL)")
    p.add_argument("--output", "--output_path", dest="output", type=str, default=output)
    p.add_argument("--num_frames", type=int, default=193)
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--height", type=int, default=352)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--cfg_scale_bridge", type=float, default=0.0,
                   help="dual-CFG cross-modal guidance s_B; 0 disables the third "
                        "bridge-off pass")
    p.add_argument("--sigma_shift", type=float, default=5.0)
    p.add_argument("--cp_size", type=int, default=1,
                   help="sequence parallelism: ranks that split the token sequences "
                        "(run under torchrun with cp_size * fsdp_size processes)")
    p.add_argument("--fsdp_size", type=int, default=1,
                   help="weight sharding: ranks that split the block weights")
    p.add_argument("--attn_type", type=str, default="auto", choices=ATTN_TYPES,
                   help="attention route (`MOVAPipeline(attn_impl=...)`)")
    p.add_argument("--offload", type=str, default="none",
                   choices=["none", "cpu", "group", "component"],
                   help="'cpu'/'component': the modules wait in page-locked host "
                        "memory and each is staged to the card for its phase (the "
                        "two video experts never together); 'group' besides streams "
                        "the active expert's blocks through the card in layer groups "
                        "in every pass (the smallest footprint); default keeps the "
                        "weights resident on the card")
    p.add_argument("--offload_group_size", type=int, default=8,
                   help="with --offload group: DiT layers per streamed group")
    p.add_argument("--weight_dtype", type=str, default="bf16", choices=["bf16", "fp8"],
                   help="fp8 stores the matmul weights as float8_e4m3 (half the "
                        "memory; compute stays bf16)")
    p.add_argument("--quantize", type=str, default="none", choices=quantize,
                   help="int8: w8a8 DiT and bridge projections; int4: packed int4 "
                        "tower weights; lossy, inference only, compose with "
                        "--attn_type sage")
    p.add_argument("--compile_cache", type=str, default="",
                   help="accepted for the JAX CLI's sake and unused: the port has "
                        "no XLA compile to cache")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain PyTorch path)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dualforce_tpu_torch.cli.inference_single",
        description="Generate one clip with audio from a prompt and a first frame.")
    p.add_argument("--ckpt_path", type=str, required=True)
    add_common_args(p, "output.mp4", ["none", "int8", "int4"])
    p.add_argument("--visual_shift", type=float, default=None)
    p.add_argument("--audio_shift", type=float, default=None)
    p.add_argument("--offload_resident_small", action="store_true",
                   help="group offload: keep the audio tower and the bridge on the card, "
                        "stream only the video tower")
    p.add_argument("--offload_resident_groups", "--resident_groups", type=int, default=0,
                   help="group offload: keep the first N video layer groups on the card "
                        "across passes (--resident_groups is accepted as an alias)")
    p.add_argument("--offload_to_disk_path", type=str, default=None, metavar="DIR",
                   help="with --offload: keep the weights as memmaps of a store in DIR "
                        "(exported on the first run), so the host holds page cache "
                        "instead of the weights")
    p.add_argument("--remove_video_dit", action="store_true",
                   help="accepted and unused, as in the JAX CLI (which parses it "
                        "and never reads it)")
    p.add_argument("--cfg_cache_interval", type=int, default=1,
                   help="recompute the CFG negative pass every N steps and reuse it "
                        "in between (1 = exact)")
    p.add_argument("--cfg_batch", action="store_true",
                   help="batch the positive and negative CFG passes in one forward")
    p.add_argument("--mask_ctx_pad", action="store_true",
                   help="cross-attend only the prompt's tokens through the kernel's "
                        "kv mask (the reference attends the zero pads)")
    p.add_argument("--vae_encode_dtype", type=str, default=None, choices=["fp32", "bf16"],
                   help="VAE encoder compute dtype for prepare_latents; bf16 halves the "
                        "streaming encode's activation memory (the JAX CLI needs it at "
                        "720p on 16 GB chips)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the generation to DIR "
                        "(trace.json, and device_ops.json with time per operation)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit where the JAX CLI refuses the flags: a disk store without
    offload, or offload under a mesh. Every flag of the JAX CLI is ported."""
    if args.cp_size * args.fsdp_size > 1 and offload_mode(args) != "none":
        raise SystemExit("--offload is for single-chip runs; use --fsdp_size to shard "
                         "weights across chips instead")
    if getattr(args, "offload_to_disk_path", None) and args.offload == "none":
        raise SystemExit("--offload_to_disk_path requires --offload cpu/group/component")


def offload_mode(args: argparse.Namespace) -> str:
    """The pipeline's offload mode for `--offload` ("cpu" is "component")."""
    return {"cpu": "component"}.get(args.offload, args.offload)


def offload_kwargs(args: argparse.Namespace) -> dict:
    """`MOVAPipeline`'s offload arguments from the flags (those a CLI lacks
    at their defaults)."""
    return dict(offload=offload_mode(args), offload_group_size=args.offload_group_size,
                offload_resident_small=getattr(args, "offload_resident_small", False),
                offload_resident_video_groups=getattr(args, "offload_resident_groups", 0))


def device_and_mesh(args: argparse.Namespace):
    """(this rank's device, the (1, fsdp, cp) mesh or None): under
    `--cp_size`/`--fsdp_size` the process joins the torchrun world first
    (`parallel.mesh.initialize_distributed`), and a world that does not
    hold cp * fsdp processes raises before anything is read."""
    from dualforce_tpu_torch import resolve_device

    if args.cp_size * args.fsdp_size == 1:
        return resolve_device(args.device), None
    from dualforce_tpu_torch.parallel.mesh import create_mesh, initialize_distributed

    device = initialize_distributed(args.device)
    return device, create_mesh(1, args.fsdp_size, args.cp_size)


def shard(modules, mesh, device):
    """The modules' block weights sharded over the mesh's fsdp axis
    (`parallel.sharding.shard_params`), the bytes this rank holds printed."""
    if mesh is None:
        return modules
    from dualforce_tpu_torch.parallel import sharding
    from dualforce_tpu_torch.parallel.mesh import mesh_shape, rank
    from dualforce_tpu_torch.utils.misc import hbm_in_use_gb

    whole = sharding.block_bytes(modules)
    sharding.shard_params(modules, mesh)
    print(f"[info] rank {rank()}: mesh {mesh_shape(mesh)}; block weights "
          f"{sharding.block_bytes(modules) / 1e9:.3f} of {whole / 1e9:.3f} GB held here; "
          f"card memory in use {hbm_in_use_gb(device):.2f} GB", flush=True)
    return modules


def load_modules(args: argparse.Namespace, ckpt: str, cfg, dtype, device):
    """The checkpoint's modules for the pipeline: resident on `device`, in
    page-locked host memory under `--offload`, or, with
    `--offload_to_disk_path`, memmaps of the store there. The store is
    exported (one module at a time) unless its manifest's fingerprint
    (checkpoint path, `--weight_dtype`, newest mtime, as the JAX CLI's)
    matches; a matching store is read from the manifest alone."""
    import os

    from dualforce_tpu_torch.convert.load_checkpoint import load_pipeline_params

    offload = offload_mode(args)
    store = getattr(args, "offload_to_disk_path", None)
    if not store:
        return load_pipeline_params(ckpt, cfg, dtype=dtype, device=device,
                                    host=offload != "none")
    from dualforce_tpu_torch.convert import disk_store

    ckpt = os.path.abspath(ckpt)
    mtime = max((os.path.getmtime(os.path.join(ckpt, e)) for e in os.listdir(ckpt)),
                default=0.0)
    fp = f"{ckpt}|{args.weight_dtype}|{mtime:.0f}"
    if not disk_store.store_matches(None, store, fingerprint=fp):
        print(f"[info] exporting params to {store} (one-time)", flush=True)
        nbytes, seconds = disk_store.export_checkpoint(ckpt, cfg, dtype, device, store, fp)
        print(f"[info] store written: {nbytes / 1e9:.3f} GB in {seconds:.2f} s", flush=True)
    else:
        print(f"[info] store {store} matches the checkpoint; no export", flush=True)
    print("[info] params are disk-backed memmaps; modules stream disk -> card per phase",
          flush=True)
    return disk_store.load_modules_mmap(store, cfg)


def first_frame(args: argparse.Namespace, image=None):
    """The first frame as float32 [height, width, 3] in [-1, 1]: `image` as
    given (an array already so), or `--ref_path` read with PIL, scaled and
    center-cropped."""
    import numpy as np

    if image is None:
        from PIL import Image

        from dualforce_tpu_torch.data.transforms import crop_and_resize, image_to_tensor

        with Image.open(args.ref_path) as im:
            image = image_to_tensor(crop_and_resize(im.convert("RGB"), args.height,
                                                    args.width))
    image = np.asarray(image, np.float32)
    if image.shape != (args.height, args.width, 3):
        raise ValueError(f"first frame {image.shape}, expected "
                         f"{(args.height, args.width, 3)}")
    return image


def run(args: argparse.Namespace, tokenizer=None, image=None, dtype=None):
    """Load the checkpoint, build the pipeline and generate one clip.
    tokenizer: the checkpoint's (`load_tokenizer`) unless given; image: the
    first frame instead of `--ref_path` (see `first_frame`); dtype: the
    towers' and UMT5's weight dtype under `--weight_dtype bf16` and the
    compute dtype (bf16 unless given). Returns (GenerationResult,
    MOVAPipeline)."""
    refuse_unported(args)
    import torch

    from dualforce_tpu_torch.convert.load_checkpoint import (config_from_checkpoint,
                                                             load_tokenizer)
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.parallel.mesh import rank
    from dualforce_tpu_torch.utils.misc import device_timer, hbm_in_use_gb, profile_trace

    device, mesh = device_and_mesh(args)
    dtype = dtype or torch.bfloat16
    cfg = config_from_checkpoint(args.ckpt_path)
    wdtype = torch.float8_e4m3fn if args.weight_dtype == "fp8" else dtype
    modules = load_modules(args, args.ckpt_path, cfg, wdtype, device)
    if device.type == "cuda":
        print(f"[info] card memory in use after loading: {hbm_in_use_gb(device):.2f} GB",
              flush=True)
    pipe = MOVAPipeline(cfg, shard(modules, mesh, device),
                        tokenizer=tokenizer or load_tokenizer(args.ckpt_path),
                        compute_dtype=dtype, device=device, attn_impl=args.attn_type,
                        quantize=args.quantize, mask_ctx_pad=args.mask_ctx_pad, mesh=mesh,
                        vae_encode_dtype=args.vae_encode_dtype, **offload_kwargs(args))
    frame = first_frame(args, image)
    trace = args.profile if rank() == 0 else None
    with profile_trace(trace), device_timer("generation", device):
        result = pipe(prompt=args.prompt, image=frame, negative_prompt=args.negative_prompt,
                      seed=args.seed, height=args.height, width=args.width,
                      num_frames=args.num_frames, video_fps=args.fps,
                      num_inference_steps=args.num_inference_steps,
                      sigma_shift=args.sigma_shift, visual_shift=args.visual_shift,
                      audio_shift=args.audio_shift, cfg_scale=args.cfg_scale,
                      cfg_batch=args.cfg_batch, cfg_cache_interval=args.cfg_cache_interval,
                      cfg_scale_bridge=args.cfg_scale_bridge)
    return result, pipe


def save(args: argparse.Namespace, result) -> str:
    """Write the clip to `--output` (`save_video_with_audio`); returns the
    path written (an .avi beside it without ffmpeg)."""
    from dualforce_tpu_torch.utils.av_io import save_video_with_audio

    out = save_video_with_audio(args.output, result.video, result.audio, fps=result.fps,
                                sample_rate=result.sample_rate)
    print(f"[done] saved {out}")
    return out


def finish(args: argparse.Namespace, result) -> None:
    """Rank 0 writes the clip (`save`), after the last collective; every
    rank then leaves the process group."""
    from dualforce_tpu_torch.parallel.mesh import leave, rank

    if rank() == 0:
        save(args, result)
    leave()


def main(argv=None, tokenizer=None, image=None, dtype=None):
    """Parse, generate (`run`, whose overrides these are) and write; returns
    the GenerationResult."""
    args = parse_args(argv)
    result, _ = run(args, tokenizer=tokenizer, image=image, dtype=dtype)
    finish(args, result)
    return result


if __name__ == "__main__":
    main()
