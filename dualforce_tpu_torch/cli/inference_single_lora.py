"""Single-clip inference with a LoRA merged into a MOVA checkpoint
(counterpart of `scripts/inference_single_lora.py`, flag for flag, plus
`--device`):

    python -m dualforce_tpu_torch.cli.inference_single_lora --base_model CKPT \\
        --lora_path lora_weights.npz --prompt "..." --ref_path first_frame.png

The LoRA is the port's or the JAX package's `.npz` (+ `.json`), or a
reference trainer's `.pt` state dict or directory (`lora_weights.pt`,
`lora_config.pt`). Its factors are merged into the base weights, W + (a b)^T
* alpha / r * scale in fp32 rounded once to the weight's dtype, before any
fp8 cast (merging into fp8 storage would lose the delta). Each module is
merged on the device it is loaded on; with `--offload cpu` or `component`
it is page-locked only after that, one module at a time. (The JAX CLI
merges on the host under `--offload`, where a TPU's memory cannot hold a
tower beside the factors; the H100's 80 GB can.) `--offload group` streams
the merged experts through the card in layer groups.
"""

from __future__ import annotations

import argparse
import os
import time

from dualforce_tpu_torch.cli.inference_single import (add_common_args, device_and_mesh,
                                                      finish, first_frame, offload_kwargs,
                                                      offload_mode, refuse_unported, shard)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dualforce_tpu_torch.cli.inference_single_lora",
        description="Generate one clip with a LoRA merged into the base model.")
    p.add_argument("--base_model", type=str, required=True)
    p.add_argument("--lora_path", type=str, required=True)
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="override the alpha stored with the LoRA")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--merge_lora", action="store_true",
                   help="accepted for compatibility: the LoRA is always merged")
    add_common_args(p, "output_lora.mp4", ["none", "int8"])
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def load_any_lora(path: str, cfg):
    """(LoRA, {"alpha", "rank"}) from a reference `.pt` or directory, or an
    `.npz` written by either package's `save_lora`."""
    if path.endswith(".pt") or os.path.exists(os.path.join(path, "lora_weights.pt")):
        from dualforce_tpu_torch.convert.lora_import import load_reference_lora

        return load_reference_lora(path, cfg)
    from dualforce_tpu_torch.engine.lora import load_lora

    return load_lora(path, cfg.bridge.interaction_layers())


def load_merged(args: argparse.Namespace, cfg, lora, alpha: float, device, dtype):
    """The checkpoint's modules with the LoRA merged into the towers (then
    cast to fp8 under `--weight_dtype fp8`), each on `device` as it is
    loaded and before `--offload` page-locks it. Returns (modules, merge
    seconds)."""
    import torch

    from dualforce_tpu_torch import nn as dnn
    from dualforce_tpu_torch.convert.load_checkpoint import load_pipeline_params
    from dualforce_tpu_torch.engine.lora import DEFAULT_MODULES, merge_lora_into

    merge_s = []

    def merge(name, module):
        if name not in DEFAULT_MODULES:
            return
        t0 = time.perf_counter()
        if lora.get(name):
            merge_lora_into(module, lora[name], alpha, args.lora_scale)
        if args.weight_dtype == "fp8":
            dnn.cast_modules_fp8(module, torch.float8_e4m3fn)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        merge_s.append(time.perf_counter() - t0)

    modules = load_pipeline_params(args.base_model, cfg, dtype=dtype, device=device,
                                   host=offload_mode(args) != "none", prepare=merge)
    return modules, sum(merge_s)


def run(args: argparse.Namespace, tokenizer=None, image=None, dtype=None):
    """Load the base checkpoint and the LoRA, merge, build the pipeline and
    generate one clip (arguments as `inference_single.run`). Returns
    (GenerationResult, MOVAPipeline)."""
    refuse_unported(args)
    import torch

    from dualforce_tpu_torch.convert.load_checkpoint import (config_from_checkpoint,
                                                             load_tokenizer)
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.utils.misc import device_timer

    device, mesh = device_and_mesh(args)
    dtype = dtype or torch.bfloat16
    cfg = config_from_checkpoint(args.base_model)
    lora, meta = load_any_lora(args.lora_path, cfg)
    alpha = args.lora_alpha if args.lora_alpha is not None else meta["alpha"]
    modules, merge_s = load_merged(args, cfg, lora, alpha, device, dtype)
    print(f"[info] merged LoRA (rank={meta['rank']}, alpha={alpha}, scale={args.lora_scale}, "
          f"weight_dtype={args.weight_dtype}) in {merge_s:.2f} s", flush=True)
    pipe = MOVAPipeline(cfg, shard(modules, mesh, device),
                        tokenizer=tokenizer or load_tokenizer(args.base_model),
                        compute_dtype=dtype, device=device, attn_impl=args.attn_type,
                        quantize=args.quantize, mesh=mesh, **offload_kwargs(args))
    frame = first_frame(args, image)
    with device_timer("generation", device):
        result = pipe(prompt=args.prompt, image=frame, negative_prompt=args.negative_prompt,
                      seed=args.seed, height=args.height, width=args.width,
                      num_frames=args.num_frames, video_fps=args.fps,
                      num_inference_steps=args.num_inference_steps,
                      sigma_shift=args.sigma_shift, cfg_scale=args.cfg_scale,
                      cfg_scale_bridge=args.cfg_scale_bridge)
    return result, pipe


def main(argv=None, tokenizer=None, image=None, dtype=None):
    """Parse, generate (`run`, whose overrides these are) and write (rank
    0); returns the GenerationResult."""
    args = parse_args(argv)
    result, _ = run(args, tokenizer=tokenizer, image=image, dtype=dtype)
    finish(args, result)
    return result


if __name__ == "__main__":
    main()
