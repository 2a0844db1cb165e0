"""Launch the generation server and its web UI (counterpart of
`scripts/serve.py`, flag for flag, plus `--device`):

    python -m dualforce_tpu_torch.cli.serve --ckpt_path CKPT --port 8000 \\
        --max_batch 2 --weight_dtype fp8 --cfg_cache_interval 3

It loads the checkpoint, builds the port's `MOVAPipeline`, mounts
`/v1/videos` and the UI (`workflow.app.attach_ui`) and serves. Same-geometry
requests run as one batch when `--max_batch` is above 1. It runs on the CUDA
card unless `--device cpu` asks for the CPU. Flags of parts not yet ported
exit with a message that names their ROADMAP item, as the inference CLI's
do; `--compile_cache` is accepted and unused (the port has no XLA compile).
Importing this module loads neither the model code, PIL nor transformers, so
`--help` is quick.
"""

from __future__ import annotations

import argparse
import time

from dualforce_tpu_torch.cli.inference_single import ATTN_TYPES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dualforce_tpu_torch.cli.serve",
        description="Serve TI2VA requests over HTTP (/v1/videos) with a web UI.")
    ap.add_argument("--ckpt_path", type=str, required=True)
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--out_dir", type=str, default="./server_outputs")
    ap.add_argument("--cp_size", type=int, default=1,
                    help="sequence parallelism: not ported in the server yet (ROADMAP "
                         "A7b), 1 only")
    ap.add_argument("--fsdp_size", type=int, default=1,
                    help="weight sharding: not ported in the server yet (ROADMAP A7b), "
                         "1 only")
    ap.add_argument("--attn_type", type=str, default="auto", choices=ATTN_TYPES,
                    help="attention route (`MOVAPipeline(attn_impl=...)`)")
    ap.add_argument("--quantize", type=str, default="none",
                    choices=["none", "int8", "int4"],
                    help="int8 w8a8 projections (lossy serving accelerator); "
                         "int4 packed tower weights")
    ap.add_argument("--queue_timeout_s", type=float, default=None,
                    help="fail tasks that wait in the queue longer than this "
                         "(per-request timeout_s overrides)")
    ap.add_argument("--mask_ctx_pad", action="store_true",
                    help="cross-attend only each prompt's valid tokens via "
                         "the kernel kv mask (deviates from the reference's "
                         "attend-the-zero-pads semantics)")
    ap.add_argument("--vae_encode_dtype", type=str, default=None,
                    choices=["fp32", "bf16"],
                    help="the VAE encode's compute dtype: fp32 only; bf16 is not "
                         "ported yet (ROADMAP A1)")
    ap.add_argument("--weight_dtype", type=str, default="bf16",
                    choices=["bf16", "fp8"],
                    help="fp8 stores the matmul weights as float8_e4m3 (half the "
                         "memory; compute stays bf16)")
    ap.add_argument("--offload", type=str, default="none",
                    choices=["none", "component", "group"],
                    help="'component': the modules wait in page-locked host memory "
                         "and each is staged to the card for its phase; 'group' besides "
                         "streams the active expert's blocks through the card in layer "
                         "groups in every pass")
    ap.add_argument("--offload_group_size", type=int, default=8,
                    help="with --offload group: DiT layers per streamed group")
    ap.add_argument("--cfg_cache_interval", type=int, default=1,
                    help="recompute the CFG negative pass every N steps and "
                         "reuse it in between (1 = exact)")
    ap.add_argument("--max_batch", type=int, default=1,
                    help="batch same-geometry requests through one generate "
                         "call (continuous batching)")
    ap.add_argument("--warmup", type=str, default=None,
                    help="prepare a geometry bucket at startup, e.g. "
                         "'640x352x193x50' (WxHxframesxsteps): the port loads "
                         "(building if needed) the kernels of its attention route, "
                         "so the first request does not")
    ap.add_argument("--compile_cache", type=str, default="",
                    help="accepted for the JAX CLI's sake and unused: the port has "
                         "no XLA compile to cache")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch path)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build_server(args: argparse.Namespace, tokenizer=None, dtype=None):
    """Load the checkpoint, build the pipeline, warm it up and return the
    `VideoServer` with the UI attached, not yet serving (`run` serves).
    tokenizer: the checkpoint's (`load_tokenizer`) unless given; dtype: the
    towers' and UMT5's weight dtype under `--weight_dtype bf16` and the
    compute dtype (bf16 unless given). The pipeline is `server.pipe`."""
    from dualforce_tpu_torch.cli.inference_single import (offload_kwargs, offload_mode,
                                                          refuse_unported)

    if args.cp_size > 1 or args.fsdp_size > 1:
        raise SystemExit("--cp_size and --fsdp_size above 1 are not ported in the server "
                         "yet (ROADMAP A7b); the inference CLIs take them under torchrun")
    refuse_unported(args)
    import torch

    from dualforce_tpu_torch import resolve_device
    from dualforce_tpu_torch.convert.load_checkpoint import (config_from_checkpoint,
                                                             load_pipeline_params,
                                                             load_tokenizer)
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.serving.server import (VideoServer, make_pipeline_backend,
                                                    make_pipeline_batch_backend)
    from dualforce_tpu_torch.workflow.app import attach_ui

    device = resolve_device(args.device)
    offload = offload_mode(args)
    dtype = dtype or torch.bfloat16
    t0 = time.perf_counter()
    cfg = config_from_checkpoint(args.ckpt_path)
    wdtype = torch.float8_e4m3fn if args.weight_dtype == "fp8" else dtype
    modules = load_pipeline_params(args.ckpt_path, cfg, dtype=wdtype, device=device,
                                   host=offload != "none")
    pipe = MOVAPipeline(cfg, modules, tokenizer=tokenizer or load_tokenizer(args.ckpt_path),
                        compute_dtype=dtype, device=device, attn_impl=args.attn_type,
                        quantize=args.quantize, mask_ctx_pad=args.mask_ctx_pad,
                        **offload_kwargs(args))
    print(f"[serve] checkpoint loaded and pipeline built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if args.warmup:
        w, h, frames, steps = (int(x) for x in args.warmup.split("x"))
        # batching makes group sizes 1..max_batch possible; warm the common ones
        for b in sorted({1, max(args.max_batch, 1)}):
            print(f"[serve] warming up {w}x{h} {frames}f {steps} steps b={b} ...")
            pipe.warmup(height=h, width=w, num_frames=frames,
                        num_inference_steps=steps, batch_size=b)
        print("[serve] warmup done")

    overrides = ({"cfg_cache_interval": args.cfg_cache_interval}
                 if args.cfg_cache_interval != 1 else None)
    server = VideoServer(
        make_pipeline_backend(pipe, overrides), out_dir=args.out_dir,
        batch_backend=(make_pipeline_batch_backend(pipe, overrides)
                       if args.max_batch > 1 else None),
        max_batch=args.max_batch, queue_timeout_s=args.queue_timeout_s)
    server.pipe = pipe
    attach_ui(server)
    return server


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    print(f"serving on http://{args.host}:{args.port} (UI at /)")
    server.run(args.host, args.port)


if __name__ == "__main__":
    main()
