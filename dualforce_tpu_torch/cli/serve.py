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

Under a mesh (`--cp_size C --fsdp_size F`, one process per rank):

    torchrun --nproc-per-node 2 -m dualforce_tpu_torch.cli.serve \
        --ckpt_path CKPT --fsdp_size 2 [--quantize int8]

every rank joins the world, loads the checkpoint, keeps its fsdp shards and
builds the pipeline over the mesh; rank 0 serves HTTP and the others follow
its groups (`serving.server.MeshControl`). `--offload` with a mesh exits,
as the JAX script does. The server's stop (Ctrl-C to rank 0, which the
followers ignore) ends every rank, each leaving the group and exiting 0.
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
                    help="sequence parallelism: token sequences split over this many "
                         "ranks (under torchrun)")
    ap.add_argument("--fsdp_size", type=int, default=1,
                    help="weight sharding: block weights split over this many ranks "
                         "(under torchrun)")
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
                    help="VAE encoder compute dtype for prepare_latents; bf16 halves "
                         "the streaming encode's activation memory (the JAX server needs "
                         "it at 720p on 16 GB chips)")
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
    compute dtype (bf16 unless given). The pipeline is `server.pipe`.

    Under a mesh every rank calls it (joining the torchrun world first, if
    this process has not): rank 0 gets the server (its `control`, the
    `MeshControl`, leads the others; `stop` ends them), every other rank
    the `MeshControl` to `follow` with (its pipeline is `control.pipe`)."""
    from dualforce_tpu_torch.cli.inference_single import (device_and_mesh, offload_kwargs,
                                                          offload_mode, refuse_unported,
                                                          shard)

    if args.cp_size * args.fsdp_size > 1 and args.offload != "none":
        raise SystemExit("--offload is for single-chip serving; use --fsdp_size to shard "
                         "weights across chips")
    refuse_unported(args)
    import torch

    from dualforce_tpu_torch.convert.load_checkpoint import (config_from_checkpoint,
                                                             load_pipeline_params,
                                                             load_tokenizer)
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.serving.server import (MeshControl, VideoServer,
                                                    make_pipeline_backend,
                                                    make_pipeline_batch_backend)
    from dualforce_tpu_torch.workflow.app import attach_ui

    device, mesh = device_and_mesh(args)
    offload = offload_mode(args)
    dtype = dtype or torch.bfloat16
    t0 = time.perf_counter()
    cfg = config_from_checkpoint(args.ckpt_path)
    wdtype = torch.float8_e4m3fn if args.weight_dtype == "fp8" else dtype
    modules = load_pipeline_params(args.ckpt_path, cfg, dtype=wdtype, device=device,
                                   host=offload != "none")
    modules = shard(modules, mesh, device)
    pipe = MOVAPipeline(cfg, modules, tokenizer=tokenizer or load_tokenizer(args.ckpt_path),
                        compute_dtype=dtype, device=device, attn_impl=args.attn_type,
                        quantize=args.quantize, mask_ctx_pad=args.mask_ctx_pad, mesh=mesh,
                        vae_encode_dtype=args.vae_encode_dtype, **offload_kwargs(args))
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

    control = MeshControl(pipe) if mesh is not None else None
    if control is not None and control.rank != 0:
        return control
    overrides = ({"cfg_cache_interval": args.cfg_cache_interval}
                 if args.cfg_cache_interval != 1 else None)
    server = VideoServer(
        make_pipeline_backend(pipe, overrides, control), out_dir=args.out_dir,
        batch_backend=(make_pipeline_batch_backend(pipe, overrides, control)
                       if args.max_batch > 1 else None),
        max_batch=args.max_batch, queue_timeout_s=args.queue_timeout_s)
    server.pipe = pipe
    server.control = control
    attach_ui(server)
    return server


def main(argv=None) -> None:
    import signal

    from dualforce_tpu_torch.parallel.mesh import leave
    from dualforce_tpu_torch.serving.server import MeshControl

    args = parse_args(argv)
    server = build_server(args)
    try:
        if isinstance(server, MeshControl):
            # a Ctrl-C reaches every rank of the terminal's process group: the followers
            # leave it to rank 0, whose stop ends them
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            print(f"[serve] rank {server.rank} follows rank 0's groups", flush=True)
            groups = server.follow()
            print(f"[serve] rank {server.rank}: stopped after {groups} groups", flush=True)
        else:
            print(f"serving on http://{args.host}:{args.port} (UI at /)")
            try:
                server.run(args.host, args.port)
            finally:
                server.stop()
    finally:
        leave()


if __name__ == "__main__":
    main()
