"""The port's process mesh in one process, and the gloo worlds of the
sequence- and weight-parallel tests (tests/test_torch_sp_*.py).

`run_world(world, cases, tmp)` writes the cases with `torch.save`, starts
`world` processes of this file with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or
with `jax_env` the JAX package's (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID), so each joins through the port's own
`parallel.mesh.initialize_distributed`, and returns every rank's
results ({case name: result}). Each case is a dict with "name", "kind" (a
`case_*` function below), "mesh" (data, fsdp, cp) and its arguments, whole;
each rank takes its own part. The workers import the port only, with one
torch thread each; JAX is imported inside the helpers and tests that hold
the port against it (`jax_blocks_setup`, `jax_shard_map`).
"""

from __future__ import annotations

import copy
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, cases, tmp, timeout: float = 600, jax_env: bool = False):
    """[results of rank 0, ..., rank world-1]."""
    tmp = str(tmp)
    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    port = _free_port()
    names = ("JAX_", "XLA_", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "RANK",
             "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_")
    env = {k: v for k, v in os.environ.items() if not k.startswith(names)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    if jax_env:
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world))
        ranks = [dict(PROCESS_ID=str(r)) for r in range(world)]
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world))
        ranks = [dict(RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, path, tmp], env=dict(env, **extra),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for extra in ranks]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class ByteTokenizer:
    """Byte-level stand-in for the UMT5 tokenizer."""

    def __call__(self, prompts, padding=None, max_length=512, truncation=True,
                 add_special_tokens=True, return_attention_mask=True, return_tensors="np"):
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            toks = [2 + (b % 500) for b in p.encode()][: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


# --- the cases (each rank runs every one, in order) -------------------------

def _chunk(x, axis, dim=1):
    from dualforce_tpu_torch.parallel import mesh as pm

    n = x.shape[dim] // pm.axis_size(axis)
    return x.narrow(dim, pm.axis_index(axis) * n, n)


def _inner(name):
    from dualforce_tpu_torch.parallel import ring_attention as ra

    return ra.inner_for_impl(name)


def case_ring(mesh, c):
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel.ring_attention import ring_attention

    ax = pm.MeshAxis(mesh, "cp")
    q, k, v = (_chunk(c[n], ax) for n in "qkv")
    return ring_attention(q, k, v, ax, _inner(c.get("inner", "ref")), c.get("valid"))


def case_lse(mesh, c):
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel.ring_attention import lse_combine_cross_attention

    ax = pm.MeshAxis(mesh, "cp")
    return lse_combine_cross_attention(c["q"], _chunk(c["k"], ax), _chunk(c["v"], ax), ax,
                                       _inner(c.get("inner", "ref")), c.get("valid"))


def case_gather(mesh, c):
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel.ring_attention import gather_kv_attention

    ax = pm.MeshAxis(mesh, "cp")
    q, k, v = (_chunk(c[n], ax) for n in "qkv")
    return gather_kv_attention(q, k, v, ax, c.get("valid"), c.get("impl", "auto"))


def case_ulysses(mesh, c):
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel.ring_attention import ulysses_attention

    ax = pm.MeshAxis(mesh, "cp")
    q, k, v = (_chunk(c[n], ax) for n in "qkv")
    try:
        return ulysses_attention(q, k, v, ax)
    except ValueError as e:
        return f"ValueError: {e}"


def case_shard(mesh, c):
    """This rank's shards ({module: {name: tensor}}); with c["quantize"],
    of the towers quantized both ways: sharded first, then quantized from
    each layer's gathered whole weights (`quantize_sharded`, the pipeline's
    way), and quantized whole, then sharded."""
    from dualforce_tpu_torch.nn import quantize_modules
    from dualforce_tpu_torch.parallel.sharding import quantize_sharded, shard_params

    mode = c.get("quantize")
    if mode is None:
        modules = shard_params(copy.deepcopy(c["modules"]), mesh)
        return {name: {n: p.detach().clone() for n, p in m.named_parameters()}
                for name, m in modules.items()}
    first = shard_params(copy.deepcopy(c["modules"]), mesh)
    ways = {"sharded_first": {n: quantize_sharded(n, m, mode) for n, m in first.items()},
            "quantized_first": shard_params({n: quantize_modules(m, mode) for n, m in
                                             copy.deepcopy(c["modules"]).items()}, mesh)}
    return {way: {name: {n: t.clone() for n, t in m.state_dict().items()}
                  for name, m in mods.items()} for way, mods in ways.items()}


def case_blocks(mesh, c):
    from dualforce_tpu_torch.parallel.sharding import shard_params
    from dualforce_tpu_torch.parallel.sp import sp_forward_blocks

    m = shard_params(copy.deepcopy(c["modules"]), mesh)
    with torch.no_grad():
        return sp_forward_blocks(mesh, m["video_dit"].blocks, m["audio_dit"].blocks,
                                 m["bridge"], *c["inputs"], **c["kwargs"])


def case_pipeline(mesh, c):
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.parallel.sharding import shard_params

    modules = shard_params(init_pipeline_params(c["cfg"], device="cpu",
                                                dtype=torch.float32, seed=0), mesh)
    pipe = MOVAPipeline(c["cfg"], modules, tokenizer=ByteTokenizer(),
                        compute_dtype=torch.float32, device="cpu", mesh=mesh,
                        attn_impl=c.get("attn_impl", "auto"),
                        quantize=c.get("quantize", "none"))
    return generate(pipe, c["prompt"], c["image"], c["request"], c.get("seed", 3))


SERVE_REQUEST = dict(size="32x32", num_frames=5, fps=24.0, num_inference_steps=2,
                     negative_prompt="blurry")


def case_serve(mesh, c):
    """`cli.serve.build_server` under the mesh flags c["flags"] on the tiny
    checkpoint c["ckpt"]. Rank 0 serves over HTTP (`serve_in_thread`) and
    submits a same-geometry pair (batched), a task it cancels while queued,
    and a task whose reference is no image (it fails on rank 0 alone), then
    downloads the pair's clips; then a task whose `prepare_state` fails on
    rank 1 alone (as an out-of-memory in the encode would) and one more
    task, whose clip it downloads, and stops the server; the other ranks
    follow until the stop. Rank 0 returns each task's final status and
    error, the groups its backend ran, each group's generate results, the
    clips written for them and the downloaded bytes; another rank the number
    of groups it followed."""
    import threading
    import urllib.request

    from dualforce_tpu_torch.cli import serve as serve_cli
    from dualforce_tpu_torch.serving.client import VideoClient
    from dualforce_tpu_torch.serving.server import serve_in_thread
    from dualforce_tpu_torch.utils.av_io import save_video_with_audio

    args = serve_cli.parse_args(["--ckpt_path", c["ckpt"], "--device", "cpu", "--max_batch",
                                 "2", "--out_dir", os.path.join(c["out"], "served")]
                                + c["flags"])
    server = serve_cli.build_server(args, tokenizer=ByteTokenizer(), dtype=torch.float32)
    if not hasattr(server, "app"):
        prepare, prepared = server.pipe.prepare_state, []

        def failing_second(**kw):           # rank 1's encode of the second group fails
            prepared.append(1)
            if server.rank == 1 and len(prepared) == 2:
                raise RuntimeError("out of memory in the encode, on this rank alone")
            return prepare(**kw)

        server.pipe.prepare_state = failing_second
        return {"followed": server.follow(), "rank": server.rank}
    groups, results, saved, queued_in = [], [], [], threading.Event()
    real_batch, real_finalize = server.batch_backend, server.pipe.finalize_state

    def batch(tasks, out_dir, progress=None):
        groups.append([t.task_id for t in tasks])
        server.batch_window_s = 0.25        # the pair is in: later groups need no wait
        queued_in.wait(60)                  # the pair runs once the others are queued
        return real_batch(tasks, out_dir, progress=progress)

    def finalize(state):
        out = real_finalize(state)
        results.append([(r.video, r.audio) for r in out])
        saved.append([])
        for i, r in enumerate(out):     # the clips as the backend writes them, here
            path = save_video_with_audio(os.path.join(c["out"], f"saved{i}.mp4"), r.video,
                                         r.audio, fps=r.fps, sample_rate=r.sample_rate)
            with open(path, "rb") as f:
                saved[-1].append(f.read())
        return out

    server.batch_backend, server.pipe.finalize_state = batch, finalize
    server.batch_window_s = 60.0             # closes once the second request is in
    base, stop = serve_in_thread(server.app)
    try:
        client = VideoClient(base, timeout=60)
        pair = [client.submit_video_task(p, img, seed=seed, **SERVE_REQUEST)
                for (p, seed), img in zip(c["prompts"], c["images"])]
        queued = client.submit_video_task("cancelled", c["images"][0], seed=1,
                                          **SERVE_REQUEST)
        cancelled = client.cancel(queued.task_id)
        bad = client.submit_video_task("bad", b"no image", seed=2, **SERVE_REQUEST)
        queued_in.set()
        done = {t.task_id: client.wait_for_completion(t.task_id, poll_interval=0.05,
                                                      timeout=600)
                for t in pair + [bad]}
        done[queued.task_id] = client.get_task(queued.task_id)
        later = {}
        for name, seed in (("lost", 3), ("after", 4)):
            task = client.submit_video_task(name, c["images"][0], seed=seed, **SERVE_REQUEST)
            later[name] = task.task_id
            done[task.task_id] = client.wait_for_completion(task.task_id, poll_interval=0.05,
                                                            timeout=600)
        downloads = []
        for tid in [t.task_id for t in pair] + [later["after"]]:
            with urllib.request.urlopen(base + done[tid].download_url, timeout=60) as r:
                downloads.append(r.read())
    finally:
        stop()
        server.stop()
    ids = {"pair": [t.task_id for t in pair], "queued": queued.task_id, "bad": bad.task_id,
           **later}
    return {"ids": ids, "cancel_status": cancelled.status,
            "status": {i: (t.status, t.error) for i, t in done.items()},
            "groups": groups, "results": results, "downloads": downloads, "saved": saved}


def generate(pipe, prompt, image, request, seed: int = 3):
    """One request through the pipeline's three stages: the denoised
    latents and the decoded clip."""
    with torch.no_grad():
        state = pipe.denoise_state(pipe.prepare_state([prompt], [image],
                                                      negative_prompts=["blurry"], seeds=[seed],
                                                      **request))
        res = pipe.finalize_state(state)[0]
    return {"latents": state["latents"].numpy(), "audio_latents": state["audio_latents"].numpy(),
            "video": res.video, "audio": res.audio}


def case_refusals(mesh, c):
    """Each refusal's message (they raise before any collective)."""
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.parallel.mesh import create_mesh

    out = {}
    modules = init_pipeline_params(c["cfg"], device="cpu", dtype=torch.float32, seed=0)
    for name, fn in [
        ("group_offload", lambda: MOVAPipeline(c["cfg"], modules, device="cpu", mesh=mesh,
                                               offload="group")),
        ("world_mismatch", lambda: create_mesh(1, 1, 2 * mesh.size())),
    ]:
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# --- training under a mesh (tests/test_torch_train_world*.py) --------------

def _local(x, axis, dim=1):
    """x's chunk along `dim` over `axis`, a leaf that needs a gradient."""
    return _chunk(x, axis, dim).detach().clone().requires_grad_()


def case_attn_grads(mesh, c):
    """The gradients of one attention collective's output against the
    weights c["w"]: this rank's part of sum(out * w) (its chunk of a
    sharded output; 1 / cp of a replicated one), differentiated, the
    gradients of replicated inputs summed over the axis. Returns {q, k, v}:
    this rank's chunk of a sharded input's gradient, a replicated one whole."""
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel import ring_attention as ra

    ax = pm.MeshAxis(mesh, "cp")
    kind, n = c["fn"], pm.axis_size(ax)
    replicated_q = kind == "lse"
    q = (c["q"].clone().requires_grad_() if replicated_q else _local(c["q"], ax))
    k, v = _local(c["k"], ax), _local(c["v"], ax)
    if kind == "ring":
        out = ra.ring_attention(q, k, v, ax, _inner(c["inner"]), c.get("valid"))
    elif kind == "lse":
        out = ra.lse_combine_cross_attention(q, k, v, ax, _inner(c["inner"]), c.get("valid"))
    elif kind == "gather":
        out = ra.gather_kv_attention(q, k, v, ax, c.get("valid"), c["inner"])
    else:
        out = ra.ulysses_attention(q, k, v, ax, _inner(c["inner"]))
    w = c["w"] if replicated_q else _chunk(c["w"], ax)
    loss = (out * w).sum() / (n if replicated_q else 1)
    gq, gk, gv = torch.autograd.grad(loss, (q, k, v))
    if replicated_q:
        gq = pm.psum(gq, ax)
    return {"q": gq, "k": gk, "v": gv}


def case_transports(mesh, c):
    """The helpers over the shared-memory buffers of a one-host world and
    over gloo's own collectives (the path of a world across hosts), on the
    same inputs: {path: {helper: result}}."""
    from dualforce_tpu_torch.parallel import mesh as pm

    ax = pm.MeshAxis(mesh, "cp")
    x = _chunk(c["x"], ax)
    out = {}
    for path, one_host in (("shared", True), ("gloo", False)):
        saved = pm._ONE_HOST["on"]
        pm._ONE_HOST["on"] = one_host
        try:
            out[path] = {
                "ppermute": [t.clone() for t in pm.ppermute_next(
                    [x, x[:, :3].to(torch.bfloat16)], ax)],
                "all_gather": pm.all_gather_many([x, x.transpose(1, 2)], [1, 2], ax),
                "reduce_scatter": pm.reduce_scatter(x, ax, 2),
                "psum": pm.psum(x, ax), "pmax": pm.pmax(x, ax),
                "all_to_all": pm.all_to_all(x.reshape(2, -1), ax)}
        finally:
            pm._ONE_HOST["on"] = saved
    return out


def block_grad_names(modules):
    """The (module, parameter name) pairs whose gradients the block-stack
    cases return: every parameter of the towers' blocks and of the bridge."""
    return [(m, n) for m in ("bridge", "video_dit", "audio_dit")
            for n, _ in (modules[m] if m == "bridge" else modules[m].blocks).named_parameters()]


def case_block_grads(mesh, c):
    """`sp_forward_blocks` differentiated: each rank's share of the loss
    sum(ov^2) + sum(oa^2) (`objective_share`), the gradients of every block
    and bridge parameter (this rank's fsdp slice of a sharded one) and of
    both inputs, reduced over the mesh (`reduce_gradients`)."""
    from dualforce_tpu_torch.parallel import sharding
    from dualforce_tpu_torch.parallel.sp import sp_forward_blocks

    m = sharding.shard_params(copy.deepcopy(c["modules"]), mesh)
    names = block_grad_names(m)
    params = [(m[a] if a == "bridge" else m[a].blocks).get_parameter(n) for a, n in names]
    for p in params:
        p.requires_grad_(True)
    inputs = [x.clone() for x in c["inputs"][:6]]
    vx, ax = (x.requires_grad_() for x in inputs[:2])
    ov, oa = sp_forward_blocks(mesh, m["video_dit"].blocks, m["audio_dit"].blocks, m["bridge"],
                               *inputs, *c["inputs"][6:], **c["kwargs"])
    loss = (ov.square().sum() + oa.square().sum()) * sharding.objective_share(mesh)
    grads = torch.autograd.grad(loss, params + [vx, ax])
    shards = sharding.shards_of(m, params) + [None, None]
    grads = sharding.reduce_gradients(grads, shards, mesh)
    out = {f"{a}.{n}": g for (a, n), g in zip(names, grads)}
    out["vx"], out["ax"] = grads[-2:]
    out["_dims"] = {f"{a}.{n}": (s.dim if s is not None else None)
                    for (a, n), s in zip(names, shards)}
    return out


def train_steps(trainer, steps, encoded=None, batches=None):
    """`trainer`'s steps with pinned draws: per step (expert, timestep id,
    (video noise, audio noise)); the encodes given (`encoded`) or made by the
    trainer from `batches`. Returns per step its loss, grad norm and the
    trained tensors after it ({name: this rank's tensor})."""
    from dualforce_tpu_torch.diffusion.training import trainable_parameters

    out = []
    for i, (expert, tid, noise) in enumerate(steps):
        enc = encoded if batches is None else trainer._encode(batches[i])
        grads, metrics = trainer._grads(enc, expert, timestep_id=tid, noise_override=noise)
        norm = trainer._apply(grads)
        trainer.global_step += 1
        if trainer.lora is not None:
            named = {f"{m}.{n}.{p}": t for m in trainer.lora for n in trainer.lora[m]
                     for p, t in trainer.lora[m][n].items()}
        else:
            named = {f"{m}.{n}": p for m in sorted(trainer.trainable)
                     for n, p in trainer.trainable[m].named_parameters()}
            assert len(named) == len(trainable_parameters(trainer.trainable))
        out.append({"loss": float(metrics["loss"]), "grad_norm": float(norm),
                    "params": {k: v.detach().clone() for k, v in named.items()}})
    return out


def _trainer(mesh, c, modules):
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    tcfg = TrainerConfig(**c["tcfg"])
    trainer = LoRATrainer(c["cfg"], modules, tcfg, device="cpu", mesh=mesh)
    if c.get("lora") is not None:
        with torch.no_grad():
            for m, tree in trainer.lora.items():
                for n, ab in tree.items():
                    for part, t in ab.items():
                        t.copy_(c["lora"][m][n][part])
    return trainer


def case_trainer(mesh, c):
    """`LoRATrainer(mesh=...)` steps with pinned draws (`train_steps`), and
    for `mode="full"` each trained parameter's fsdp dim, the optimizer's
    int8 codes and scales per element (AdamW8bit) and, with c["save"], the
    last step's `step-N/` under the trainer's save_dir (rank 0 writes it)."""
    trainer = _trainer(mesh, c, copy.deepcopy(c["modules"]))
    out = {"steps": train_steps(trainer, c["steps"], c.get("encoded"), c.get("batches"))}
    if trainer.lora is None:
        from dualforce_tpu_torch.diffusion.training import trainable_parameters
        from dualforce_tpu_torch.engine.optim import AdamW8bit

        params = trainable_parameters(trainer.trainable)
        names = [f"{m}.{n}" for m in sorted(trainer.trainable)
                 for n, _ in trainer.trainable[m].named_parameters()]
        out["dims"] = {n: (s.dim if s is not None else None)
                       for n, s in zip(names, trainer.shards)}
        opt = trainer.optimizer
        if isinstance(opt, AdamW8bit):
            codes = {}
            for i, (n, p) in enumerate(zip(names, params)):
                shape = opt.shards[i].whole_shape if opt.gather[i] else p.shape
                numel = math.prod(shape)
                codes[n] = {k: (q.reshape(-1)[:numel].view(shape).clone(),
                                s.expand(-1, 256).reshape(-1)[:numel].view(shape).clone())
                            for k, (q, s) in (("mu", opt.mu[i]), ("nu", opt.nu[i]))}
                codes[n]["whole"] = opt.gather[i]
            out["codes"] = codes
    if c.get("save"):
        trainer.save()
    return out


# --- the JAX side (imported here, in the pytest process only) -------------

def jax_shard_map(fn, cp: int, in_specs, out_specs, *args):
    """fn under `jax.shard_map` over create_mesh(1, 1, cp)'s "cp" axis."""
    import jax

    from dualforce_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(1, 1, cp)
    return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                            out_specs=out_specs, check_vma=False))(*args))


def jax_random_params(jcfg, seed: int = 0):
    """Random JAX trees of the towers and the bridge in the shapes of
    `init_pipeline_params` (from `jax.eval_shape`, filled with numpy: kernels
    N(0, 1/in), norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2))."""
    import jax

    from dualforce_tpu.models.factory import init_pipeline_params as jax_init

    shapes = jax.eval_shape(lambda k: jax_init(k, jcfg, with_vaes=False, with_text=False,
                                               two_video_towers=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(leaf.shape)
        if name == "kernel":
            x = x / np.sqrt(leaf.shape[-2])
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, v) for k, v in shapes.items()
            if v is not None}


def jax_blocks_setup(cross=True, grid=(4, 2, 2), la=8, pooled=False, batch=1, seed=7):
    """The JAX test_sp_equivalence setup (tiny config, 3 video / 2 audio
    layers) with numpy inputs, and the same weights in the port's modules
    (`from_jax`). Returns a dict: cfg (port), jparams, modules, inputs
    (numpy), jargs (JAX's positional inputs), targs (the port's), jkw, tkw."""
    import dataclasses

    import jax.numpy as jnp

    from dualforce_tpu.config import tiny_test_config as jax_tiny
    from dualforce_tpu.models import audio_dit, video_dit
    from dualforce_tpu.ops.rope import (build_aligned_cross_rope, build_audio_freqs,
                                        build_video_freqs)

    from dualforce_tpu_torch.config import tiny_test_config
    from dualforce_tpu_torch.convert import from_jax
    from dualforce_tpu_torch.diffusion.step import make_rope_pack
    from dualforce_tpu_torch.models.factory import init_pipeline_params

    def configs(make):
        cfg = make(visual_layers=3, audio_layers=2, apply_cross_rope=cross)
        if pooled:
            cfg = dataclasses.replace(cfg, bridge=dataclasses.replace(cfg.bridge,
                                                                      pooled_adaln=True))
        return cfg

    jcfg, cfg = configs(jax_tiny), configs(tiny_test_config)
    jparams = jax_random_params(jcfg)
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                   with_vaes=False, with_text=False, two_video_towers=False)
    modules = {k: modules[k] for k in jparams}
    from_jax.load(modules, jparams, cfg)
    vc, ac = cfg.video_dit, cfg.audio_dit
    rng = np.random.default_rng(seed)
    lv = grid[0] * grid[1] * grid[2]

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    inputs = [r(batch, lv, vc.dim), r(batch, la, ac.dim), r(batch, 12, vc.dim),
              r(batch, 12, ac.dim), r(batch, 6, vc.dim, scale=0.1),
              r(batch, 6, ac.dim, scale=0.1)]
    v_rope = tuple(jnp.asarray(x) for x in
                   build_video_freqs(video_dit.rope_tables(jcfg.video_dit), grid))
    a_rope = tuple(jnp.asarray(x) for x in
                   build_audio_freqs(audio_dit.rope_tables(jcfg.audio_dit), la))
    jcross = None
    if cross:
        (cv, sv), (ca, sa) = build_aligned_cross_rope(
            video_fps=24.0, grid=grid, audio_steps=la, audio_fps=jcfg.bridge.audio_fps,
            head_dim=jcfg.bridge.head_dim)
        jcross = ((jnp.asarray(cv), jnp.asarray(sv)), (jnp.asarray(ca), jnp.asarray(sa)))
    pack = make_rope_pack(vc, ac, cfg.bridge, grid, la, 24.0, "cpu")
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, modules=modules, grid=grid,
                jargs=[jnp.asarray(x) for x in inputs] + [v_rope, a_rope],
                targs=[torch.from_numpy(x) for x in inputs] + [pack["v"], pack["a"]],
                jkw=dict(cross_rope=jcross, attn_impl="ref", video_grid=grid),
                tkw=dict(cross_rope=pack.get("cross"), attn_impl="ref", video_grid=grid))


def jax_sp_blocks(st, mesh_shape):
    """JAX's `sp_forward_blocks` over create_mesh(*mesh_shape) on the setup
    (jitted: JAX compiles the shard_map once either way, and dispatches the
    rest op by op without it)."""
    import jax

    from dualforce_tpu.parallel.mesh import create_mesh
    from dualforce_tpu.parallel.sp import sp_forward_blocks

    p, c = st["jparams"], st["jcfg"]
    mesh = create_mesh(*mesh_shape)
    out = jax.jit(lambda pv, pa, pb, *a: sp_forward_blocks(
        mesh, pv, pa, pb, c.video_dit, c.audio_dit, c.bridge, *a, **st["jkw"]))(
        p["video_dit"]["blocks"], p["audio_dit"]["blocks"], p["bridge"], *st["jargs"])
    return [np.asarray(x) for x in out]


def port_blocks(st):
    """The port's own cp = 1 `forward_dual_tower` on the setup."""
    from dualforce_tpu_torch.models.dual_tower import forward_dual_tower

    m = st["modules"]
    with torch.no_grad():
        out = forward_dual_tower(m["video_dit"].blocks, m["audio_dit"].blocks, m["bridge"],
                                 *st["targs"], **st["tkw"])
    return [x.numpy() for x in out]


def blocks_case(name, mesh, st):
    return dict(name=name, kind="blocks", mesh=mesh, modules=st["modules"],
                inputs=st["targs"], kwargs=st["tkw"])


# --- one process -------------------------------------------------------------

def test_backend_rule(monkeypatch):
    from dualforce_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(torch.device("cuda"), 1) == "nccl"
    assert choose_backend(torch.device("cuda"), 2) == "gloo"     # two ranks share a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend(torch.device("cuda"), 4) == "nccl"


def test_local_placement_rule(monkeypatch):
    """The ranks on this host come from LOCAL_RANK / LOCAL_WORLD_SIZE only;
    a CUDA rank of a larger world without them raises instead of taking the
    whole world for one host (two hosts of 8 cards would otherwise pick
    gloo)."""
    from dualforce_tpu_torch.parallel import mesh as pm

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert pm.local_placement(cuda, 0, 1) == (0, 1)
    assert pm.local_placement(cpu, 3, 4) == (0, 4)
    with pytest.raises(ValueError, match="needs LOCAL_RANK and LOCAL_WORLD_SIZE"):
        pm.local_placement(cuda, 9, 16)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="needs LOCAL_RANK and LOCAL_WORLD_SIZE"):
        pm.local_placement(cuda, 9, 16)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert pm.local_placement(cuda, 9, 16) == (1, 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert pm.choose_backend(cuda, pm.local_placement(cuda, 9, 16)[1]) == "nccl"


def test_collective_time_waits_for_the_card(monkeypatch):
    """`TRANSFER`'s seconds of a CUDA tensor's collective are read with the
    device synchronised on both sides, not at the time the call is queued."""
    from types import SimpleNamespace

    from dualforce_tpu_torch.parallel import mesh as pm

    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(len(syncs)))
    monkeypatch.setattr(pm, "TRANSFER", {"bytes": 0, "seconds": 0.0, "calls": 0})
    with pm._timed(8, SimpleNamespace(is_cuda=True)):
        assert syncs == [0]
    assert syncs == [0, 1] and pm.TRANSFER["bytes"] == 8 and pm.TRANSFER["calls"] == 1
    with pm._timed(4, torch.zeros(1)):
        pass
    assert syncs == [0, 1] and pm.TRANSFER["bytes"] == 12


@pytest.mark.parametrize("fsdp", [2, 3, 4])
def test_leaf_spec_is_jax_rule(fsdp):
    from dualforce_tpu.parallel.sharding import _leaf_spec

    from dualforce_tpu_torch.parallel.sharding import leaf_spec

    rng = np.random.default_rng(fsdp)
    shapes = [(5,), (3, 8), (8, 3), (6, 6), (2, 12, 9), (4, 1, 6, 10), (3, 7, 5)]
    shapes += [tuple(int(x) for x in rng.integers(1, 13, size=int(rng.integers(1, 5))))
               for _ in range(40)]
    for shape in shapes:
        spec = tuple(_leaf_spec(np.zeros(shape), fsdp))
        want = next((i - len(spec) for i, a in enumerate(spec) if a == "fsdp"), None)
        assert leaf_spec(shape, fsdp) == want, shape


def test_one_process_world_needs_no_group():
    from dualforce_tpu_torch.parallel import mesh as pm

    assert pm.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and pm.world_size() == 1
    with pytest.raises(ValueError, match="needs a world of 2 processes"):
        pm.create_mesh(1, 1, 2)
    if not torch.cuda.is_available():       # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pm.initialize_distributed()


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_cli_mesh_flags_refused_before_reading(lora, tmp_path):
    """A mesh flag in a one-process world raises before the (absent)
    checkpoint is read; `--offload` under a mesh exits as the JAX CLI does."""
    from dualforce_tpu_torch.cli import inference_single as cli
    from dualforce_tpu_torch.cli import inference_single_lora as lora_cli

    absent = str(tmp_path / "absent")
    head = (["--base_model", absent, "--lora_path", absent] if lora
            else ["--ckpt_path", absent])
    mod = lora_cli if lora else cli
    base = head + ["--prompt", "x", "--ref_path", "x.png", "--device", "cpu"]
    with pytest.raises(ValueError, match="needs a world of 2 processes"):
        mod.run(mod.parse_args(base + ["--cp_size", "2"]))
    with pytest.raises(SystemExit, match="--offload is for single-chip runs"):
        mod.run(mod.parse_args(base + ["--fsdp_size", "2", "--offload", "cpu"]))



def main(path: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from dualforce_tpu_torch.parallel import mesh as pm

    device = pm.initialize_distributed("cpu")
    assert device.type == "cpu"
    meshes, out = {}, {}
    for c in torch.load(path, weights_only=False):
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = pm.create_mesh(*shape)
        out[c["name"]] = globals()["case_" + c["kind"]](meshes[shape], c)
    out["_backend"] = torch.distributed.get_backend()
    out["_world"] = pm.world_size()
    torch.save(out, os.path.join(tmp, f"rank{pm.rank()}.pt"))
    pm.leave()


def cli_main(argv) -> None:
    """One rank of the base CLI under torchrun (`cli.main` with the byte
    tokenizer, fp32); rank 0 also keeps the clip's arrays beside it."""
    torch.set_num_threads(1)
    from dualforce_tpu_torch.cli import inference_single as cli

    result = cli.main(argv, tokenizer=ByteTokenizer(), dtype=torch.float32)
    if int(os.environ.get("RANK", 0)) == 0:
        out = cli.parse_args(argv).output
        np.savez(os.path.splitext(out)[0] + ".npz", video=result.video, audio=result.audio)


def train_cli_main(argv) -> None:
    """One rank of the training CLI under torchrun (the byte tokenizer,
    fp32): `cli.train.run(ARGS + trainer.save_dir=OUT/a)` to the config's
    max_steps, then, from a copy of its `step-RESUME/` alone under OUT/b,
    the same run again, which resumes there. argv: OUT RESUME ARGS..."""
    import shutil

    torch.set_num_threads(1)
    from dualforce_tpu_torch.cli import train as cli
    from dualforce_tpu_torch.parallel import mesh as pm

    out, resume, args = argv[0], argv[1], argv[2:]
    try:
        cli.run(args + [f"trainer.save_dir={out}/a"], tokenizer=ByteTokenizer(),
                dtype=torch.float32)
        if pm.rank() == 0:
            shutil.copytree(f"{out}/a/step-{resume}", f"{out}/b/step-{resume}")
        pm.barrier()
        cli.run(args + [f"trainer.save_dir={out}/b"], tokenizer=ByteTokenizer(),
                dtype=torch.float32)
    finally:
        pm.leave()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "--cli":
        cli_main(sys.argv[2:])
    elif sys.argv[1] == "--train-cli":
        train_cli_main(sys.argv[2:])
    else:
        main(*sys.argv[1:3])
