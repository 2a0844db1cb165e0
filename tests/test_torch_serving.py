"""The port's serving layer (`dualforce_tpu_torch/serving/`, `cli/serve.py`)
against the JAX package's, on the CPU.

- The HTTP contract: the JAX `VideoServer` and the port's, each with the
  same fake backend, driven by one script (submit as multipart and as a
  form, status, list, cancel of a queued and of a running task, a queue
  timeout, download, 404, 409 and 400): status codes and JSON bodies equal,
  apart from task ids, times and output directories (exact).
- Grouping (`_next_group`, max_batch 3 over mixed geometries), restart
  recovery from a `tasks.json` that the JAX store wrote, and `TaskStore`'s
  compare-and-set results: equal (exact); a threaded race of cancels
  against the worker's transitions keeps every task in one terminal state.
- The serve CLI: its flags a superset of `scripts/serve.py`'s, the mesh
  flags with `--offload` refused with JAX's message, no CUDA fallback, and
  `--help` without jax, PIL or transformers; `--vae_encode_dtype bf16`
  serves a request over HTTP bit-equal to it in process.
- The pipeline backend on the tiny config: `cli.serve.build_server` over a
  tiny fp32 checkpoint on the CPU answers two same-geometry requests sent
  over HTTP as one group; the downloaded clips are bit-equal to the port's
  in-process `generate` of that group saved the same way; the first frames
  decoded from the PNG bytes equal JAX's `crop_and_resize`/`image_to_tensor`
  (exact); and the group's `generate` is held against JAX's
  `denoise_state`/`finalize_state` from the port's noise, with
  `tests/test_torch_cli.py`'s tolerances (condition and contexts 1e-4 /
  1e-5, video at most 1 level off in under 1 % of values, audio 1e-4).
"""

import argparse
import collections
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
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
from dualforce_tpu.serving import server as jax_server

from dualforce_tpu_torch.cli import serve as serve_cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.data import transforms
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.serving import server as port_server
from dualforce_tpu_torch.serving.client import VideoClient
from dualforce_tpu_torch.serving.server import serve_in_thread
from dualforce_tpu_torch.utils.av_io import read_mjpeg_avi, save_video_with_audio

from test_torch_pipeline import FakeTokenizer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
SERVERS = {"jax": jax_server, "port": port_server}


def png_bytes(h=32, w=32, seed=0) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
                    ).save(buf, format="PNG")
    return buf.getvalue()


def call(base, method, path, data=None, headers=None):
    """(status code, JSON body or raw bytes) of one request."""
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body, ctype = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        code, body, ctype = e.code, e.read(), e.headers.get("Content-Type", "")
    return code, (json.loads(body) if ctype.startswith("application/json") else body)


def multipart(fields, image=None):
    boundary = uuid.uuid4().hex
    body = b"".join(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\""
                    f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items())
    if image is not None:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"input_reference\"; "
                 f"filename=\"ref.png\"\r\nContent-Type: application/octet-stream\r\n\r\n"
                 ).encode() + image + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


class BlockingBackend:
    """Holds each task until released, then writes a small file (the same
    bytes whichever server calls it)."""

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def __call__(self, task, out_dir):
        self.started.set()
        assert self.release.wait(30)
        path = os.path.join(out_dir, f"{task.task_id}.bin")
        with open(path, "wb") as f:
            f.write(task.prompt.encode() * 3)
        return {"file_path": path, "peak_memory_mb": 1.0}


def wait_status(base, tid, want, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        code, body = call(base, "GET", f"/v1/videos/{tid}")
        if body["status"] in want:
            return body
        time.sleep(0.02)
    raise AssertionError(f"task {tid} never reached {want}: {body}")


def normalize(obj, ids, out_dir):
    """Task ids -> <0>, <1>, ... in order of appearance; times -> whether
    set; the output directory -> <out>."""
    if isinstance(obj, dict):
        return {k: (v is not None if k in ("created_at", "completed_at", "inference_time_s")
                    else normalize(v, ids, out_dir)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v, ids, out_dir) for v in obj]
    if isinstance(obj, str):
        obj = obj.replace(out_dir, "<out>")
        for tid, tag in ids.items():
            obj = obj.replace(tid, tag)
    return obj


def http_script(mod, out_dir):
    """The same requests against `mod`'s VideoServer; returns the normalized
    (step, code, body) list."""
    backend = BlockingBackend()
    srv = mod.VideoServer(backend, out_dir=out_dir, queue_timeout_s=600.0)
    base, stop = serve_in_thread(srv.app)
    ids, log = {}, []

    def step(name, method, path, data=None, headers=None):
        code, body = call(base, method, path, data, headers)
        if isinstance(body, dict) and "task_id" in body and body["task_id"] not in ids:
            ids[body["task_id"]] = f"<{len(ids)}>"
        log.append((name, code, body))
        return body

    try:
        step("health", "GET", "/health")
        step("models", "GET", "/v1/models")
        fields = {"prompt": "running one", "size": "32x32", "num_frames": "4",
                  "num_inference_steps": "2", "seed": "3", "negative_prompt": "blurry"}
        a = step("submit multipart", "POST", "/v1/videos", *multipart(fields, png_bytes()))
        assert backend.started.wait(10)
        form = urllib.parse.urlencode({"prompt": "queued one", "size": "48x32",
                                       "fps": "12.5", "guidance_scale": "4"}).encode()
        b = step("submit form", "POST", "/v1/videos", form,
                 {"Content-Type": "application/x-www-form-urlencoded"})
        step("status queued", "GET", f"/v1/videos/{b['task_id']}")
        d = step("submit with timeout", "POST", "/v1/videos",
                 *multipart(dict(fields, prompt="doomed", timeout_s="0.2"), png_bytes()))
        time.sleep(0.4)
        step("status timed out", "GET", f"/v1/videos/{d['task_id']}")
        step("cancel queued", "POST", f"/v1/videos/{b['task_id']}/cancel", b"")
        step("cancel running", "DELETE", f"/v1/videos/{a['task_id']}")
        step("status cancelling", "GET", f"/v1/videos/{a['task_id']}")
        step("cancel terminal (409)", "POST", f"/v1/videos/{b['task_id']}/cancel", b"")
        step("bad field (400)", "POST", "/v1/videos",
             *multipart(dict(fields, num_frames="many")))
        step("bad size (400)", "POST", "/v1/videos", *multipart(dict(fields, size="32")))
        step("unknown status (404)", "GET", "/v1/videos/nope")
        step("unknown cancel (404)", "POST", "/v1/videos/nope/cancel", b"")
        step("download not ready (404)", "GET", f"/v1/videos/{b['task_id']}/content")
        backend.release.set()
        wait_status(base, a["task_id"], ("cancelled",))
        step("status cancelled", "GET", f"/v1/videos/{a['task_id']}")
        c = step("submit after", "POST", "/v1/videos",
                 *multipart(dict(fields, prompt="completes"), png_bytes(seed=1)))
        wait_status(base, c["task_id"], ("completed",))
        step("status completed", "GET", f"/v1/videos/{c['task_id']}")
        step("download", "GET", f"/v1/videos/{c['task_id']}/content")
        step("cancel completed (409)", "DELETE", f"/v1/videos/{c['task_id']}")
        step("list", "GET", "/v1/videos")
    finally:
        backend.release.set()
        stop()
    return normalize(log, ids, out_dir)


def test_http_contract_matches_jax(tmp_path):
    got = {name: http_script(mod, str(tmp_path / name)) for name, mod in SERVERS.items()}
    assert [s for s, _, _ in got["port"]] == [s for s, _, _ in got["jax"]]
    for (step, *want), (_, *mine) in zip(got["jax"], got["port"]):
        assert mine == want, step
    codes = {s: c for s, c, _ in got["port"]}
    assert codes["cancel terminal (409)"] == 409 and codes["bad field (400)"] == 400
    assert codes["unknown status (404)"] == 404 and codes["download"] == 200
    statuses = {s: b["status"] for s, _, b in got["port"] if isinstance(b, dict)
                and "status" in b and isinstance(b["status"], str)}
    assert statuses["cancel queued"] == "cancelled"
    assert statuses["cancel running"] == "cancelling"
    assert statuses["status timed out"] == "failed"
    assert statuses["status completed"] == "completed"


def _group_tasks(mod):
    """Tasks over two geometries, one cancelled and one timed out in the queue."""
    g1 = dict(height=32, width=32, num_frames=5, num_inference_steps=2, guidance_scale=5.0,
              guidance_scale_bridge=0.0, fps=24.0)
    g2 = dict(g1, height=48)
    kinds = [g1, g2, g1, g1, g2, g1, g1, g2, g1, g1]
    tasks = [mod.Task(task_id=f"t{i}", prompt=f"p{i}", params=dict(p))
             for i, p in enumerate(kinds)]
    tasks[6].status = "cancelled"
    tasks[8].params["timeout_s"] = 1.0
    tasks[8].created_at -= 10.0
    return tasks


@pytest.mark.parametrize("max_batch", [1, 3])
def test_next_group_matches_jax(tmp_path, max_batch):
    groups = {}
    for name, mod in SERVERS.items():
        srv = mod.VideoServer(lambda t, o: {}, out_dir=str(tmp_path / name),
                              batch_backend=lambda ts, o: [{} for _ in ts],
                              max_batch=max_batch)
        pending = collections.deque()
        for t in _group_tasks(mod):
            srv.store.add(t)
            pending.append(t.task_id)
        out = []
        while pending:
            group = srv._next_group(pending)
            out.append([t.task_id for t in group])
        groups[name] = (out, srv.store.get("t8").status, srv.store.get("t8").error)
    assert groups["port"] == groups["jax"]
    if max_batch == 3:
        assert groups["port"][0] == [["t0", "t2", "t3"], ["t1", "t4", "t7"], ["t5", "t9"]]
    assert groups["port"][1:] == ("failed", "timed out after 1s in queue")


def test_restart_recovery_from_a_jax_tasks_json(tmp_path):
    src = str(tmp_path / "jax_written")
    store = jax_server.TaskStore(src)
    for i, status in enumerate(["queued", "running", "cancelling", "completed", "failed",
                                "queued"]):
        store.add(jax_server.Task(task_id=f"r{i}", prompt=f"p{i}", status=status,
                                  created_at=1000.0 + i,
                                  params={"num_frames": 2, "fps": 8.0}))
    seen = {}
    for name, mod in SERVERS.items():
        out = str(tmp_path / name)
        shutil.copytree(src, out)
        order = []

        def backend(task, out_dir, _order=order):
            _order.append(task.task_id)
            return {"file_path": None, "peak_memory_mb": 0.0}

        srv = mod.VideoServer(backend, out_dir=out)
        deadline = time.time() + 10
        while time.time() < deadline and srv.store.get("r5").status != "completed":
            time.sleep(0.02)
        seen[name] = ([(t.task_id, t.status, t.error, t.completed_at is not None)
                       for t in srv.store.all()], order)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == ["r0", "r5"]
    assert [s for _, s, _, _ in seen["port"][0]] == ["completed", "failed", "cancelled",
                                                     "completed", "failed", "completed"]


def cas_script(mod, root):
    """TaskStore's compare-and-set sequence of `tests/test_serving.py`."""
    store = mod.TaskStore(root)
    Task = mod.Task
    out = []
    store.add(Task(task_id="t1", prompt="x"))
    out += [store.transition("t1", ("queued",), "running"),
            store.resolve_finished("t1", file_path="f"),
            store.transition("t1", ("queued",), "cancelled"),
            store.transition("t1", ("running",), "cancelling")]
    store.add(Task(task_id="t2", prompt="x"))
    out += [store.transition("t2", ("queued",), "cancelled"),
            store.transition("t2", ("queued",), "running")]
    store.add(Task(task_id="t3", prompt="x"))
    out += [store.transition("t3", ("queued",), "running"),
            store.transition("t3", ("running",), "cancelling"),
            store.resolve_finished("t3", file_path="f"), store.get("t3").file_path]
    store.add(Task(task_id="t4", prompt="x"))
    out += [store.transition("t4", ("queued",), "running"),
            store.resolve_finished("t4", error="boom"), store.get("t4").error,
            store.transition("nope", ("queued",), "running"), store.resolve_finished("nope")]
    with open(os.path.join(root, "tasks.json")) as f:
        persisted = [{k: v for k, v in t.items() if k not in ("created_at", "completed_at")}
                     for t in json.load(f)]
    return out, persisted


def test_taskstore_cas_matches_jax(tmp_path):
    port = cas_script(port_server, str(tmp_path / "port"))
    assert port == cas_script(jax_server, str(tmp_path / "jax"))
    assert port[0][:4] == [("running", True), "completed", ("completed", False),
                           ("completed", False)]


def test_taskstore_cas_race_keeps_one_terminal_state(tmp_path):
    """Cancels race the worker's transitions on 200 tasks (16 threads, a short
    switch interval): a task whose queued -> cancelled CAS won is never
    generated, and every task ends cancelled or completed."""
    store = port_server.TaskStore(str(tmp_path))
    n = 200
    for i in range(n):
        store.add(port_server.Task(task_id=f"t{i}", prompt="x"))
    store._persist = lambda: None          # the race, not the disk, is under test
    generated, cancelled_queued = set(), set()
    lock = threading.Lock()

    def worker(ids):
        for tid in ids:
            if store.transition(tid, ("queued",), "running")[1]:
                with lock:
                    generated.add(tid)
                store.resolve_finished(tid, file_path="f")

    def canceller(ids):
        for tid in ids:
            status, changed = store.transition(tid, ("queued",), "cancelled")
            if changed:
                with lock:
                    cancelled_queued.add(tid)
            elif status is not None:
                store.transition(tid, ("running",), "cancelling")

    ids = [f"t{i}" for i in range(n)]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f, args=(ids[k::4],))
                   for k in range(4) for f in (worker, canceller, worker, canceller)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert not generated & cancelled_queued
    assert generated | cancelled_queued == set(ids)
    for tid in ids:
        want = "cancelled" if tid in cancelled_queued else ("completed", "cancelled")
        assert store.get(tid).status in want


# --- the serve CLI ----------------------------------------------------------

class _Grabbed(Exception):
    pass


def _jax_serve_parser(monkeypatch):
    spec = importlib.util.spec_from_file_location("_jax_serve", REPO / "scripts" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise _Grabbed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Grabbed):
        mod.main()
    monkeypatch.undo()
    return grabbed["parser"]


def test_serve_flags_are_a_superset_of_the_jax_cli(monkeypatch):
    """Same destination, default, required and choices; where JAX names no
    choices (`--attn_type`), the port's are its attention routes."""
    port = {s: a for a in serve_cli.build_parser()._actions for s in a.option_strings}
    for action in _jax_serve_parser(monkeypatch)._actions:
        if not action.option_strings or action.dest == "help":
            continue
        for s in action.option_strings:
            mine = port[s]
            assert (mine.dest, mine.required, type(mine)) == \
                (action.dest, action.required, type(action)), s
            assert mine.choices == action.choices or action.choices is None, s
            if action.dest != "compile_cache":   # a path under ~ in JAX's; unused here
                assert mine.default == action.default, s
    assert port["--attn_type"].choices == ["auto", "fast", "sage", "pallas", "ref"]
    assert "--device" in port and port["--device"].default == "cuda"


# a mesh flag with --offload exits with the JAX script's message (scripts/serve.py:103-105)
# before the world is joined or the checkpoint read; --vae_encode_dtype bf16, which once
# exited naming its ROADMAP item, exits no more (message None): the build goes on to read
# the absent checkpoint
@pytest.mark.parametrize("extra,message", [
    (["--cp_size", "2", "--offload", "component"],
     "--offload is for single-chip serving; use --fsdp_size to shard weights across chips"),
    (["--fsdp_size", "2", "--offload", "component"],
     "--offload is for single-chip serving; use --fsdp_size to shard weights across chips"),
    (["--vae_encode_dtype", "bf16"], None)],
    ids=["cp_size", "fsdp_size", "vae_encode_dtype-bf16"])
def test_serve_unported_flags_exit_with_their_roadmap_item(extra, message, tmp_path):
    args = serve_cli.parse_args(["--ckpt_path", str(tmp_path / "absent"), "--device", "cpu"]
                                + extra)
    if message is None:
        with pytest.raises(FileNotFoundError):
            serve_cli.build_server(args)
        return
    with pytest.raises(SystemExit, match=re.escape(message)):
        serve_cli.build_server(args)


def test_serve_vae_encode_dtype_bf16(tmp_path):
    """`--vae_encode_dtype bf16` reaches the served pipeline: a request over
    HTTP downloads the bytes of the same request run in process on it, and
    its video is not the fp32 encode's."""
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(tmp_path / "ckpt"))
    args = serve_cli.parse_args(["--ckpt_path", str(tmp_path / "ckpt"), "--device", "cpu",
                                 "--attn_type", "ref", "--vae_encode_dtype", "bf16",
                                 "--out_dir", str(tmp_path / "out")])
    server = serve_cli.build_server(args, tokenizer=FakeTokenizer(), dtype=torch.float32)
    assert server.pipe.vae_encode_dtype == torch.bfloat16
    image = png_bytes(40, 48, seed=4)
    base, stop = serve_in_thread(server.app)
    try:
        client = VideoClient(base, timeout=30)
        task = client.submit_video_task("a cat playing piano", image, size="32x32",
                                        num_frames=5, fps=24.0, seed=7,
                                        num_inference_steps=2, negative_prompt="blurry")
        done = client.wait_for_completion(task.task_id, poll_interval=0.05, timeout=300)
        assert done.status == "completed", done.error
        dest = str(tmp_path / "download.avi")
        with urllib.request.urlopen(base + done.download_url, timeout=30) as r, \
                open(dest, "wb") as f:
            shutil.copyfileobj(r, f)
    finally:
        stop()
    frames, _ = _frames([image])
    kw = dict(KW, negative_prompt="blurry", seed=7, video_fps=24.0)
    with torch.no_grad():
        res = server.pipe("a cat playing piano", frames[0], **kw)
        fp32 = MOVAPipeline(cfg, server.pipe.modules, tokenizer=FakeTokenizer(),
                            compute_dtype=torch.float32, device="cpu", attn_impl="ref")(
            "a cat playing piano", frames[0], **kw)
    want = save_video_with_audio(str(tmp_path / "in_process.mp4"), res.video, res.audio,
                                 fps=res.fps, sample_rate=res.sample_rate)
    with open(dest, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert not np.array_equal(res.video, fp32.video)


def test_serve_offload_group_builds(tmp_path):
    """`--offload group --offload_group_size 1` (refused until A9) builds a
    server whose pipeline streams layer groups, and serves the in-process
    request's bits."""
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(tmp_path / "ckpt"))
    base = ["--ckpt_path", str(tmp_path / "ckpt"), "--device", "cpu", "--attn_type", "ref"]
    pipes = [serve_cli.build_server(serve_cli.parse_args(base + extra),
                                    tokenizer=FakeTokenizer(), dtype=torch.float32).pipe
             for extra in ([], ["--offload", "group", "--offload_group_size", "1"])]
    assert (pipes[1].offload, pipes[1].offload_group_size) == ("group", 1)
    image = np.random.default_rng(1).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    want, got = (p("a cat", image, seed=3, **KW) for p in pipes)
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.audio, want.audio)


def test_serve_needs_cuda_unless_cpu_is_asked(tmp_path):
    args = serve_cli.parse_args(["--ckpt_path", str(tmp_path / "absent")])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.build_server(args)


def test_serve_help_loads_neither_jax_pil_nor_transformers():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['prog', '--help']\n"
        "try:\n"
        "    runpy.run_module('dualforce_tpu_torch.cli.serve', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'dualforce_tpu', 'PIL', 'transformers')\n"
        "       or m.startswith('dualforce_tpu_torch.models')]\n"
        "print('BAD', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--ckpt_path" in proc.stdout and "--warmup" in proc.stdout
    assert "BAD []" in proc.stdout


# --- the pipeline backend on the tiny config ----------------------------------

KW = dict(height=32, width=32, num_frames=5, num_inference_steps=2, cfg_scale=5.0)
PROMPTS = [("a cat playing piano", 7), ("ocean waves at dusk", 8)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny fp32 checkpoint served by `cli.serve.build_server` on the CPU;
    two same-geometry requests over HTTP, their clips downloaded."""
    root = tmp_path_factory.mktemp("serve")
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(root / "ckpt"))
    args = serve_cli.parse_args(["--ckpt_path", str(root / "ckpt"), "--device", "cpu",
                                 "--attn_type", "ref", "--max_batch", "2",
                                 "--cfg_cache_interval", "2", "--warmup", "32x32x5x2",
                                 "--out_dir", str(root / "out")])
    server = serve_cli.build_server(args, tokenizer=FakeTokenizer(), dtype=torch.float32)
    groups, real = [], server.batch_backend

    def spy(tasks, out_dir, progress=None):
        groups.append([t.task_id for t in tasks])
        return real(tasks, out_dir, progress=progress)

    server.batch_backend = spy
    server.batch_window_s = 30.0     # closes once the second request is in
    base, stop = serve_in_thread(server.app)
    images = [png_bytes(40, 48, seed=4), png_bytes(36, 30, seed=5)]
    try:
        client = VideoClient(base, timeout=30)
        tasks = [client.submit_video_task(p, img, size="32x32", num_frames=5, fps=24.0,
                                          seed=s, num_inference_steps=2,
                                          negative_prompt="blurry")
                 for (p, s), img in zip(PROMPTS, images)]
        done = [client.wait_for_completion(t.task_id, poll_interval=0.05, timeout=300)
                for t in tasks]
        clips = []
        for i, t in enumerate(done):
            dest = str(root / f"download{i}.avi")
            url = base + t.download_url
            with urllib.request.urlopen(url, timeout=30) as r, open(dest, "wb") as f:
                shutil.copyfileobj(r, f)
            clips.append(dest)
    finally:
        stop()
    return dict(server=server, pipe=server.pipe, args=args, root=root, images=images,
                tasks=tasks, done=done, clips=clips, groups=groups)


def test_served_group_is_one_batch(served):
    assert served["groups"] == [[t.task_id for t in served["tasks"]]]
    for t in served["done"]:
        assert t.status == "completed", t.error
        assert t.peak_memory_mb == 0.0 and t.progress == 1.0
        assert t.file_path.endswith(".avi")     # no ffmpeg: the MJPEG AVI beside .mp4


def _frames(images):
    port, jax_ = [], []
    for raw in images:
        img = Image.open(io.BytesIO(raw)).convert("RGB")
        port.append(transforms.image_to_tensor(transforms.crop_and_resize(img, 32, 32)))
        jax_.append(jax_transforms.image_to_tensor(
            jax_transforms.crop_and_resize(img, 32, 32)))
    return port, jax_


def test_first_frames_from_bytes_match_jax(served):
    port, jax_ = _frames(served["images"])
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def in_process(served):
    frames, _ = _frames(served["images"])
    with torch.no_grad():
        results = served["pipe"].generate(
            [p for p, _ in PROMPTS], frames, negative_prompts=["blurry"] * 2,
            seeds=[s for _, s in PROMPTS], video_fps=24.0, cfg_cache_interval=2, **KW)
    return frames, results


def test_downloaded_clips_equal_the_in_process_group(served, in_process):
    _, results = in_process
    for i, (clip, res) in enumerate(zip(served["clips"], results)):
        want = save_video_with_audio(str(served["root"] / "in_process" / f"{i}.mp4"),
                                     res.video, res.audio, fps=res.fps,
                                     sample_rate=res.sample_rate)
        with open(clip, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read()
        video, audio, sr, fps = read_mjpeg_avi(clip)
        video2, audio2, _, _ = read_mjpeg_avi(want)
        np.testing.assert_array_equal(video, video2)
        np.testing.assert_array_equal(audio, audio2)
        assert video.shape == (5, 32, 32, 3) and (sr, fps) == (48000, 24.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_group_generate_matches_jax(served, in_process):
    frames, results = in_process
    _, jframes = _frames(served["images"])
    prompts, seeds = [p for p, _ in PROMPTS], [s for _, s in PROMPTS]
    kw = dict(KW, video_fps=24.0, cfg_cache_interval=2)
    state = served["pipe"].prepare_state(prompts, frames, negative_prompts=["blurry"] * 2,
                                         seeds=seeds, **kw)
    ckpt = served["args"].ckpt_path
    jpipe = JaxPipeline(jax_lc.config_from_checkpoint(ckpt),
                        jax_lc.load_pipeline_params(ckpt, dtype=jnp.float32,
                                                    to_device=False),
                        tokenizer=FakeTokenizer(), compute_dtype=jnp.float32,
                        attn_impl="ref")
    jstate = jpipe.prepare_state(prompts, jframes, negative_prompts=["blurry"] * 2,
                                 seeds=seeds, **kw)
    for key in ("condition", "ctx_pos", "ctx_neg"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    jstate = dict(jstate, latents=state["latents"].numpy(),
                  audio_latents=state["audio_latents"].numpy())
    want = jpipe.finalize_state(jpipe.denoise_state(jstate))
    for res, w in zip(results, want):
        assert res.video.shape == w.video.shape == (5, 32, 32, 3)
        diff = np.abs(res.video.astype(np.int16) - w.video.astype(np.int16))
        assert diff.max() <= 1 and np.mean(diff > 0) < 0.01
        np.testing.assert_allclose(res.audio, w.audio, rtol=1e-4, atol=1e-4)


def test_warmup_runs_nothing_on_the_cpu(served):
    pipe = served["pipe"]
    assert pipe.warmup(height=32, width=32, num_frames=5, num_inference_steps=2,
                       batch_size=2) is None
