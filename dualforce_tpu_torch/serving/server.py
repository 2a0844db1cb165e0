"""HTTP video-generation service (the port's copy of
`dualforce_tpu/serving/server.py`; tests hold the two equal request for
request).

Mirrors the serving surface the reference gets from SGLang
(README.md:153-212, workflow/launch_sglang_server.sh): REST `/v1/videos`
multipart submit (prompt, input_reference, size, num_frames, fps, seed,
guidance_scale, num_inference_steps), task-status polling, file download,
`/health` + `/v1/models` probes.

Implementation: aiohttp app + a single background worker thread draining a
task queue into the generation backend. The backend is injectable: tests
use a fake; production passes `make_pipeline_backend(pipe)` over the port's
`MOVAPipeline`, and `make_pipeline_batch_backend(pipe)` runs same-geometry
tasks as one batch.

Under a (fsdp, cp) mesh the port runs one process per rank (the JAX
server is one process driving every chip): rank 0 runs this server and its
worker thread, and `MeshControl` hands each group's generate arguments to
the other ranks, which follow (`MeshControl.follow`) and run the same
`generate`; only rank 0 writes clips, updates progress and answers HTTP.

Progress: the port's sampler calls `MOVAPipeline.progress_cb(step, total)`
on the host once a step's launches are queued, not when the card has run
them (JAX's `jax.debug.callback` fires when the device reaches the step).
So a task's progress can run ahead of the card by the work still queued;
the worker's clamp keeps it non-decreasing and below 1.0 until the task is
`completed`, which sets it to 1.0 after the clips are written.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import traceback
import uuid
from dataclasses import asdict, dataclass, field
from queue import Queue
from typing import Any, Callable, Dict, Optional, Tuple

from aiohttp import web


@dataclass
class Task:
    task_id: str
    # queued | running | cancelling | completed | failed | cancelled
    status: str = "queued"
    prompt: str = ""
    progress: float = 0.0
    created_at: float = field(default_factory=time.time)
    completed_at: Optional[float] = None
    file_path: Optional[str] = None
    download_url: Optional[str] = None
    error: Optional[str] = None
    inference_time_s: Optional[float] = None
    peak_memory_mb: Optional[float] = None
    params: Dict[str, Any] = field(default_factory=dict)


class TaskStore:
    """In-memory task registry persisted to tasks.json (workflow/app.py style)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._tasks: Dict[str, Task] = {}
        self._lock = threading.Lock()
        self._path = os.path.join(out_dir, "tasks.json")
        self._load()

    def _load(self):
        if os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    for rec in json.load(f):
                        self._tasks[rec["task_id"]] = Task(**rec)
            except (json.JSONDecodeError, TypeError):
                pass

    def _persist(self):
        with open(self._path, "w") as f:
            json.dump([asdict(t) for t in self._tasks.values()], f)

    def add(self, task: Task):
        with self._lock:
            self._tasks[task.task_id] = task
            self._persist()

    def update(self, task_id: str, _persist: bool = True, **kw):
        with self._lock:
            t = self._tasks[task_id]
            for k, v in kw.items():
                setattr(t, k, v)
            if _persist:
                self._persist()

    def transition(self, task_id: str, allowed_from, to: str,
                   **kw) -> Tuple[Optional[str], bool]:
        """Compare-and-set: status -> `to` iff the CURRENT status is in
        `allowed_from`, atomically with the read. Returns (post-call status,
        whether this call changed it); (None, False) for unknown ids. Plain
        update() check-then-set races the worker thread: a cancel could
        overwrite a concurrent 'completed', or a worker's 'running' could
        resurrect a task the cancel handler had just cancelled out of the
        queue."""
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None:
                return None, False
            if t.status not in allowed_from:
                return t.status, False
            t.status = to
            for k, v in kw.items():
                setattr(t, k, v)
            self._persist()
            return to, True

    def resolve_finished(self, task_id: str, error: Optional[str] = None,
                         **completed_kw) -> Optional[str]:
        """Terminal transition when the backend returns, atomic with any
        concurrent cancel: cancelling -> cancelled (result discarded),
        otherwise -> failed (error given) or completed. Returns the final
        status."""
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None:
                return None
            if t.status == "cancelling":
                t.status = "cancelled"
                t.completed_at = time.time()
            elif error is not None:
                t.status = "failed"
                t.error = error
            else:
                t.status = "completed"
                for k, v in completed_kw.items():
                    setattr(t, k, v)
            self._persist()
            return t.status

    def get(self, task_id: str) -> Optional[Task]:
        return self._tasks.get(task_id)

    def all(self):
        return list(self._tasks.values())


def _accepts_progress(fn) -> bool:
    """Signature-based (a try/except TypeError would silently swallow real
    TypeErrors raised inside the backend)."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return "progress" in sig.parameters or any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values())


def _call_with_optional_progress(backend, task, out_dir, progress):
    if _accepts_progress(backend):
        return backend(task, out_dir, progress=progress)
    return backend(task, out_dir)


# a follower waits for the next group in a collective of the control group; its own
# timeout (7 days) keeps an idle server from dying of gloo's default 30 minutes
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0


# a rank whose generate failed waits this long for the other ranks' outcomes: they come at once
# where it failed in `prepare_state` (no collective there) or where every rank failed alike,
# and never where another rank still waits in a collective of the denoise the failed rank left
FAILURE_WAIT_S = 120.0


class GroupFailed(RuntimeError):
    """A group's generate failed on some rank of the mesh."""


class MeshControl:
    """How rank 0's server drives the other ranks of a mesh through each
    group's `generate` (one process per rank, as torchrun starts them).

    Every rank makes one in the same order after joining the world: a gloo
    group of the whole world of its own (whatever the data backend, NCCL
    included), with a timeout of `CONTROL_TIMEOUT_S`, so that a follower
    may wait for the next group as long as the server idles. Rank 0 calls
    `lead(kwargs, images)` from its worker thread once a group's first
    frames are decoded and checked: it broadcasts the generate arguments (the
    prompts, negatives, seeds, geometry, steps, guidance and the server's
    overrides) as one object and the images as one fp32 tensor, and every
    rank runs the group's generate on them in two stages. Each rank's ok
    flag or error string is gathered after `prepare_state` (the encodes,
    which make no collective), before the first data collective, and again
    after the denoise and decode. A failure at either gather, on any rank,
    raises on rank 0 with the first failed rank's message, and every rank
    goes on serving. A failure inside the denoise on some ranks only leaves
    the others waiting in one of its collectives: the failed rank waits
    `FAILURE_WAIT_S` for their outcomes, then ends its process, as does a
    rank whose control collective fails (a rank gone), so that the others'
    collectives raise and torchrun stops the world: an error, never a hang.
    The other ranks sit in `follow` until `stop`: rank 0 broadcasts a stop
    message once the group in flight (if any) has ended, and each follower
    returns."""

    def __init__(self, pipe):
        import datetime

        import torch.distributed as dist

        self.pipe = pipe
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
        self.rank = dist.get_rank()
        self.lock = threading.Lock()
        self.stopped = False
        self.groups = 0         # groups run on this rank

    def _run(self, kwargs: Dict[str, Any], images) -> list:
        """This rank's generate on the group (`pipe.generate`'s stages), with
        every rank's outcome gathered after `prepare_state` and at the end;
        raises with the first failed rank's error where one failed."""
        pipe = self.pipe
        self.groups += 1
        state = self._stage(lambda: pipe.prepare_state(images=list(images.numpy()), **kwargs))
        return self._stage(lambda: pipe.finalize_state(pipe.denoise_state(state)))

    def _stage(self, fn):
        """fn() on this rank, then every rank's outcome; raises `GroupFailed`
        with the first failed rank's error where one failed."""
        import torch

        result, error = None, None
        try:
            with torch.no_grad():
                result = fn()
        except Exception as e:  # noqa: BLE001 — reported to every rank, then raised
            traceback.print_exc()
            error = f"rank {self.rank}: {type(e).__name__}: {e}"
        failed = self._outcomes(error)
        if failed:
            raise GroupFailed(failed[0])
        return result

    def _outcomes(self, error: Optional[str]) -> list:
        """Every failed rank's error string, in rank order (none where the
        group succeeded everywhere); ends this process where the ranks'
        outcomes cannot be had (see the class)."""
        import datetime

        import torch
        import torch.distributed as dist

        flags = [torch.zeros(1, dtype=torch.int32) for _ in range(dist.get_world_size())]
        try:
            work = dist.all_gather(flags, torch.tensor([int(error is not None)], dtype=torch.int32),
                                   group=self.group, async_op=True)
            done = (work.wait() if error is None else
                    work.wait(timeout=datetime.timedelta(seconds=FAILURE_WAIT_S)))
        except RuntimeError as e:
            done, error = False, f"{error or 'the outcomes'}; {type(e).__name__}: {e}"
        if not done:
            self._abort(f"the other ranks' outcomes did not come ({error})")
        if not any(int(f) for f in flags):
            return []
        outcomes = [None] * dist.get_world_size()
        dist.all_gather_object(outcomes, error, group=self.group)     # every rank is here
        return [x for x in outcomes if x is not None]

    def _abort(self, reason: str) -> None:
        print(f"[serve] rank {self.rank}: {reason}; this process ends so that the other "
              "ranks' collectives raise", file=sys.stderr, flush=True)
        os._exit(1)

    def _broadcast(self, message, images=None):
        import torch
        import torch.distributed as dist

        box = [message]
        dist.broadcast_object_list(box, src=0, group=self.group)
        message = box[0]
        if message["op"] == "generate":
            if images is None:
                images = torch.empty(message["images"], dtype=torch.float32)
            dist.broadcast(images, src=0, group=self.group)
        return message, images

    def lead(self, kwargs: Dict[str, Any], images) -> list:
        """Rank 0: the group's generate on every rank (images: the decoded
        first frames, [B, H, W, 3] fp32 numpy)."""
        import numpy as np
        import torch

        with self.lock:
            if self.stopped:
                raise RuntimeError("the server is stopping")
            images = torch.from_numpy(np.ascontiguousarray(np.stack(images), np.float32))
            try:
                self._broadcast({"op": "generate", "kwargs": kwargs,
                                 "images": tuple(images.shape)}, images)
            except RuntimeError as e:
                self._abort(f"the group could not reach the other ranks ({e})")
            return self._run(kwargs, images)

    def follow(self) -> int:
        """Another rank: run each group rank 0 leads until it stops; returns
        the number of groups run."""
        while True:
            message, images = self._broadcast(None)
            if message["op"] == "stop":
                return self.groups
            try:
                self._run(message["kwargs"], images)
            except GroupFailed:
                pass            # rank 0 marks the group failed; the next one follows

    def stop(self) -> None:
        """Rank 0: after the group in flight, tell every follower to return
        (once)."""
        with self.lock:
            if not self.stopped:
                self.stopped = True
                self._broadcast({"op": "stop"})


def make_pipeline_backend(pipe, gen_overrides: Optional[Dict[str, Any]] = None,
                          control: Optional[MeshControl] = None) -> Callable:
    """Wrap a MOVAPipeline into the backend callable used by the worker."""
    batch = make_pipeline_batch_backend(pipe, gen_overrides, control)

    def backend(task: Task, out_dir: str, progress=None) -> Dict[str, Any]:
        return batch([task], out_dir, progress=progress)[0]

    return backend


def make_pipeline_batch_backend(pipe,
                                gen_overrides: Optional[Dict[str, Any]] = None,
                                control: Optional[MeshControl] = None) -> Callable:
    """Batched backend: same-geometry tasks run as one batch through
    `MOVAPipeline.generate`, the continuous-batching unit (SURVEY.md §7.2
    phase 8): each attention of the group is one launch at batch B.

    gen_overrides: server-level kwargs splatted into every generate() call
    (e.g. cfg_cache_interval / cfg_batch — serving accelerators that are
    deploy-time policy, not request fields).

    The worker thread calls it: gradients are off for the whole call (grad
    mode is thread-local), and every tensor goes to `pipe.device`, never to
    the thread's current device. `peak_memory_mb` is the card's peak
    allocated memory since the process started or its peak statistics were
    last reset (`torch.cuda.max_memory_allocated`), 0 on the CPU.

    control: under a mesh, rank 0's `MeshControl`: the group's first frames
    are decoded and checked here first (a bad image fails on rank 0 alone,
    before any rank hears of the group), then every rank generates."""
    import torch
    from PIL import Image

    from dualforce_tpu_torch.data.transforms import crop_and_resize, image_to_tensor
    from dualforce_tpu_torch.utils.av_io import save_video_with_audio

    def batch_backend(tasks, out_dir: str, progress=None):
        p0 = tasks[0].params
        h, w = p0["height"], p0["width"]
        images = []
        for t in tasks:
            if t.params.get("image_path"):
                with open(t.params["image_path"], "rb") as f:
                    raw = f.read()
            else:
                raw = bytes.fromhex(t.params.get("image_hex", ""))
            img = Image.open(io.BytesIO(raw)).convert("RGB")
            images.append(image_to_tensor(crop_and_resize(img, h, w)))
        # per-step progress: the sampler calls pipe.progress_cb on the host
        # after each step; route it to the task store for the whole group
        if progress is not None:
            pipe.progress_cb = lambda i, n: progress(i / max(n, 1))
        try:
            with torch.no_grad():
                results = _generate(pipe, tasks, images, h, w, p0)
        finally:
            pipe.progress_cb = None
        peak = (torch.cuda.max_memory_allocated(pipe.device) / 1e6
                if pipe.device.type == "cuda" else 0.0)
        out = []
        for t, r in zip(tasks, results):
            path = save_video_with_audio(
                os.path.join(out_dir, f"{t.task_id}.mp4"), r.video, r.audio,
                fps=r.fps, sample_rate=r.sample_rate)
            out.append({"file_path": path, "peak_memory_mb": peak})
        return out

    def _generate(pipe, tasks, images, h, w, p0):
        kwargs = dict(
            prompts=[t.prompt for t in tasks],
            negative_prompts=[t.params.get("negative_prompt", "") for t in tasks],
            seeds=[t.params.get("seed", 42) for t in tasks],
            height=h, width=w, num_frames=p0.get("num_frames", 193),
            video_fps=p0.get("fps", 24.0),
            num_inference_steps=p0.get("num_inference_steps", 50),
            cfg_scale=p0.get("guidance_scale", 5.0),
            cfg_scale_bridge=p0.get("guidance_scale_bridge", 0.0),
            **(gen_overrides or {}))
        if control is not None:
            return control.lead(kwargs, images)
        return pipe.generate(images=images, **kwargs)

    return batch_backend


def _geom_key(task: Task):
    """Tasks batch together only when every shape-defining knob matches."""
    p = task.params
    return (p.get("height"), p.get("width"), p.get("num_frames"),
            p.get("num_inference_steps"), p.get("guidance_scale"),
            p.get("guidance_scale_bridge"), p.get("fps"))


class VideoServer:
    def __init__(self, backend: Callable, out_dir: str = "./server_outputs",
                 model_name: str = "dualforce-tpu/mova",
                 batch_backend: Optional[Callable] = None,
                 max_batch: int = 1, batch_window_s: float = 0.25,
                 queue_timeout_s: Optional[float] = None):
        """queue_timeout_s: default max time a task may wait in the queue
        before it is failed as timed out (per-request `timeout_s` overrides).
        None = wait forever. Enforced when the worker pops the task AND
        lazily on status reads, so pollers see the timeout without a sweeper
        thread."""
        self.backend = backend
        self.batch_backend = batch_backend
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.queue_timeout_s = queue_timeout_s
        self.store = TaskStore(out_dir)
        self.out_dir = out_dir
        # under a mesh, the `MeshControl` the backends lead the other ranks with
        self.control: Optional[MeshControl] = None
        self.model_name = model_name
        self.queue: "Queue[str]" = Queue()
        # restart recovery: tasks.json survives the process (reference
        # workflow/app.py behaviour) — a task caught mid-generation is failed
        # (its partial state is gone), still-queued work is re-enqueued
        for t in sorted(self.store.all(), key=lambda t: t.created_at):
            if t.status == "running":
                self.store.update(t.task_id, status="failed",
                                  error="server restarted mid-generation")
            elif t.status == "cancelling":
                # the in-flight generation died with the process; the cancel wins
                self.store.update(t.task_id, status="cancelled",
                                  completed_at=time.time())
            elif t.status == "queued":
                self.queue.put(t.task_id)
        self._worker = threading.Thread(target=self._run_worker, daemon=True)
        self._worker.start()
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.add_routes([
            web.get("/health", self.health),
            web.get("/v1/models", self.models),
            web.post("/v1/videos", self.submit),
            web.get("/v1/videos", self.list_tasks),
            web.get("/v1/videos/{task_id}", self.status),
            web.get("/v1/videos/{task_id}/content", self.download),
            web.delete("/v1/videos/{task_id}", self.cancel),
            web.post("/v1/videos/{task_id}/cancel", self.cancel),
        ])

    # --- cancellation / timeout ----------------------------------------------
    def _task_timeout(self, t: Task) -> Optional[float]:
        return t.params.get("timeout_s", self.queue_timeout_s)

    def _expire_if_queued_too_long(self, t: Optional[Task]) -> Optional[Task]:
        """Fail a still-queued task whose queue wait exceeded its timeout
        (lazy: called from status reads and from the worker pop)."""
        if t is not None and t.status == "queued":
            limit = self._task_timeout(t)
            if limit is not None and time.time() - t.created_at > limit:
                self.store.update(t.task_id, status="failed",
                                  error=f"timed out after {limit:.0f}s in queue")
                return self.store.get(t.task_id)
        return t

    # --- worker -------------------------------------------------------------
    def _next_group(self, pending):
        """Pop the head task plus up to max_batch-1 same-geometry tasks.
        Cancelled / timed-out tasks are skipped."""
        head = None
        while pending and head is None:
            head = self._expire_if_queued_too_long(
                self.store.get(pending.popleft()))
            if head is not None and head.status != "queued":
                head = None  # cancelled or timed out while waiting
        if head is None:
            return []
        group = [head]
        if self.batch_backend is not None and self.max_batch > 1:
            key = _geom_key(head)
            rest = []
            while pending and len(group) < self.max_batch:
                tid = pending.popleft()
                t = self._expire_if_queued_too_long(self.store.get(tid))
                if t is None or t.status != "queued":
                    continue
                if _geom_key(t) == key:
                    group.append(t)
                else:
                    rest.append(tid)
            pending.extendleft(reversed(rest))
        return group

    def _run_worker(self):
        import collections
        from queue import Empty

        pending = collections.deque()
        while True:
            fresh = not pending
            if fresh:
                pending.append(self.queue.get())   # block until work arrives
            # short batching window: pick up tasks that arrive together.
            # Skipped when leftovers are pending (they already waited one
            # window) and cut short once a full batch is available.
            deadline = time.time() + self.batch_window_s
            while self.max_batch > 1 and fresh and len(pending) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    pending.append(self.queue.get(timeout=timeout))
                except Empty:
                    break
            group = self._next_group(pending)
            if not group:
                continue
            # CAS queued->running: a cancel that landed between the queue pop
            # and here already moved the task to 'cancelled' — it must not be
            # resurrected (or generated at all)
            group = [t for t in group
                     if self.store.transition(t.task_id, ("queued",),
                                              "running", progress=0.05)[1]]
            if not group:
                continue
            t0 = time.time()
            def _progress(frac, _group=group):
                # clamp below 1.0: "completed" flips it to exactly 1.0
                frac = min(max(float(frac), 0.05), 0.99)
                for gt in _group:
                    cur = self.store.get(gt.task_id)
                    # never let progress regress
                    if cur is not None and cur.progress >= frac:
                        continue
                    # progress ticks need no durability: skip the tasks.json
                    # rewrite (status changes still persist)
                    self.store.update(gt.task_id, _persist=False,
                                      progress=frac)

            try:
                if self.batch_backend is not None:
                    if _accepts_progress(self.batch_backend):
                        results = self.batch_backend(group, self.out_dir,
                                                     progress=_progress)
                    else:
                        results = self.batch_backend(group, self.out_dir)
                else:
                    results = [
                        _call_with_optional_progress(self.backend, t,
                                                     self.out_dir, _progress)
                        for t in group]
                if len(results) != len(group):
                    raise RuntimeError(
                        f"backend returned {len(results)} results for "
                        f"{len(group)} tasks")  # -> whole group marked failed
                for t, result in zip(group, results):
                    # atomic with a concurrent cancel: cancel arrived mid-
                    # generation -> 'cancelled' (the in-flight generation
                    # is not preempted; result discarded), else 'completed'
                    self.store.resolve_finished(
                        t.task_id, progress=1.0,
                        completed_at=time.time(),
                        inference_time_s=time.time() - t0,
                        file_path=result.get("file_path"),
                        peak_memory_mb=result.get("peak_memory_mb"),
                        download_url=f"/v1/videos/{t.task_id}/content")
            except Exception as e:  # noqa: BLE001 — group-level failure isolation
                traceback.print_exc()
                for t in group:
                    self.store.resolve_finished(t.task_id, error=str(e))

    # --- handlers -----------------------------------------------------------
    async def health(self, request):
        return web.json_response({"status": "ok"})

    async def models(self, request):
        return web.json_response({"data": [{"id": self.model_name}]})

    async def submit(self, request):
        if request.content_type.startswith("multipart"):
            fields: Dict[str, Any] = {}
            image_bytes = b""
            async for part in (await request.multipart()):
                if part.name == "input_reference":
                    image_bytes = await part.read(decode=False)
                else:
                    fields[part.name] = (await part.text())
        else:
            fields = dict(await request.post())
            image_bytes = b""
        size = fields.get("size", "640x352")
        try:
            w, h = (int(x) for x in size.split("x"))
            num_frames = int(fields.get("num_frames", 193))
            fps = float(fields.get("fps", 24.0))
            seed = int(fields.get("seed", 42))
            guidance = float(fields.get("guidance_scale", 5.0))
            guidance_bridge = float(fields.get("guidance_scale_bridge", 0.0))
            steps = int(fields.get("num_inference_steps", 50))
            timeout_s = (float(fields["timeout_s"])
                         if "timeout_s" in fields else None)
        except (ValueError, TypeError) as e:
            return web.json_response(
                {"error": f"invalid request field: {e}"}, status=400)
        task_id = uuid.uuid4().hex[:16]
        # reference image goes to DISK: keeping hex payloads in Task params
        # would make tasks.json (rewritten on every status update) grow by
        # 2x the image size per task, forever
        image_path = os.path.join(self.out_dir, f"{task_id}.input.bin")
        with open(image_path, "wb") as f:
            f.write(image_bytes)
        task = Task(
            task_id=task_id,
            prompt=fields.get("prompt", ""),
            params={
                "negative_prompt": fields.get("negative_prompt", ""),
                "height": h, "width": w,
                "num_frames": num_frames,
                "fps": fps,
                "seed": seed,
                "guidance_scale": guidance,
                "guidance_scale_bridge": guidance_bridge,
                "num_inference_steps": steps,
                "image_path": image_path,
                **({"timeout_s": timeout_s} if timeout_s is not None else {}),
            })
        self.store.add(task)
        self.queue.put(task.task_id)
        return web.json_response({"task_id": task.task_id, "status": task.status})

    async def status(self, request):
        task = self._expire_if_queued_too_long(
            self.store.get(request.match_info["task_id"]))
        if task is None:
            return web.json_response({"error": "not found"}, status=404)
        d = asdict(task)
        d["params"].pop("image_hex", None)
        return web.json_response(d)

    async def list_tasks(self, request):
        out = []
        for t in self.store.all():
            d = asdict(self._expire_if_queued_too_long(t))
            d["params"].pop("image_hex", None)
            out.append(d)
        return web.json_response({"data": out})

    async def cancel(self, request):
        """DELETE /v1/videos/{id} (or POST .../cancel): queued tasks cancel
        immediately; a running task flips to 'cancelling' and resolves to
        'cancelled' when its in-flight generation finishes (it is not
        preempted). Terminal tasks return 409."""
        task_id = request.match_info["task_id"]
        # two CAS attempts, each atomic with the worker's own transitions:
        # queued -> cancelled outright, else running -> cancelling
        status, changed = self.store.transition(
            task_id, ("queued",), "cancelled", completed_at=time.time())
        if status is None:
            return web.json_response({"error": "not found"}, status=404)
        if not changed:
            status, changed = self.store.transition(task_id, ("running",),
                                                    "cancelling")
            if not changed and status != "cancelling":  # terminal
                return web.json_response(
                    {"error": f"task is {status}"}, status=409)
        return web.json_response({"task_id": task_id, "status": status})

    async def download(self, request):
        task = self.store.get(request.match_info["task_id"])
        if task is None or not task.file_path or not os.path.exists(task.file_path):
            return web.json_response({"error": "not ready"}, status=404)
        return web.FileResponse(task.file_path)

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        web.run_app(self.app, host=host, port=port)

    def stop(self) -> None:
        """Under a mesh, tell the following ranks to return once the group
        in flight has ended (`MeshControl.stop`); nothing otherwise."""
        if self.control is not None:
            self.control.stop()


def serve_in_thread(app: web.Application) -> Tuple[str, Callable[[], None]]:
    """Serve `app` on 127.0.0.1 at a free port from a daemon thread, for an
    in-process caller that drives it over HTTP (a server, or the studio in
    front of one). Returns (base url, stop); stop closes the app's runner
    and ends the thread."""
    import asyncio

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    ready, holder = threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        holder["port"] = site._server.sockets[0].getsockname()[1]
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not ready.wait(30):
        raise RuntimeError("the HTTP server did not start")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)

    return f"http://127.0.0.1:{holder['port']}", stop
