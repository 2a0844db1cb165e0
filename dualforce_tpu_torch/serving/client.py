"""HTTP client for the video-generation service (the port's copy of
`dualforce_tpu/serving/client.py`; urllib only).

Behavioural reference: workflow/sglang_client.py — VideoTask dataclass
(status/progress/download_url/file_path/inference_time_s/peak_memory_mb,
:19-51), multipart submit (:92-162), status poll, download with local-copy
fast path -> HTTP stream (:201-281), list, wait_for_completion (:315-351).
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import urllib.error
import urllib.request
import uuid


@dataclass
class VideoTask:
    task_id: str
    status: str = "queued"
    progress: float = 0.0
    prompt: str = ""
    download_url: Optional[str] = None
    file_path: Optional[str] = None
    error: Optional[str] = None
    inference_time_s: Optional[float] = None
    peak_memory_mb: Optional[float] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "VideoTask":
        return cls(
            task_id=d["task_id"], status=d.get("status", "queued"),
            progress=d.get("progress", 0.0), prompt=d.get("prompt", ""),
            download_url=d.get("download_url"), file_path=d.get("file_path"),
            error=d.get("error"), inference_time_s=d.get("inference_time_s"),
            peak_memory_mb=d.get("peak_memory_mb"), raw=d)


class VideoClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8000", timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # --- http helpers -------------------------------------------------------
    def _get_json(self, path: str) -> Dict[str, Any]:
        import json

        with urllib.request.urlopen(self.base_url + path, timeout=self.timeout) as r:
            return json.load(r)

    def _post_multipart(self, path: str, fields: Dict[str, str],
                        file_field: Optional[str] = None,
                        file_bytes: bytes = b"",
                        file_name: str = "reference.png") -> Dict[str, Any]:
        import json

        boundary = uuid.uuid4().hex
        body = b""
        for k, v in fields.items():
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{k}\"\r\n\r\n{v}\r\n").encode()
        if file_field is not None:
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{file_field}\"; filename=\"{file_name}\"\r\n"
                     f"Content-Type: application/octet-stream\r\n\r\n").encode()
            body += file_bytes + b"\r\n"
        body += f"--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.load(r)

    # --- api ----------------------------------------------------------------
    def health(self) -> bool:
        try:
            return self._get_json("/health").get("status") == "ok"
        except (urllib.error.URLError, OSError):
            return False

    def submit_video_task(
        self, prompt: str, image_bytes: bytes, *, size: str = "640x352",
        num_frames: int = 193, fps: float = 24.0, seed: int = 42,
        guidance_scale: float = 5.0, guidance_scale_bridge: float = 0.0,
        num_inference_steps: int = 50,
        negative_prompt: str = "",
        timeout_s: Optional[float] = None,
    ) -> VideoTask:
        fields = {"prompt": prompt, "size": size, "num_frames": str(num_frames),
                  "fps": str(fps), "seed": str(seed),
                  "guidance_scale": str(guidance_scale),
                  "guidance_scale_bridge": str(guidance_scale_bridge),
                  "num_inference_steps": str(num_inference_steps),
                  "negative_prompt": negative_prompt}
        if timeout_s is not None:
            fields["timeout_s"] = str(timeout_s)
        resp = self._post_multipart(
            "/v1/videos", fields,
            file_field="input_reference", file_bytes=image_bytes)
        return VideoTask.from_json(resp)

    def get_task(self, task_id: str) -> VideoTask:
        return VideoTask.from_json(self._get_json(f"/v1/videos/{task_id}"))

    def cancel(self, task_id: str) -> VideoTask:
        """Cancel a queued task (immediate) or a running one (resolves to
        cancelled when the in-flight step finishes)."""
        import json

        req = urllib.request.Request(
            self.base_url + f"/v1/videos/{task_id}/cancel", data=b"",
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return VideoTask.from_json(json.load(r))

    def list_tasks(self) -> List[VideoTask]:
        return [VideoTask.from_json(d)
                for d in self._get_json("/v1/videos")["data"]]

    def download(self, task: VideoTask, dest: str) -> str:
        """Local-copy fast path when server-side file is reachable, else HTTP
        stream (sglang_client.py:239-243)."""
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        if task.file_path and os.path.exists(task.file_path):
            shutil.copyfile(task.file_path, dest)
        else:
            url = self.base_url + (task.download_url or
                                   f"/v1/videos/{task.task_id}/content")
            with urllib.request.urlopen(url, timeout=self.timeout) as r, \
                    open(dest, "wb") as f:
                shutil.copyfileobj(r, f)
        if os.path.getsize(dest) == 0:
            raise IOError(f"empty download for task {task.task_id}")
        return dest

    def wait_for_completion(self, task_id: str, poll_interval: float = 5.0,
                            timeout: float = 1800.0) -> VideoTask:
        deadline = time.time() + timeout
        while time.time() < deadline:
            task = self.get_task(task_id)
            if task.status in ("completed", "failed", "cancelled"):
                return task
            time.sleep(poll_interval)
        raise TimeoutError(f"task {task_id} did not finish in {timeout}s")
