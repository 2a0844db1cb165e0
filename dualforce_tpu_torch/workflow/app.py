"""Web UI for AI-assisted generation (the port's copy of
`dualforce_tpu/workflow/app.py`, mounted on the port's `VideoServer`;
behavioural reference: workflow/app.py — Streamlit two-mode UI; here the UI is
a single-page app served by aiohttp alongside the /v1/videos API, with no
Streamlit dependency).

Modes mirrored: simple (prompt + reference image -> video) and full
(text -> first-frame gen -> element extraction -> prompt rewrite -> video),
with task polling and history cards (live progress bars, inline result
playback, timing/memory stats, error surfacing), and per-task artifact
directories (out_dir/tasks/{id}/: input frame, idea, extracted elements,
rewritten prompt — the reference's per-task output dirs, app.py:355-520)
served at /workflow/tasks/{id}.
"""

from __future__ import annotations

import base64

from aiohttp import web

from dualforce_tpu_torch.workflow.config import WorkflowConfig
from dualforce_tpu_torch.workflow.llm_helpers import (
    extract_visual_elements,
    generate_first_frame,
    rewrite_prompt,
)

INDEX_HTML = """<!DOCTYPE html>
<html><head><title>DualForce-TPU Studio</title>
<style>
body{font-family:system-ui;margin:2rem auto;max-width:860px;color:#222}
fieldset{border:1px solid #ccc;border-radius:8px;margin-bottom:1rem}
textarea,input{width:100%;box-sizing:border-box;margin:.25rem 0}
button{padding:.5rem 1rem;border-radius:6px;border:0;background:#3b5bdb;color:#fff;cursor:pointer}
.task{border:1px solid #ddd;border-radius:8px;padding:.6rem;margin:.4rem 0}
.status-completed{color:#2b8a3e}.status-failed{color:#c92a2a}.status-running{color:#e8590c}
.status-cancelled,.status-cancelling{color:#868e96}
.cancel{background:#c92a2a;padding:.15rem .5rem;font-size:.8rem;margin-left:.4rem}
.artifacts{background:#f8f9fa;border-radius:6px;padding:.5rem;margin-top:.4rem}
.artifacts img{max-width:200px;border-radius:4px;display:block;margin:.3rem 0}
.artifacts pre{white-space:pre-wrap;font-size:.85rem;margin:.2rem 0}
details summary{cursor:pointer;color:#3b5bdb}
</style></head>
<body>
<h1>DualForce-TPU Studio</h1>
<fieldset id="serverbox" style="display:none"><legend>Server</legend>
<select id="server" onchange="selectServer()"></select>
<span id="serverinfo"></span>
</fieldset>
<fieldset><legend>Simple mode: prompt + reference image</legend>
<textarea id="prompt" rows="3" placeholder="describe the video + audio"></textarea>
<input type="file" id="ref">
<label>Size <input id="size" value="640x352"></label>
<label>Frames <input id="frames" value="193"></label>
<label>Steps <input id="steps" value="50"></label>
<label>Seed <input id="seed" value="42"></label>
<button onclick="submitSimple()">Generate</button>
</fieldset>
<fieldset><legend>Full mode: text only (first-frame gen + prompt rewrite)</legend>
<textarea id="idea" rows="2" placeholder="one-line idea"></textarea>
<button onclick="submitFull()">Run full workflow</button>
</fieldset>
<h2>Tasks</h2><div id="tasks"></div>
<script>
async function submitSimple(){
  const fd = new FormData();
  fd.append('prompt', document.getElementById('prompt').value);
  fd.append('size', document.getElementById('size').value);
  fd.append('num_frames', document.getElementById('frames').value);
  fd.append('num_inference_steps', document.getElementById('steps').value);
  fd.append('seed', document.getElementById('seed').value);
  const f = document.getElementById('ref').files[0];
  if (f) fd.append('input_reference', f);
  await fetch('/v1/videos', {method:'POST', body:fd});
  refresh();
}
async function submitFull(){
  const r = await fetch('/workflow/full', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({idea:document.getElementById('idea').value})});
  refresh();
}
function fmtTime(ts){ return ts ? new Date(ts*1000).toLocaleTimeString() : ''; }
// multi-server studio mode (workflow/studio.py): /workflow/servers exists
// only there — a plain attached server 404s and the selector stays hidden
async function loadServers(){
  try{
    const r = await fetch('/workflow/servers');
    if (!r.ok) return;
    const js = await r.json();
    const sel = document.getElementById('server');
    if (document.activeElement !== sel){  // don't yank an open dropdown
      sel.innerHTML = '';
      js.servers.forEach(s=>{
        const o = document.createElement('option');
        o.value = s.name;
        o.textContent = `${s.name} (${s.healthy ? 'up' : 'DOWN'})`;
        o.selected = s.active;
        sel.appendChild(o);
      });
    }
    const up = js.servers.filter(s=>s.healthy).length;
    document.getElementById('serverinfo').textContent =
      `${up}/${js.servers.length} healthy`;
    document.getElementById('serverbox').style.display = '';
  }catch(e){/* attached single-server mode */}
}
async function selectServer(){
  await fetch('/workflow/select', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({name:document.getElementById('server').value})});
  refresh();
}
async function cancelTask(id){
  await fetch(`/v1/videos/${id}/cancel`, {method:'POST'});
  refresh();
}
// escape untrusted text (prompts, LLM output, errors) before innerHTML
function esc(s){return String(s).replace(/[&<>"']/g, c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));}
async function loadArtifacts(id){
  const box = document.getElementById(`art-${id}`);
  if (!box || box.dataset.loaded) return;
  box.dataset.loaded = '1';
  const js = await (await fetch(`/workflow/tasks/${id}`)).json();
  let html = '';
  const a = js.artifacts || {};
  // full-mode parity with the reference app: first-frame preview inline,
  // idea / extracted elements / rewritten prompt as labeled sections
  for (const [name, val] of Object.entries(a)){
    if (/\\.(png|jpe?g)$/i.test(name)){
      html += `<div><small>${esc(name)}</small><img src="${esc(val)}"></div>`;
    } else if (name.endsWith('.txt')){
      const label = {idea:'Idea', elements:'Extracted elements',
                     prompt:'Rewritten prompt'}[name.replace('.txt','')] || name;
      html += `<div><small><b>${esc(label)}</b></small><pre>${esc(val)}</pre></div>`;
    } else {
      html += `<div><a href="${esc(val)}">${esc(name)}</a></div>`;
    }
  }
  box.innerHTML = html || '<small>no artifacts</small>';
}
async function refresh(){
  const r = await fetch('/v1/videos'); const js = await r.json();
  const el = document.getElementById('tasks'); el.innerHTML='';
  js.data.sort((a,b)=>b.created_at-a.created_at).forEach(t=>{
    const d = document.createElement('div'); d.className='task';
    const pct = Math.round(t.progress*100);
    let extra = '';
    if (t.status==='completed'){
      extra = `<a href="${t.download_url}">download</a>
        <div><video controls preload="none" width="320" src="${t.download_url}"></video></div>
        <small>took ${t.inference_time_s ? t.inference_time_s.toFixed(1) : '?'}s` +
        (t.peak_memory_mb ? `, peak HBM ${Math.round(t.peak_memory_mb)} MB` : '') +
        `</small>`;
    } else if (t.status==='failed'){
      extra = `<pre style="color:#c92a2a;white-space:pre-wrap">${esc(t.error||'')}</pre>`;
    } else if (t.status==='cancelled'){
      extra = `<small>cancelled</small>`;
    } else {
      extra = `<div style="background:#eee;border-radius:4px"><div style="background:#3b5bdb;height:6px;border-radius:4px;width:${pct}%"></div></div>`;
    }
    const cancellable = (t.status==='queued'||t.status==='running');
    d.innerHTML = `<b>${t.task_id}</b> <span class="status-${t.status}">${t.status}</span>
      ${pct}% <small>${fmtTime(t.created_at)}</small>
      — ${esc(t.prompt.slice(0,120))}` +
      (cancellable ? `<button class="cancel" onclick="cancelTask('${t.task_id}')">cancel</button>` : '') +
      `<details ontoggle="loadArtifacts('${t.task_id}')">
        <summary>artifacts</summary>
        <div class="artifacts" id="art-${t.task_id}"></div>
      </details>${extra}`;
    el.appendChild(d);
  });
}
setInterval(refresh, 3000); setInterval(loadServers, 9000);
loadServers(); refresh();
</script></body></html>"""


def attach_ui(server, wf_cfg: WorkflowConfig | None = None):
    """Mount the UI + full-workflow endpoint onto a serving.VideoServer."""
    wf_cfg = wf_cfg or WorkflowConfig()

    async def index(request):
        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def full_workflow(request):
        import asyncio

        body = await request.json()
        idea = body.get("idea", "")
        w, h = (int(x) for x in body.get("size", "640x352").split("x"))
        # the LLM helpers are blocking urllib calls with minute-scale
        # timeouts — run them in the default executor so the event loop
        # (status polling, downloads) stays responsive
        loop = asyncio.get_running_loop()
        # 1. first frame
        image_bytes = await loop.run_in_executor(
            None, lambda: generate_first_frame(idea, w, h, wf_cfg))
        b64 = base64.b64encode(image_bytes).decode()
        # 2. element extraction feeds 3. prompt rewrite
        elements = await loop.run_in_executor(
            None, lambda: extract_visual_elements(b64, wf_cfg))
        full_prompt = await loop.run_in_executor(
            None, lambda: rewrite_prompt(
                idea, wf_cfg, image_b64=None if elements else b64,
                first_frame_elements=elements or None))
        # 4. submit generation
        from dualforce_tpu_torch.serving.server import Task
        import uuid

        task_id = uuid.uuid4().hex[:16]
        import os

        # per-task artifact dir (reference app.py's per-task output dirs):
        # every intermediate of the full workflow is inspectable afterwards
        task_dir = os.path.join(server.out_dir, "tasks", task_id)
        os.makedirs(task_dir, exist_ok=True)
        image_path = os.path.join(task_dir, "first_frame.png")
        with open(image_path, "wb") as f:
            f.write(image_bytes)
        for name, content in (("idea.txt", idea),
                              ("elements.txt", elements or ""),
                              ("prompt.txt", full_prompt)):
            with open(os.path.join(task_dir, name), "w") as f:
                f.write(content)
        task = Task(task_id=task_id, prompt=full_prompt,
                    params={"negative_prompt": "", "height": h, "width": w,
                            "num_frames": int(body.get("num_frames", 193)),
                            "fps": float(body.get("fps", 24.0)),
                            "seed": int(body.get("seed", 42)),
                            "guidance_scale": float(body.get("guidance_scale", 5.0)),
                            "num_inference_steps": int(body.get("num_inference_steps", 50)),
                            "image_path": image_path})
        server.store.add(task)
        server.queue.put(task.task_id)
        return web.json_response({"task_id": task.task_id,
                                  "rewritten_prompt": full_prompt})

    def _safe_task_id(request) -> str:
        import re

        task_id = request.match_info["task_id"]
        # task ids are uuid hex; anything else (e.g. "..") could walk out of
        # the tasks/ directory when joined into a path
        if not re.fullmatch(r"[A-Za-z0-9_-]+", task_id):
            raise web.HTTPNotFound()
        return task_id

    async def task_artifacts(request):
        import os

        task_id = _safe_task_id(request)
        task_dir = os.path.join(server.out_dir, "tasks", task_id)
        out = {"task_id": task_id, "artifacts": {}}
        if os.path.isdir(task_dir):
            for name in sorted(os.listdir(task_dir)):
                path = os.path.join(task_dir, name)
                if name.endswith(".txt"):
                    with open(path) as f:
                        out["artifacts"][name] = f.read()
                else:
                    out["artifacts"][name] = f"/workflow/tasks/{task_id}/{name}"
        t = server.store.get(task_id)
        if t is not None:
            out["status"] = t.status
            out["prompt"] = t.prompt
        return web.json_response(out)

    async def task_file(request):
        import os

        task_id = _safe_task_id(request)
        name = os.path.basename(request.match_info["name"])
        path = os.path.join(server.out_dir, "tasks", task_id, name)
        if not os.path.exists(path):
            raise web.HTTPNotFound()
        return web.FileResponse(path)

    server.app.add_routes([web.get("/", index),
                           web.get("/ui", index),
                           web.post("/workflow/full", full_workflow),
                           web.get("/workflow/tasks/{task_id}", task_artifacts),
                           web.get("/workflow/tasks/{task_id}/{name}", task_file)])
    return server
