"""The port's workflow layer (`dualforce_tpu_torch/workflow/`, the two
workflow CLIs) against the JAX package's, on the CPU. Every comparison is
exact: the port's modules are copies.

- `INDEX_HTML`, `parse_servers` and `WorkflowConfig` (defaults and from the
  environment) equal JAX's.
- The providers and the helpers send equal requests and give equal results
  against one fake API server (`tests/test_workflow_providers.py`'s), for
  each provider alone, for all of them with Gemini failing, and with none
  (the offline fallbacks).
- `attach_ui` on the port's `VideoServer` and on JAX's, with the same fake
  backend and no provider: the UI, the full workflow, its artifacts and the
  path traversals give equal codes and bodies.
- The studios (port and JAX) over the same upstreams: registry, select
  (200, 400, 404), the proxy (a request body forwarded, a 4 MiB body
  streamed, a gzip body decoded and its Content-Encoding dropped) and the
  502 of a dead upstream.
- `cli/workflow_tools.py` writes and prints what `scripts/workflow_tools.py`
  does, and sends the same requests; `cli/workflow_studio.py` has the JAX
  script's flags.
"""

import argparse
import base64
import dataclasses
import gzip
import http.client
import importlib.util
import json
import os
import socket
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
from aiohttp import web

from dualforce_tpu.serving import server as jax_server
from dualforce_tpu.workflow import app as jax_app
from dualforce_tpu.workflow import config as jax_config
from dualforce_tpu.workflow import llm_helpers as jax_helpers
from dualforce_tpu.workflow import providers as jax_providers
from dualforce_tpu.workflow import studio as jax_studio

from dualforce_tpu_torch.cli import workflow_studio as studio_cli
from dualforce_tpu_torch.cli import workflow_tools as tools_cli
from dualforce_tpu_torch.serving import server as port_server
from dualforce_tpu_torch.serving.server import serve_in_thread
from dualforce_tpu_torch.workflow import app as port_app
from dualforce_tpu_torch.workflow import config as port_config
from dualforce_tpu_torch.workflow import llm_helpers as port_helpers
from dualforce_tpu_torch.workflow import providers as port_providers
from dualforce_tpu_torch.workflow import studio as port_studio

from test_torch_serving import call
from test_workflow_providers import PNG_BYTES, _FakeAPIs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": dict(config=jax_config, providers=jax_providers, helpers=jax_helpers,
                app=jax_app, studio=jax_studio, server=jax_server),
    "port": dict(config=port_config, providers=port_providers, helpers=port_helpers,
                 app=port_app, studio=port_studio, server=port_server),
}
ENV = ["DUALFORCE_SERVER_URL", "DUALFORCE_POLL_INTERVAL", "DUALFORCE_TASK_TIMEOUT",
       "DUALFORCE_OUTPUT_DIR", "GEMINI_API_KEY", "GEMINI_API_URL", "GEMINI_MODEL",
       "GEMINI_IMAGE_MODEL", "DASHSCOPE_API_KEY", "DASHSCOPE_BASE_URL",
       "DASHSCOPE_TEXT_MODEL", "DASHSCOPE_VISION_MODEL", "DASHSCOPE_IMAGE_MODEL",
       "DUALFORCE_LLM_API_BASE", "DUALFORCE_LLM_API_KEY", "DUALFORCE_LLM_MODEL",
       "DUALFORCE_IMAGE_API_BASE", "DUALFORCE_IMAGE_API_KEY", "DUALFORCE_IMAGE_MODEL"]


@pytest.fixture
def no_providers(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def test_index_html_matches_jax():
    assert port_app.INDEX_HTML == jax_app.INDEX_HTML


@pytest.mark.parametrize("spec", ["a=http://x:1, b = http://y:2/ ",
                                  "mova-360p=http://h:8000,mova-720p=http://h:8001",
                                  "only=http://z", "", " , ", "justaurl", "a=1,b"])
def test_parse_servers_matches_jax(spec):
    def run(mod):
        try:
            return mod.parse_servers(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(port_studio) == run(jax_studio)


def test_workflow_config_matches_jax(no_providers, monkeypatch):
    assert dataclasses.asdict(port_config.WorkflowConfig()) == \
        dataclasses.asdict(jax_config.WorkflowConfig())
    for i, name in enumerate(ENV):
        monkeypatch.setenv(name, str(i + 1))
    port, jax_ = port_config.WorkflowConfig(), jax_config.WorkflowConfig()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_)
    for prop in ("gemini_available", "dashscope_available", "openai_chat_available",
                 "openai_image_available", "llm_available", "image_gen_available"):
        assert getattr(port, prop) == getattr(jax_, prop), prop


# --- providers and helpers against one fake API server ----------------------------

@pytest.fixture
def fake_api():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeAPIs)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    _FakeAPIs.requests_log = []
    _FakeAPIs.fail_gemini = False
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    thread.join(10)


def _cfg(config_mod, base, kind):
    kw = {}
    if kind in ("gemini", "all"):
        kw.update(gemini_api_key="gk", gemini_api_base=base)
    if kind in ("dashscope", "all"):
        kw.update(dashscope_api_key="dk", dashscope_api_base=base + "/api/v1")
    if kind in ("openai", "all"):
        kw.update(llm_api_base=base + "/v1", llm_api_key="ok", llm_model="m",
                  image_api_base=base + "/v1", image_api_key="ok", image_model="im")
    return config_mod.WorkflowConfig(**kw)


def _provider_script(pkg, base, kind):
    prov, helpers = pkg["providers"], pkg["helpers"]
    cfg = _cfg(pkg["config"], base, kind)
    b64 = base64.b64encode(PNG_BYTES).decode()
    _FakeAPIs.requests_log = []
    out = []

    def rec(fn, *args, **kw):
        try:
            out.append(("ok", fn(*args, **kw)))
        except Exception as e:  # noqa: BLE001 — the exception is the result compared
            out.append((type(e).__name__, str(e)))

    rec(prov.text_providers, cfg)
    rec(prov.image_providers, cfg)
    rec(prov.chat_any, cfg, "sys", "hello")
    rec(prov.chat_any, cfg, None, "describe", image_b64=b64)
    rec(prov.image_any, cfg, "p" * 900, 720, 1280)
    rec(prov.image_any, cfg, "a cat", 1280, 720)
    rec(helpers.first_frame_prompt, "a corgi drumming", cfg)
    rec(helpers.generate_first_frame, "a corgi drumming", 64, 48, cfg)
    rec(helpers.generate_first_frame, "a corgi", 48, 64, cfg, author_prompt=False)
    rec(helpers.extract_visual_elements, b64, cfg)
    rec(helpers.rewrite_prompt, "idea", cfg, first_frame_elements="a corgi")
    rec(helpers.rewrite_prompt, "idea", cfg, image_b64=b64)
    sent = [(r["path"], r["body"], {k.lower(): v for k, v in r["headers"].items()})
            for r in _FakeAPIs.requests_log]
    return out, sent


@pytest.mark.parametrize("kind", ["gemini", "dashscope", "openai", "all", "offline"])
def test_providers_and_helpers_match_jax(fake_api, kind):
    _FakeAPIs.fail_gemini = kind == "all"
    port = _provider_script(PKGS["port"], fake_api, kind)
    jax_ = _provider_script(PKGS["jax"], fake_api, kind)
    assert port == jax_
    results, sent = port
    if kind == "offline":
        assert not sent
        assert results[6] == ("ok", "a corgi drumming")
        assert results[7][1][:8] == b"\x89PNG\r\n\x1a\n"     # the gradient frame
    else:
        assert sent and results[2][0] == "ok"


# --- the UI and the full workflow ------------------------------------------------

def _instant_backend(task, out_dir):
    path = os.path.join(out_dir, f"{task.task_id}.bin")
    with open(path, "wb") as f:
        f.write(task.prompt.encode())
    return {"file_path": path, "peak_memory_mb": 0.0}


def _raw_get(base, path):
    """GET without urllib's path normalisation."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _ui_script(pkg, out_dir):
    srv = pkg["server"].VideoServer(_instant_backend, out_dir=out_dir)
    pkg["app"].attach_ui(srv)
    base, stop = serve_in_thread(srv.app)
    log = []
    try:
        log.append(call(base, "GET", "/"))
        log.append(call(base, "GET", "/ui"))
        body = json.dumps({"idea": "a corgi drumming", "size": "32x32", "num_frames": 3,
                           "num_inference_steps": 2, "seed": 5}).encode()
        code, sub = call(base, "POST", "/workflow/full", body,
                         {"Content-Type": "application/json"})
        tid = sub["task_id"]
        log.append((code, dict(sub, task_id="<id>")))
        deadline = time.time() + 30
        while time.time() < deadline:
            code, st = call(base, "GET", f"/v1/videos/{tid}")
            if st["status"] in ("completed", "failed"):
                break
            time.sleep(0.02)
        st = {k: v for k, v in st.items() if k not in ("created_at", "completed_at",
                                                       "inference_time_s")}
        log.append((code, json.loads(json.dumps(st).replace(tid, "<id>")
                                     .replace(out_dir, "<out>"))))
        code, art = call(base, "GET", f"/workflow/tasks/{tid}")
        log.append((code, json.loads(json.dumps(art).replace(tid, "<id>"))))
        log.append(call(base, "GET", art["artifacts"]["first_frame.png"]))
        log.append(call(base, "GET", f"/workflow/tasks/{tid}/idea.txt"))
        log.append(call(base, "GET", f"/workflow/tasks/{tid}/absent.png"))
        log.append(call(base, "GET", "/workflow/tasks/unknown_id"))
        log.append(call(base, "GET", f"/v1/videos/{tid}/content"))
        for raw in ("/workflow/tasks/..", "/workflow/tasks/../tasks.json",
                    f"/workflow/tasks/{tid}/../../tasks.json"):
            log.append(_raw_get(base, raw)[0])
        code, _ = call(base, "POST", "/workflow/full", json.dumps({"size": "32"}).encode(),
                       {"Content-Type": "application/json"})
        log.append(code)
    finally:
        stop()
    return log


def test_ui_full_workflow_and_artifacts_match_jax(tmp_path, no_providers):
    port = _ui_script(PKGS["port"], str(tmp_path / "port"))
    assert port == _ui_script(PKGS["jax"], str(tmp_path / "jax"))
    (code, html), _, (_, sub), (_, st), (_, art), (_, frame) = port[:6]
    assert code == 200 and html == port_app.INDEX_HTML.encode()
    assert sub["rewritten_prompt"] == "a corgi drumming" and st["status"] == "completed"
    assert set(art["artifacts"]) == {"elements.txt", "first_frame.png", "idea.txt",
                                     "prompt.txt"}
    assert frame[:8] == b"\x89PNG\r\n\x1a\n"
    assert port[-4:-1] == [404, 404, 404] and port[-1] == 500


# --- the studio --------------------------------------------------------------------

BIG = bytes(range(256)) * (4 << 12)   # 4 MiB


def _upstream(name):
    async def health(request):
        return web.json_response({"status": "ok"})

    async def who(request):
        return web.json_response({"name": name, "query": request.query_string})

    async def big(request):
        return web.Response(body=BIG, content_type="application/octet-stream")

    async def gz(request):
        return web.Response(body=gzip.compress(json.dumps({"ok": True}).encode()),
                            content_type="application/json",
                            headers={"Content-Encoding": "gzip"})

    async def echo(request):
        return web.json_response({"got": (await request.read()).decode(),
                                  "method": request.method})

    app = web.Application()
    app.router.add_get("/health", health)
    app.router.add_get("/v1/who", who)
    app.router.add_get("/v1/big", big)
    app.router.add_get("/v1/gz", gz)
    app.router.add_route("*", "/workflow/echo", echo)
    return app


def _dead_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _studio_script(mod, servers):
    studio = mod.Studio(servers)
    base, stop = serve_in_thread(studio.app)
    js = {"Content-Type": "application/json"}
    log = []
    try:
        log.append(call(base, "GET", "/"))
        log.append(call(base, "GET", "/workflow/servers"))
        log.append(call(base, "GET", "/health"))
        log.append(call(base, "GET", "/v1/who?x=1"))
        log.append(call(base, "POST", "/workflow/echo", b"payload", js))
        with urllib.request.urlopen(base + "/v1/big", timeout=30) as r:
            log.append((r.status, r.read() == BIG))
        with urllib.request.urlopen(base + "/v1/gz", timeout=30) as r:
            log.append((r.status, r.headers.get("Content-Encoding"), json.loads(r.read())))
        log.append(call(base, "POST", "/workflow/select", b"not json", js))
        log.append(call(base, "POST", "/workflow/select", b'{"name": "nope"}', js))
        log.append(call(base, "POST", "/workflow/select", b'{"name": "b"}', js))
        log.append(call(base, "GET", "/v1/who"))
        log.append(call(base, "POST", "/workflow/select", b'{"name": "dead"}', js))
        log.append(call(base, "GET", "/v1/videos"))
        log.append(call(base, "GET", "/workflow/servers"))
    finally:
        stop()
    text = json.dumps([[x.decode("latin-1") if isinstance(x, bytes) else x for x in e]
                       for e in log])
    for name, url in servers.items():
        text = text.replace(url.split(":")[-1], f"<{name}>")
    return json.loads(text)


def test_studio_matches_jax():
    ups = [serve_in_thread(_upstream(n)) for n in ("a", "b")]
    servers = {"a": ups[0][0], "b": ups[1][0], "dead": _dead_url()}
    try:
        port = _studio_script(port_studio, servers)
        jax_ = _studio_script(jax_studio, servers)
    finally:
        for _, stop in ups:
            stop()
    assert port == jax_
    codes = [e[0] for e in port]
    assert codes == [200, 200, 200, 200, 200, 200, 200, 400, 404, 200, 200, 200, 502, 200]
    assert port[3][1] == {"name": "a", "query": "x=1"} and port[10][1]["name"] == "b"
    assert port[4][1] == {"got": "payload", "method": "POST"}
    assert port[5] == [200, True] and port[6] == [200, None, {"ok": True}]
    assert [s["healthy"] for s in port[-1][1]["servers"]] == [True, True, False]


# --- the workflow CLIs -------------------------------------------------------------

def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tools_script(main, root, capsys):
    root.mkdir()
    img, el, el_txt = root / "ff.png", root / "elements.json", root / "elements.txt"
    _FakeAPIs.requests_log = []
    runs = [["prompt", "--user-input", "a corgi"],
            ["prompt", "--user-input", "a corgi", "--output", str(root / "p.txt")],
            ["generate", "--image-prompt", "a dog", "--output", str(root / "g.png"),
             "--width", "64", "--height", "48"],
            ["full", "--user-input", "a corgi", "--output", str(img),
             "--output-image-prompt", str(root / "image_prompt.txt")],
            ["extract", "--image", str(img), "--output", str(el)],
            ["extract", "--image", str(img), "--output", str(el_txt)],
            ["rewrite", "--user-input", "a corgi", "--elements", str(el)],
            ["rewrite", "--user-input", "a corgi", "--elements", str(el_txt),
             "--output", str(root / "desc.txt")]]
    out = []
    for argv in runs:
        main(argv)
        cap = capsys.readouterr()
        out.append((cap.out.replace(str(root), "<root>"), cap.err.replace(str(root), "<root>")))
    files = {}
    for p in sorted(root.iterdir()):
        data = p.read_bytes()
        files[p.name] = data.replace(str(root).encode(), b"<root>")
    sent = [(r["path"], r["body"]) for r in _FakeAPIs.requests_log]
    return out, files, sent


@pytest.mark.parametrize("providers", ["dashscope", "offline"])
def test_workflow_tools_match_the_jax_script(providers, fake_api, tmp_path, capsys,
                                             monkeypatch, no_providers):
    if providers == "dashscope":
        monkeypatch.setenv("DASHSCOPE_API_KEY", "dk")
        monkeypatch.setenv("DASHSCOPE_BASE_URL", fake_api + "/api/v1")
    jax_tools = _load_script("workflow_tools")
    port = _tools_script(tools_cli.main, tmp_path / "port", capsys)
    assert port == _tools_script(jax_tools.main, tmp_path / "jax", capsys)
    if providers == "dashscope":
        assert port[1]["ff.png"] == PNG_BYTES and port[2]
    else:
        assert not port[2] and port[1]["desc.txt"] == b"a corgi"


class _Grabbed(Exception):
    pass


def test_workflow_studio_flags_match_the_jax_script(monkeypatch):
    mod = _load_script("workflow_studio")
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise _Grabbed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Grabbed):
        mod.main()
    monkeypatch.undo()

    def flags(parser):
        return {s: (a.dest, a.default, a.choices, a.required, type(a))
                for a in parser._actions for s in a.option_strings}

    assert flags(studio_cli.build_parser()) == flags(grabbed["parser"])
