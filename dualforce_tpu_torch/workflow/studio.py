"""Multi-server studio: one UI over a registry of DualForce serving
endpoints (the port's copy of `dualforce_tpu/workflow/studio.py`;
behavioural reference: workflow/config.py:16-29 SGLANG_SERVERS —
the reference Streamlit app fronts several model servers, e.g. mova-360p and
mova-720p, with a selectbox choosing the active one).

The studio serves the same single-page UI as `workflow.app` and transparently
proxies `/v1/*` and `/workflow/*` to the ACTIVE upstream server (every
DualForce server mounts both surfaces — scripts/serve.py attaches the UI),
plus a tiny registry API:

    GET  /workflow/servers  -> {"servers": [{name, url, active, healthy}]}
    POST /workflow/select   -> {"name": ...} switch the active server

Registry sources: the --servers CLI flag or DUALFORCE_SERVERS env, both as
"name=url,name=url" pairs.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from aiohttp import ClientSession, ClientTimeout, web

from dualforce_tpu_torch.workflow.app import INDEX_HTML

# hop-by-hop headers must not be forwarded by a proxy (RFC 9110 §7.6.1)
_HOP_BY_HOP = {"connection", "keep-alive", "proxy-authenticate",
               "proxy-authorization", "te", "trailers", "transfer-encoding",
               "upgrade", "host", "content-length"}


def parse_servers(spec: str) -> Dict[str, str]:
    """"name=url,name=url" -> ordered {name: url}."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"server spec {part!r} is not name=url")
        name, url = part.split("=", 1)
        out[name.strip()] = url.strip().rstrip("/")
    if not out:
        raise ValueError("no servers configured (use --servers or "
                         "DUALFORCE_SERVERS=\"name=url,...\")")
    return out


class Studio:
    def __init__(self, servers: Dict[str, str],
                 active: Optional[str] = None):
        self.servers = dict(servers)
        self.active = active or next(iter(self.servers))
        if self.active not in self.servers:
            raise ValueError(f"unknown active server {self.active!r}")
        self.app = web.Application()
        self.app.router.add_get("/", self._index)
        self.app.router.add_get("/workflow/servers", self._list_servers)
        self.app.router.add_post("/workflow/select", self._select)
        # everything else the UI calls goes to the active upstream
        self.app.router.add_route("*", "/health", self._proxy)
        self.app.router.add_route("*", "/v1/{tail:.*}", self._proxy)
        self.app.router.add_route("*", "/workflow/{tail:.*}", self._proxy)
        self.app.on_cleanup.append(self._close_session)
        self._session: Optional[ClientSession] = None

    # --- infrastructure -----------------------------------------------------
    def _client(self) -> ClientSession:
        if self._session is None or self._session.closed:
            self._session = ClientSession(
                timeout=ClientTimeout(total=600, connect=10))
        return self._session

    async def _close_session(self, app):
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # --- registry -----------------------------------------------------------
    async def _index(self, request):
        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def _health(self, name: str) -> bool:
        try:
            async with self._client().get(
                    self.servers[name] + "/health",
                    timeout=ClientTimeout(total=3)) as r:
                return r.status == 200
        except Exception:  # noqa: BLE001 — any failure means unhealthy
            return False

    async def _list_servers(self, request):
        health = await asyncio.gather(*(self._health(n) for n in self.servers))
        return web.json_response({"servers": [
            {"name": n, "url": u, "active": n == self.active, "healthy": h}
            for (n, u), h in zip(self.servers.items(), health)]})

    async def _select(self, request):
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — empty/non-JSON body
            return web.json_response({"error": "body must be JSON "
                                      "{\"name\": ...}"}, status=400)
        name = body.get("name")
        if name not in self.servers:
            return web.json_response({"error": f"unknown server {name!r}"},
                                     status=404)
        self.active = name
        return web.json_response({"active": name})

    # --- transparent proxy to the active upstream ----------------------------
    async def _proxy(self, request: web.Request):
        url = self.servers[self.active] + request.rel_url.path_qs
        headers = {k: v for k, v in request.headers.items()
                   if k.lower() not in _HOP_BY_HOP}
        body = await request.read() if request.can_read_body else None
        resp = None
        try:
            async with self._client().request(
                    request.method, url, headers=headers, data=body) as r:
                # content-encoding also dropped: the client session auto-
                # decompresses, so forwarding it would make the browser
                # re-decode already-plain bytes
                skip = _HOP_BY_HOP | {"content-encoding"}
                out_headers = {k: v for k, v in r.headers.items()
                               if k.lower() not in skip}
                # stream through (video downloads are hundreds of MB;
                # never buffer the full upstream body)
                resp = web.StreamResponse(status=r.status,
                                          headers=out_headers)
                await resp.prepare(request)
                async for chunk in r.content.iter_chunked(1 << 16):
                    await resp.write(chunk)
                await resp.write_eof()
                return resp
        except Exception as e:  # noqa: BLE001 — upstream down -> 502
            if resp is not None and resp.prepared:
                raise  # headers already sent; can only abort the stream
            return web.json_response(
                {"error": f"upstream {self.active!r} unreachable: {e}"},
                status=502)

    def run(self, host: str = "0.0.0.0", port: int = 8800):
        print(f"[studio] {len(self.servers)} server(s), active="
              f"{self.active!r}; UI at http://{host}:{port}/")
        web.run_app(self.app, host=host, port=port)
