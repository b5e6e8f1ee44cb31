"""The agent's node-local integration listener.

Own copy of ``deepflow_tpu/agent/integration_proxy.py``: an HTTP
listener on the node (port 38086 by default) so a workload's sidecars
post OTLP traces and logs, app logs, folded profiles, Prometheus
remote-write, Telegraf, Datadog and SkyWalking to ``localhost`` and the
agent forwards each POST (or Datadog's PUT) of a path in
``_FORWARD_PATHS`` to the server's querier (``server_http``, host:port),
with its body, content type and content encoding, and answers with the
server's status and body (the reference's proxy drops the encoding, so a
gzip'd Telegraf post through it parses as bad lines). Another path answers 404 (counted ``rejected``); a server that
cannot be reached answers 502 (counted in ``errors``). ``stats`` ride in
the agent's ``agent.integration_proxy`` rows.
"""

from __future__ import annotations

import logging
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger("df.integration-proxy")

_FORWARD_PATHS = ("/api/v1/otlp/traces", "/api/v1/profile/ingest",
                  "/api/v1/log", "/api/v1/otlp/logs",
                  "/api/v1/write", "/api/v1/telegraf",
                  "/v0.3/traces", "/v0.4/traces", "/v3/segments")


class IntegrationProxy:
    def __init__(self, server_http: str, host: str = "0.0.0.0",
                 port: int = 38086) -> None:
        self.server_http = server_http  # host:port of the querier's HTTP
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self.stats = {"forwarded": 0, "errors": 0, "rejected": 0}

    def start(self) -> "IntegrationProxy":
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path not in _FORWARD_PATHS:
                    proxy.stats["rejected"] += 1
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                url = f"http://{proxy.server_http}{self.path}"
                headers = {"Content-Type": self.headers.get(
                    "Content-Type", "application/octet-stream")}
                if self.headers.get("Content-Encoding"):
                    # a gzip'd body (Telegraf's default) stays one
                    headers["Content-Encoding"] = \
                        self.headers["Content-Encoding"]
                req = urllib.request.Request(url, data=body,
                                             headers=headers)
                try:
                    with urllib.request.urlopen(req, timeout=10) as resp:
                        out = resp.read()
                        code = resp.status
                except urllib.error.HTTPError as e:
                    out = e.read()
                    code = e.code
                except urllib.error.URLError as e:
                    proxy.stats["errors"] += 1
                    self.send_response(502)
                    self.end_headers()
                    self.wfile.write(str(e.reason).encode())
                    return
                proxy.stats["forwarded"] += 1
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            do_PUT = do_POST  # dd-trace clients PUT their traces

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="df-integration-proxy", daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
