"""Scrape surface of the ceremony service: /metrics, /healthz, /slo, a
copy of ``dkg_tpu/service/httpobs.py``.

One stdlib ``http.server`` thread exposing what the process already
knows:

* ``/metrics``: ``registry.prometheus_text()``;
* ``/healthz``: the scheduler's liveness dict as JSON, 200 when ``ok``
  else 503;
* ``/slo``: the rolling :mod:`.slo` report as JSON, 200 when the window
  is inside its objectives else 503.

Off by default: the server starts only when a port is configured
(``DKG_TPU_SERVICE_HTTP_PORT``, 0 for an ephemeral port, or the
scheduler's ``http_port``), and binds localhost only.  Every byte served
comes from the metrics registry or the scheduler's health and SLO dicts,
never from ceremony payloads.  The optional ``router`` callback (the JAX
package's fleet front door) is kept for parity; no ported module installs
one.
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse

from ..utils import envknobs
from ..utils.metrics import REGISTRY

#: Seconds close() waits for the serve thread to drain.
_JOIN_TIMEOUT_S = 5.0


class ObsHttpServer:
    """Owns the listening socket and the one daemon serve thread.

    ``health_fn`` / ``slo_fn`` are zero-arg callables returning
    JSON-able dicts (the scheduler passes its bound methods); either may
    be None, which 404s that route.  A callback that raises is recorded
    (``service_http_errors_total``) and answered 500 — a broken probe
    must read as unhealthy, not kill the serve thread.

    ``router`` (the fleet front door) is consulted for any GET the
    scrape routes don't claim and for every POST:
    ``router(method, path, query, body) -> (status, payload) | None``,
    with ``query`` a flat str->str dict and ``body`` the parsed JSON
    object of a POST (None for GETs / empty bodies).  ``None`` falls
    through to 404; exceptions follow the 500-and-count contract above.
    """

    def __init__(
        self,
        *,
        registry=None,
        health_fn=None,
        slo_fn=None,
        router=None,
        log=None,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.health_fn = health_fn
        self.slo_fn = slo_fn
        self.router = router
        self.log = log
        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # the stdlib default logs every request to stderr: telemetry
            # goes through obslog and metrics, not raw streams
            def log_message(self, fmt, *args):  # noqa: A003
                del fmt, args

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: dict) -> None:
                self._send(
                    code,
                    json.dumps(payload, sort_keys=True).encode(),
                    "application/json",
                )

            def _query(self) -> dict:
                raw = self.path.split("?", 1)
                if len(raw) < 2:
                    return {}
                return {
                    k: v[-1]
                    for k, v in urllib.parse.parse_qs(raw[1]).items()
                }

            def _route(self, method: str, path: str, body) -> None:
                if server.router is None:
                    self._send_json(404, {"error": "not found", "path": path})
                    return
                routed = server.router(method, path, self._query(), body)
                if routed is None:
                    self._send_json(404, {"error": "not found", "path": path})
                    return
                self._send_json(routed[0], routed[1])

            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            server.registry.prometheus_text().encode(),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/healthz" and server.health_fn is not None:
                        health = server.health_fn()
                        self._send_json(
                            200 if health.get("ok") else 503, health
                        )
                    elif path == "/slo" and server.slo_fn is not None:
                        report = server.slo_fn()
                        self._send_json(200 if report.get("ok") else 503, report)
                    else:
                        self._route("GET", path, None)
                except Exception as exc:
                    server._note(path, exc)
                    try:
                        self._send_json(500, {"error": type(exc).__name__})
                    except Exception as exc2:
                        # client already gone mid-response; count it too
                        server._note(path, exc2)

            def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                path = self.path.split("?", 1)[0]
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b""
                    body = json.loads(raw) if raw else None
                    if body is not None and not isinstance(body, dict):
                        self._send_json(400, {"error": "body must be a JSON object"})
                        return
                    self._route("POST", path, body)
                except json.JSONDecodeError:
                    self._send_json(400, {"error": "invalid JSON body"})
                except Exception as exc:
                    server._note(path, exc)
                    try:
                        self._send_json(500, {"error": type(exc).__name__})
                    except Exception as exc2:
                        server._note(path, exc2)

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="dkg-svc-http",
            daemon=True,
        )
        self._thread.start()

    def _note(self, path: str, exc: BaseException) -> None:
        self.registry.inc("service_http_errors_total", path=path)
        if self.log is not None:
            self.log.emit(
                "http_error", path=path, kind=type(exc).__name__, error=str(exc)
            )

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when constructed with 0)."""
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=_JOIN_TIMEOUT_S)


def maybe_start(
    *,
    registry=None,
    health_fn=None,
    slo_fn=None,
    log=None,
    port: int | None = None,
) -> ObsHttpServer | None:
    """Start a server iff a port is configured: the explicit ``port``
    argument wins, else ``DKG_TPU_SERVICE_HTTP_PORT``; both unset means
    the surface stays off and this returns None."""
    if port is None:
        port = envknobs.nonneg_int(
            "DKG_TPU_SERVICE_HTTP_PORT",
            "observability HTTP port (0 = ephemeral; unset = off)",
        )
    if port is None:
        return None
    return ObsHttpServer(
        registry=registry,
        health_fn=health_fn,
        slo_fn=slo_fn,
        log=log,
        port=port,
    )
