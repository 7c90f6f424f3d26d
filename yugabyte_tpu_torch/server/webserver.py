"""Embedded status/metrics webserver.

Counterpart of yugabyte_tpu/server/webserver.py, with the imports
renamed.

Capability parity with the reference (ref: src/yb/server/webserver.cc +
per-server path handlers master-path-handlers.cc / tserver-path-handlers.cc;
metric endpoints util/metrics.h:449-518 — JSON `/metrics` and Prometheus
`/prometheus-metrics`). Handlers are plain callables returning
(content_type, body); every server registers its own status pages.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Tuple

from yugabyte_tpu_torch.utils.metrics import (ROOT_REGISTRY, MetricRegistry,
                                        registries_to_json_obj,
                                        registries_to_prometheus)
from yugabyte_tpu_torch.utils import ybsan

Handler = Callable[[], Tuple[str, str]]


class _NoHandler(KeyError):
    """No route registered for the path — the ONLY condition that may 404.
    A handler that itself raises KeyError is a handler bug and must
    surface as a 500, not be misreported as a missing route."""


@ybsan.shadow(_handlers=ybsan.SINGLE_WRITER)
class Webserver:
    def __init__(self, metrics: MetricRegistry,
                 bind_host: str = "127.0.0.1", port: int = 0):
        self._metrics = metrics
        self._handlers: Dict[str, Handler] = {}
        outer = self

        class _Req(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                pass

            def do_GET(self):  # noqa: N802 — stdlib name
                path = self.path.split("?", 1)[0]
                try:
                    ctype, body = outer._dispatch(path)
                    code = 200
                except _NoHandler:
                    ctype, body = "text/plain", f"no handler for {path}\n"
                    code = 404
                except Exception as e:  # noqa: BLE001 — surface as 500
                    ctype, body = "text/plain", f"error: {e}\n"
                    code = 500
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((bind_host, port), _Req)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="webserver")
        self._thread.start()
        self.register("/healthz", lambda: ("text/plain", "ok\n"))
        self.register("/metrics", self._json_metrics)
        self.register("/prometheus-metrics", self._prom_metrics)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, path: str, handler: Handler) -> None:
        self._handlers[path] = handler

    def register_json(self, path: str, provider: Callable[[], object]) -> None:
        self._handlers[path] = lambda: (
            "application/json", json.dumps(provider(), indent=2,
                                           default=str) + "\n")

    def _dispatch(self, path: str) -> Tuple[str, str]:
        try:
            handler = self._handlers[path]
        except KeyError:
            raise _NoHandler(path) from None
        return handler()

    # Metric endpoints merge the server's own registry with the process
    # ROOT_REGISTRY: kernel-dispatch histograms, cache hit counters and
    # other process-wide instrumentation register there (ops/ code has no
    # server registry in scope) and must still be scrapeable per server.
    def _json_metrics(self) -> Tuple[str, str]:
        return "application/json", json.dumps(
            registries_to_json_obj([self._metrics, ROOT_REGISTRY]), indent=1)

    def _prom_metrics(self) -> Tuple[str, str]:
        return ("text/plain; version=0.0.4",
                registries_to_prometheus([self._metrics, ROOT_REGISTRY]))

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
