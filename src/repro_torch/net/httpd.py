"""repro_torch.net.httpd — minimal HTTP exposition listener for the net tier,
ported from the reference's ``net/httpd.py`` (standard library only).

A scrape endpoint is a *wire*, so it lives here: ``repro_torch/net`` is the
only package of the port that opens listening sockets.
The observability layer (:mod:`repro_torch.obs.metrics`) supplies only the
*rendering* — it hands this module a ``handler(path) -> (status,
content_type, body)`` callable and never touches a socket itself.

    ep = HttpEndpoint(handler, port=0)   # port=0 → ephemeral
    ep.start()
    ... scrape http://127.0.0.1:{ep.port}/metrics ...
    ep.close()

The server is a ``ThreadingHTTPServer`` with daemon worker threads: a
scrape must never block runtime shutdown, and a stuck scraper must never
wedge the fleet.  ``http_get`` is the matching client-side helper so
tests and scrapers don't need their own transport.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.error import HTTPError
from urllib.request import urlopen

# (status, content-type, body) — what a handler returns for one GET
Response = Tuple[int, str, bytes]


class HttpEndpoint:
    """A tiny GET-only HTTP server bound to one handler callable.

    The handler receives the request path (query string stripped) and
    returns a :data:`Response`.  A raising handler maps to a 500 with the
    repr in the body — an exposition endpoint should degrade loudly, not
    take the process down.
    """

    def __init__(self, handler: Callable[[str], Response],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        endpoint = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    status, ctype, body = endpoint._handler(path)
                except Exception as e:  # pragma: no cover - defensive
                    status, ctype = 500, "text/plain; charset=utf-8"
                    body = f"scrape handler failed: {e!r}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # silence per-request spam
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._server.server_address[0]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "HttpEndpoint":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="repro-httpd",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self._server.server_close()

    def __enter__(self) -> "HttpEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def http_get(url: str, timeout: float = 10.0) -> Tuple[int, str]:
    """GET ``url`` → ``(status, body_text)``.  Client twin of
    :class:`HttpEndpoint`, kept here so nothing outside ``repro_torch/net``
    grows its own transport."""
    try:
        with urlopen(url, timeout=timeout) as resp:  # noqa: S310 (http only)
            return resp.status, resp.read().decode("utf-8", "replace")
    except HTTPError as e:  # non-2xx is still an answer, not a transport error
        return e.code, e.read().decode("utf-8", "replace")
