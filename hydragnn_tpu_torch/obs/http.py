"""Stdlib ``/healthz`` + ``/metrics`` listener (port of the JAX package's
``obs/http.py``).

The listener needs two things of its provider: ``health() -> dict`` (its
``status`` key decides 200 or 503) and ``metrics.render_prometheus() ->
str``. ``GET /healthz`` answers the JSON health, ``GET /metrics`` the
Prometheus text. ``GET /profile?steps=N`` arms a trace of the next N
dispatches of a live training run where the provider has ``profile(steps)
-> dict`` (``obs/runtime.RunTelemetry``: 200 on armed or busy, 400 on an
error); a provider without it (a server alone, which has no run) answers
501.

``http.server`` only; the listener runs on a daemon thread, and ``port=0``
binds an ephemeral port, readable from :attr:`ObservabilityServer.address`
after ``start()``.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit


class _Listener(ThreadingHTTPServer):
    """SO_REUSEADDR on (listeners restart back to back in tests and a
    closed socket in TIME_WAIT must not fail the rebind); daemonic handler
    threads, so that a hung scrape cannot block the interpreter's exit."""

    allow_reuse_address = True
    daemon_threads = True


class ObservabilityServer:
    """Serves ``/healthz``, ``/metrics`` and ``/profile`` for one provider
    (an :class:`~hydragnn_tpu_torch.serve.server.InferenceServer`, a
    training run's :class:`~hydragnn_tpu_torch.obs.runtime.RunTelemetry`).

    ``start()`` on a started listener and ``stop()`` on a stopped one are
    no-ops. Two locks, always lifecycle -> state: ``_lifecycle_lock``
    serialises whole start/stop transitions (a restart on a fixed port
    binds only after the previous socket closed), ``_state_lock`` guards
    the handle pair so that :attr:`address` never waits on a slow
    shutdown."""

    def __init__(self, provider, port: int = 8080, host: str = "127.0.0.1"):
        self._provider = provider
        self._host = host
        self._port = port
        self._lifecycle_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        provider = self._provider

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path == "/healthz":
                    health = provider.health()
                    body = json.dumps(health).encode()
                    code = 200 if health.get("status") == "ok" else 503
                    ctype = "application/json"
                elif self.path == "/metrics":
                    body = provider.metrics.render_prometheus().encode()
                    code = 200
                    ctype = "text/plain; version=0.0.4"
                elif self.path.split("?", 1)[0] == "/profile":
                    profile = getattr(provider, "profile", None)
                    if profile is None:
                        body = b"this provider does not support on-demand profiling\n"
                        code = 501
                        ctype = "text/plain"
                    else:
                        qs = parse_qs(urlsplit(self.path).query)
                        try:
                            steps = int(qs.get("steps", ["3"])[0])
                        except ValueError:
                            steps = -1  # profile() answers with an error
                        result = profile(steps)
                        body = json.dumps(result).encode()
                        code = 200 if result.get("status") in ("armed", "busy") else 400
                        ctype = "application/json"
                else:
                    body = (b"not found: this endpoint exposes /healthz, /metrics "
                            b"and /profile\n")
                    code = 404
                    ctype = "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes stay off stderr
                pass

        with self._lifecycle_lock:
            with self._state_lock:
                if self._httpd is not None:
                    return self
            httpd = _Listener((self._host, self._port), Handler)
            # daemon=True is the crashed-caller backstop; stop() is the
            # orderly path
            thread = threading.Thread(target=httpd.serve_forever,
                                      name="hydragnn-torch-observability", daemon=True)
            thread.start()
            with self._state_lock:
                self._httpd, self._thread = httpd, thread
        return self

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """(host, port) actually bound: port 0 resolves here."""
        with self._state_lock:
            if self._httpd is None:
                return None
            return self._httpd.server_address[:2]

    def stop(self, timeout: float = 5.0):
        # the teardown holds the lifecycle lock, so that a start() on the
        # same fixed port waits until the socket is released
        with self._lifecycle_lock:
            with self._state_lock:
                httpd, thread = self._httpd, self._thread
                self._httpd = None
                self._thread = None
            if httpd is None:
                return
            httpd.shutdown()
            httpd.server_close()
            if thread is not None:
                thread.join(timeout)
