"""Shared stdlib HTTP plumbing: handler helpers and a daemon-thread
server lifecycle.

Counterpart of the ``HttpServerBase`` / ``HandlerBase`` /
``BodyTooLargeError`` part of ``znicz_tpu/core/status_server.py`` —
the part the serving front end (:mod:`znicz_tpu_torch.serving.server`)
is built on — the ``GET /debug/faults`` and ``GET /debug/health``
views (JAX :213, :252) that every server built on
:class:`HandlerBase` answers (:meth:`HandlerBase._send_debug`), and
:class:`StatusServer` (JAX :405), a training run's status over HTTP:
``/status.json``, ``/metrics`` and the debug views.  The JAX server's
HTML page and plots wait for the plotters (``ROADMAP.md``).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core import telemetry


class BodyTooLargeError(ValueError):
    """Request body over ``root.common.serving.max_body_bytes`` —
    refused BEFORE reading (HTTP 413)."""


class HandlerBase(BaseHTTPRequestHandler):
    """Shared request-handler plumbing; ``owner`` is the
    :class:`HttpServerBase` that built the handler class."""

    owner = None
    protocol_version = "HTTP/1.1"  # keep-alive for request streams
    #: TCP_NODELAY: a reply's body leaves at once after its headers
    #: instead of waiting on the client's delayed ACK of them
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if self.owner is not None:
            self.owner.debug(fmt, *args)

    def _send(self, code, ctype, body, headers=None):
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
        except BrokenPipeError:  # client went away mid-reply
            pass

    def _send_json(self, code, obj, headers=None):
        self._send(code, "application/json",
                   json.dumps(obj, default=str).encode(), headers=headers)

    def _read_body(self):
        if self.headers.get("Transfer-Encoding"):
            # an unread chunked body would desync the keep-alive socket
            self.close_connection = True
            raise ValueError("Transfer-Encoding is not supported — send "
                             "a Content-Length body")
        length = int(self.headers.get("Content-Length") or 0)
        cap = int(root.common.serving.get("max_body_bytes", 16 << 20) or 0)
        if cap and length > cap:
            # refuse before reading; the unread bytes poison the socket
            self.close_connection = True
            raise BodyTooLargeError(
                "request body of %d bytes exceeds the %d-byte limit"
                % (length, cap))
        return self.rfile.read(length) if length > 0 else b""

    def _drain_body(self):
        """Consume the request body before an early reply."""
        try:
            self._read_body()
        except ValueError:
            pass  # close_connection is already set

    def _send_debug(self, path):
        """Answer ``GET /debug/faults`` (the fault registry's status)
        and ``GET /debug/health`` (the health monitor's: 503 once a
        violation was seen); False for any other path."""
        if path == "/debug/faults":
            from znicz_tpu_torch.core import faults
            self._send_json(200, faults.status())
            return True
        if path == "/debug/health":
            from znicz_tpu_torch.core import health
            st = health.status()
            self._send_json(200 if st.get("ok", True) else 503, st)
            return True
        return False

    def _send_metrics(self):
        self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                   telemetry.prometheus_text().encode())


class _DeepBacklogHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for connection bursts
    (socketserver's default of 5 stalls bursts in SYN retransmit)."""

    request_queue_size = 128
    daemon_threads = True


class HttpServerBase(Logger):
    """Daemon-thread stdlib HTTP server lifecycle.  Subclasses implement
    :meth:`make_handler`; ``stop()`` is idempotent."""

    def __init__(self, port=0, host="127.0.0.1", logger_name=None):
        super().__init__(
            logger_name=logger_name or type(self).__name__)
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None
        self._lifecycle_lock = threading.Lock()

    def make_handler(self):
        raise NotImplementedError

    def start(self):
        with self._lifecycle_lock:
            if self._httpd is not None:
                return self
            self._httpd = _DeepBacklogHTTPServer(
                (self.host, self.port), self.make_handler())
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="znicz:" + type(self).__name__.lower(), daemon=True)
            self._thread.start()
        self.info("%s on http://%s:%d/", type(self).__name__, self.host,
                  self.port)
        return self

    def stop(self):
        with self._lifecycle_lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)


class StatusServer(HttpServerBase):
    """Serves one workflow's live status over HTTP."""

    def __init__(self, workflow=None, port=0, host="127.0.0.1"):
        super(StatusServer, self).__init__(port=port, host=host,
                                           logger_name="StatusServer")
        self.workflow = workflow

    def status(self):
        """The workflow's class, units and their run counts, the
        decision's epoch and errors, and the telemetry snapshot when
        telemetry is on; safe before ``initialize``."""
        wf = self.workflow
        payload = {"workflow": None}
        if wf is not None:
            payload["workflow"] = type(wf).__name__
            units = list(getattr(wf, "units", ()))
            payload["units"] = [u.name for u in units]
            payload["run_counts"] = {u.name: int(getattr(u, "run_count_", 0))
                                     for u in units}
            decision = getattr(wf, "decision", None)
            for attr in ("epoch_number", "complete", "best_n_err_pt",
                         "epoch_n_err_pt"):
                v = getattr(decision, attr, None)
                if v is not None:
                    payload[attr] = bool(v) if attr == "complete" else v
        if telemetry.enabled():
            payload["telemetry"] = telemetry.snapshot()
        return payload

    def make_handler(self):
        server = self

        class Handler(HandlerBase):
            owner = server

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/status.json":
                    self._send_json(200, server.status())
                elif path == "/metrics":
                    self._send_metrics()
                elif not self._send_debug(path):
                    self._send_json(404, {"error": "not found"})

        return Handler
