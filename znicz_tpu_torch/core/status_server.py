"""Shared stdlib HTTP plumbing: handler helpers and a daemon-thread
server lifecycle.

Counterpart of the ``HttpServerBase`` / ``HandlerBase`` /
``BodyTooLargeError`` part of ``znicz_tpu/core/status_server.py`` —
the part the serving front end (:mod:`znicz_tpu_torch.serving.server`)
is built on.
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
