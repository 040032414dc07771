"""Shared stdlib HTTP plumbing: handler helpers and a daemon-thread
server lifecycle.

Counterpart of the ``HttpServerBase`` / ``HandlerBase`` /
``BodyTooLargeError`` part of ``znicz_tpu/core/status_server.py`` —
the part the serving front end (:mod:`znicz_tpu_torch.serving.server`)
is built on — the debug views that every server built on
:class:`HandlerBase` answers (:meth:`HandlerBase._send_debug`, JAX
:183-300), and :class:`StatusServer` (JAX :405), a training run's
status over HTTP: ``/status.json``, ``/metrics`` and the debug views:

* ``GET /debug/faults`` and ``GET /debug/health``: the fault registry's
  and the health monitor's status (503 once a violation was seen);
* ``GET /debug/profile?seconds=N``: a device trace of the next N
  seconds (``profiler.capture_trace``; the reply names the trace);
* ``GET /debug/profiler``: the profiler's report (``profiler.snapshot``);
* ``GET /debug/timeseries``: the metric rings (``timeseries.snapshot``);
* ``GET /debug/pyprof?seconds=N[&format=collapsed|speedscope]``: the
  Python sampler's profile of the next N seconds (``{"enabled":
  false}`` when its knob is off);
* ``GET /debug/trace`` and ``GET /debug/trace/<rid>``: the sampled
  request ids and one request's span tree
  (:mod:`znicz_tpu_torch.serving.reqtrace`; 404 for an unsampled rid);
* ``GET /debug/blackbox``: the durable blackbox's writer stats.

The two capture endpoints share one concurrency guard: while either
runs, a request for either answers 409, and so does ``/debug/profile``
while another device trace (the ``profile`` CLI's) runs.  A server's
start starts the time-series sampler and the Python sampler and arms
the blackbox where their knobs are on (JAX :387-389).  A
:class:`StatusServer` also serves its HTML page at ``/`` (the status,
refreshed every 5 s, and the plotters' PNGs) and each PNG at
``/plots/<name>``, from ``<root.common.dirs.cache>/plots`` (JAX
:57-62, :455-508).
"""

import glob
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, unquote

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core import pyprof, telemetry

#: one guard for both capture endpoints (/debug/profile, /debug/pyprof):
#: a device trace and a frame-walk capture interleaved in one process
#: would each distort what the other measures
_capture_guard = locksmith.lock("status_server.debug_capture")
_BUSY = {"error": "another debug capture (profile or pyprof) is "
                  "already running"}


_PAGE = """<html><head><title>znicz_tpu_torch status</title>
<meta http-equiv="refresh" content="5"></head>
<body><h1>znicz_tpu_torch — %(name)s</h1>
<pre id="status">%(status)s</pre>
%(plots)s
</body></html>"""


def _json_reply(code, obj):
    """``(code, content type, body)`` of a JSON reply, built before
    anything is written (a capture's reply leaves after its guard is
    released)."""
    return code, "application/json", json.dumps(obj, default=str).encode()


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
        self._send(*_json_reply(code, obj), headers=headers)

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
        """Answer the ``GET /debug/*`` views (the module's docstring);
        False for any other path.  ``path`` may carry the query."""
        path, _, query = path.partition("?")
        if path == "/debug/faults":
            from znicz_tpu_torch.core import faults
            self._send_json(200, faults.status())
            return True
        if path == "/debug/health":
            from znicz_tpu_torch.core import health
            st = health.status()
            self._send_json(200 if st.get("ok", True) else 503, st)
            return True
        if path == "/debug/timeseries":
            from znicz_tpu_torch.core import timeseries
            self._send_json(200, timeseries.snapshot())
            return True
        if path == "/debug/trace" or path.startswith("/debug/trace/"):
            from znicz_tpu_torch.serving import reqtrace
            rid = path[len("/debug/trace/"):]
            if not rid:
                self._send_json(200, {"enabled": reqtrace.enabled(),
                                      "rids": reqtrace.rids()})
                return True
            tree = reqtrace.get(rid)
            if tree is None:
                self._send_json(404, {
                    "error": "no sampled trace for rid %r (sampling %s; "
                             "see root.common.serving.trace_sample_n)"
                             % (rid, "on" if reqtrace.enabled() else "off")})
                return True
            self._send_json(200, tree)
            return True
        if path == "/debug/blackbox":
            from znicz_tpu_torch.core import blackbox
            self._send_json(200, blackbox.stats())
            return True
        if path == "/debug/profiler":
            from znicz_tpu_torch.core import profiler
            self._send_json(200, profiler.snapshot())
            return True
        if path == "/debug/profile":
            self._send_capture(query, "3", self._profile_capture)
            return True
        if path == "/debug/pyprof":
            if not pyprof.enabled():
                # the honest disabled answer: no capture, no guard
                self._send_json(200, {"enabled": False})
                return True
            self._send_capture(query, "2", self._pyprof_capture)
            return True
        return False

    def _send_capture(self, query, default_seconds, capture):
        """One capture endpoint: parse ``seconds`` (400 when it is not a
        number), take the shared guard (409 while a capture runs), run
        ``capture(seconds, qs)`` in this handler thread (the server is
        threaded; other requests keep flowing) and answer the ``(code,
        content type, body)`` it returns, or 500 with the error.  The
        guard is released BEFORE the reply is written: a client that
        sends its next capture the moment it has this reply must find
        the guard free, never a stale 409."""
        qs = parse_qs(query)
        try:
            seconds = float(qs.get("seconds", [default_seconds])[0])
        except ValueError:
            self._send_json(400, {"error": "seconds must be a number"})
            return
        if not _capture_guard.acquire(blocking=False):
            self._send_json(409, _BUSY)
            return
        try:
            reply = capture(seconds, qs)
        except RuntimeError as e:   # another device trace is running
            reply = _json_reply(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - always answer HTTP
            reply = _json_reply(500, {"error": repr(e)})
        finally:
            _capture_guard.release()
        self._send(*reply)

    @staticmethod
    def _profile_capture(seconds, qs):
        from znicz_tpu_torch.core import profiler
        return _json_reply(200, profiler.capture_trace(seconds))

    @staticmethod
    def _pyprof_capture(seconds, qs):
        prof = pyprof.capture(seconds)
        fmt = qs.get("format", ["json"])[0]
        if fmt == "collapsed":
            return (200, "text/plain; charset=utf-8",
                    (pyprof.collapsed(prof) + "\n").encode())
        if fmt == "speedscope":
            return _json_reply(200, pyprof.speedscope(prof))
        return _json_reply(200, prof)

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
        self._lifecycle_lock = locksmith.lock("status_server.lifecycle")

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
                name=pyprof.thread_name(type(self).__name__.lower()),
                daemon=True)
            self._thread.start()
        # every HTTP surface serves /debug/timeseries and /debug/pyprof,
        # so a server's start arms the samplers and the blackbox (each
        # one config read when its knob is off)
        from znicz_tpu_torch.core import blackbox, timeseries
        timeseries.maybe_start()
        pyprof.maybe_start()
        blackbox.maybe_arm()
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
        payload["plots"] = [os.path.basename(p) for p in self._plot_files()]
        if telemetry.enabled():
            payload["telemetry"] = telemetry.snapshot()
        return payload

    @staticmethod
    def _plot_files():
        return sorted(glob.glob(os.path.join(
            root.common.dirs.cache, "plots", "*.png")))

    def _render_page(self):
        st = self.status()
        plots = "".join('<img src="/plots/%s" width="400"/>' % quote(p)
                        for p in st["plots"])
        return _PAGE % {
            "name": st.get("workflow") or "(no workflow)",
            "status": json.dumps(st, indent=2, default=str),
            "plots": plots}

    def make_handler(self):
        server = self

        class Handler(HandlerBase):
            owner = server

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path in ("/", "/index.html"):
                    self._send(200, "text/html",
                               server._render_page().encode())
                elif path == "/status.json":
                    self._send_json(200, server.status())
                elif path.startswith("/plots/"):
                    name = os.path.basename(unquote(path))
                    png = os.path.join(root.common.dirs.cache, "plots", name)
                    if name and os.path.isfile(png):
                        with open(png, "rb") as f:
                            self._send(200, "image/png", f.read())
                    else:
                        self._send_json(404, {"error": "not found"})
                elif path == "/metrics":
                    self._send_metrics()
                elif not self._send_debug(self.path):
                    self._send_json(404, {"error": "not found"})

        return Handler
