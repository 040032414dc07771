"""Fleet front end: N replica processes behind one routing surface.

Counterpart of ``znicz_tpu/serving/router.py`` (``_RawConn`` :158,
``Replica`` :235, ``_FleetTarget`` :490, ``FleetRouter`` :607-2002,
``_merge_prometheus`` :2032-2109):

* :class:`Replica` — one serving subprocess (``python -m
  znicz_tpu_torch serve ... --port 0``, ``--device`` and ``--config``
  passed through); its URL is parsed from its startup banner and a
  reader thread drains its output, keeping the last lines for a
  post-mortem.  The router's pid rides in its environment
  (:data:`ROUTER_PID_ENV`): a replica whose router is gone, even
  SIGKILLed, drains and exits, and frees the card.
* :class:`FleetRouter` — the HTTP front end:

  - ``POST /predict[/<model>]`` balances on **least outstanding
    requests** over the UP replicas (ties rotate) and relays over the
    binary wire (:mod:`znicz_tpu_torch.serving.wire`; the HTTP relay
    where it is off), the ``X-Request-Id`` / ``X-Priority`` headers
    forwarded; a JSON body is parsed at the router and leaves as
    ``.npy`` with ``reply="json"``;
  - **retry safety**: a request is resent to a peer only where it
    provably never entered a replica's batcher — the connect failed
    before anything was sent, the replica refused it before admission
    (503 draining or warming), or the connection died and the
    replica's admitted-rid oracle (``GET /admitted/<rid>``) answers
    "not admitted" over a history that covers the send.  Otherwise it
    answers an honest 503 (``retry_safe`` false): the fleet never
    dispatches one request twice;
  - a dead replica is ejected (the monitor probes ``/healthz`` every
    ``fleet.probe_interval_s`` and reaps exited processes);
    :meth:`FleetRouter.scale_up` spawns one more and
    :meth:`FleetRouter.retire` takes one out of rotation first, then
    SIGTERMs it: its drain serves what it admitted, so a scale-down
    loses no request in flight;
  - the aggregated surfaces: ``GET /metrics`` (the replicas'
    expositions summed series by series, the SLO ratio gauges merged by
    ``_MERGE_RULES``, the router's own series after), ``GET /slo``
    (counts summed, burn the fleet's MAX, budget its MIN), ``GET
    /healthz``, ``GET /models`` and ``GET /statusz`` (with each
    replica's device and ``kernels`` block);
  - fleet tracing: the router head-samples under
    ``trace_sample_n``, records its own tree (``route``,
    ``conn_acquire``, ``relay_send``, ``replica_wait``, ``relay_reply``,
    ``retry``), propagates the decision, and ``GET /debug/trace/<rid>``
    answers the tree stitched with the replica's
    (:func:`znicz_tpu_torch.serving.reqtrace.stitch`); ``GET
    /debug/trace``, ``/debug/timeseries`` and ``/debug/pyprof`` fan out
    to the replicas and merge; ``router_overhead_ms`` is the router's
    wall minus the replica's ``X-Serving-Ms`` over the proxied 200s.

**The release plane** (:mod:`znicz_tpu_torch.serving.release`, JAX
:1518-1580): ``POST /release/<model>`` (``{"path": ..., "policy":
{...}}``) deploys the candidate on every UP replica and walks it
through shadow and the canary ladder (``GET /release[/<model>]``
reports, ``DELETE /release/<model>`` aborts), through
:class:`_FleetTarget`.  The relay rewrites a canary rid's model to the
candidate (a candidate gone by the time it answers: the live
generation serves the rid, on the same replica, since an unknown model
is refused before admission), and mirrors a shadowed request after its
reply was written, with the bucket the replica's batch ran at
(``X-Serving-Bucket``).  A mutation of a released model through
``/reload`` or ``/models/`` answers 409.  A replica that enters
rotation mid-release gets the active candidates first.

**The autoscaler** (:mod:`znicz_tpu_torch.serving.autoscaler`,
``serve --fleet N --autoscale``) is attached as ``autoscaler``; it
reads :meth:`FleetRouter.aggregate_slo`, :meth:`FleetRouter.
queued_rows_total` and :meth:`FleetRouter.alive_count`, acts through
``scale_up`` and ``retire``, and stops with the router; ``/statusz``
carries its status and the release plane's.  The router's lock is a
``locksmith`` lock; each replica's connection lock stays plain, as in
JAX.
"""

import collections
import http.client
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import pyprof, telemetry, timeseries
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.status_server import (BodyTooLargeError,
                                                HandlerBase, HttpServerBase)
from znicz_tpu_torch.serving import reqtrace, wire
from znicz_tpu_torch.serving.release import (ReleaseConflictError,
                                             ReleaseController)

_cfg = root.common.serving
_fleet = root.common.serving.fleet

telemetry.register_help(
    "router", "fleet front end (serving/router.py): proxied "
              "requests, peer retries, unsafe-retry 503s, replica "
              "ejections")
telemetry.register_help(
    "fleet", "replica fleet state (serving/router.py): spawned/up "
             "replica counts and scale events")

#: the startup banner of ``python -m znicz_tpu_torch serve`` — the replica's
#: chosen port rides in it (the child binds port 0).  The host may be
#: a name, not just a dotted quad: ``--config common.serving.host=``
#: forwards to replicas by design
_URL_RE = re.compile(r"on (http://[^/\s:]+:\d+)/")

#: proxy timeout for one forwarded /predict (seconds) — generous: the
#: replica's own queue deadline answers first in any healthy setup
_PROXY_TIMEOUT = 120.0

#: replica states
SPAWNING, UP, DRAINING, DEAD = "spawning", "up", "draining", "dead"

#: the environment variable that carries the router's pid to each
#: replica: ``serve`` drains and exits once its parent is no longer
#: that process (``serving/server.py``'s ``_serve_until_term``)
ROUTER_PID_ENV = "ZNICZ_TPU_TORCH_ROUTER_PID"

#: what a request to a replica raises when the replica dies under it:
#: a socket error, or a reply cut short (``http.client.IncompleteRead``
#: and its kin are not ``OSError``)
_HOP_ERRORS = (OSError, http.client.HTTPException)


class _NeverSentError(Exception):
    """The connect failed before one request byte went out — a resend
    is safe by construction."""


class _SentUnknownError(Exception):
    """The connection broke after (part of) the request went out —
    the replica may have admitted it; only the admitted-rid oracle
    can clear a resend.  ``timed_out`` marks a PROXY TIMEOUT (the
    connection may still be alive with the request buffered unread):
    the oracle cannot clear those — "not admitted" only means "not
    admitted YET", and the replica could still read + dispatch the
    request after a resend, the exact duplicate the contract
    forbids.  A reset/EOF, by contrast, killed the connection — the
    replica can never read an unprocessed request off a dead socket,
    so the oracle's answer is final."""

    def __init__(self, message, timed_out=False):
        super(_SentUnknownError, self).__init__(message)
        self.timed_out = timed_out


class _RawConn(object):
    """One keep-alive socket to a replica with a buffered reader —
    the proxy's request/response cycle hand-rolled.  ``http.client``
    plus the email-parser header machinery costs ~0.5 ms of GIL per
    round-trip; the relay only needs the status, three headers and
    the exact-length body, which this reads in a tight loop."""

    __slots__ = ("sock", "rfile")

    def __init__(self, sock):
        self.sock = sock
        self.rfile = sock.makefile("rb")

    def round_trip(self, request_bytes, timing=None):
        """Send one request; return ``(status, headers, body,
        close)`` where ``headers`` carries only Content-Type /
        Retry-After / X-Serving-Ms / X-Serving-Generation /
        X-Serving-Bucket.  Raises
        ``OSError``/``ValueError``
        on any transport or framing failure (the caller maps it to
        the retry-safety machinery).  When ``timing`` is a dict it
        receives the ``sent`` (request fully on the socket) and
        ``first_byte`` (status line arrived) monotonic stamps — the
        boundaries of the router's ``relay_send`` / ``replica_wait``
        trace spans."""
        self.sock.sendall(request_bytes)
        if timing is not None:
            timing["sent"] = time.monotonic()
        line = self.rfile.readline(65537)
        if timing is not None:
            timing["first_byte"] = time.monotonic()
        if not line:
            raise OSError("connection closed before a status line")
        parts = line.split(None, 2)
        status = int(parts[1])
        length = 0
        close = False
        headers = {}
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, value = h.partition(b":")
            key = key.strip().lower()
            if key == b"content-length":
                length = int(value.strip())
            elif key == b"content-type":
                headers["Content-Type"] = \
                    value.strip().decode("latin-1")
            elif key == b"retry-after":
                headers["Retry-After"] = \
                    value.strip().decode("latin-1")
            elif key == b"x-serving-ms":
                headers["X-Serving-Ms"] = \
                    value.strip().decode("latin-1")
            elif key == b"x-serving-generation":
                headers["X-Serving-Generation"] = \
                    value.strip().decode("latin-1")
            elif key == b"x-serving-bucket":
                headers["X-Serving-Bucket"] = \
                    value.strip().decode("latin-1")
            elif key == b"connection" and \
                    value.strip().lower() == b"close":
                close = True
        body = self.rfile.read(length) if length else b""
        if length and len(body) != length:
            raise OSError("short body (%d of %d bytes)"
                          % (len(body), length))
        return status, headers, body, close

    def close(self):
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Replica(Logger):
    """One serving subprocess + its lifecycle bookkeeping."""

    def __init__(self, rid, argv, env=None, keep_lines=60):
        super(Replica, self).__init__(logger_name="Replica[%s]" % rid)
        self.rid = rid
        self.state = SPAWNING
        self.reason = None          # why it left rotation
        self.url = None
        self.host = None
        self.port = None
        #: where the replica's binary framed relay listens
        #: (serving/wire.py) — discovered from /healthz at rotation
        #: entry; None = HTTP relay only
        self.wire_port = None
        self.outstanding = 0        # in-flight proxied requests
        self.served = 0
        self.probe_failures = 0
        self.started = time.monotonic()
        #: seconds from spawn to the first /healthz 200 (None before)
        self.startup_s = None
        #: parked keep-alive connections to this replica (the proxy
        #: reuses them across requests — a fresh TCP connect per
        #: forward costs more than the forward); bounded
        self._conns = collections.deque()
        self._conn_lock = threading.Lock()
        self._url_event = threading.Event()
        self._tail = collections.deque(maxlen=keep_lines)
        env = dict(os.environ if env is None else env)
        env[ROUTER_PID_ENV] = str(os.getpid())
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "znicz_tpu_torch", "serve"]
            + list(argv) + ["--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        self._reader = threading.Thread(
            target=self._drain_output,
            name="znicz:replica-out-%s" % rid,
            daemon=True)
        self._reader.start()

    def _drain_output(self):
        for line in self.proc.stdout:
            self._tail.append(line.rstrip("\n"))
            if self.url is None:
                m = _URL_RE.search(line)
                if m:
                    self.url = m.group(1)
                    host_port = self.url.split("//", 1)[1]
                    self.host, _, port = host_port.partition(":")
                    self.port = int(port)
                    self._url_event.set()
        self._url_event.set()  # EOF: stop any waiter, url may be None

    def wait_ready(self, timeout_s):
        """Block until the replica printed its URL AND answers
        ``/healthz`` 200.  Returns True on ready."""
        deadline = time.monotonic() + float(timeout_s)
        self._url_event.wait(max(0.0, deadline - time.monotonic()))
        if self.url is None:
            return False
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return False
            try:
                with urllib.request.urlopen(self.url + "/healthz",
                                            timeout=5) as resp:
                    if resp.status == 200:
                        try:
                            # the ready payload carries the binary
                            # relay port — stash it here so rotation
                            # entry needs no second (raceable) probe
                            self.wire_port = json.loads(
                                resp.read()).get("wire_port")
                        except ValueError:
                            pass
                        self.startup_s = round(
                            time.monotonic() - self.started, 3)
                        return True
            except urllib.error.HTTPError:
                pass      # 503: still warming
            except _HOP_ERRORS:
                pass      # not accepting yet
            time.sleep(0.05)
        return False

    def tail(self):
        """The retained last output lines (post-mortems)."""
        return list(self._tail)

    def get_conn(self):
        """A parked keep-alive connection, or a fresh connect (which
        raises :class:`_NeverSentError` on failure — nothing was
        sent yet)."""
        with self._conn_lock:
            if self._conns:
                return self._conns.popleft(), True
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=_PROXY_TIMEOUT)
        except OSError as e:
            raise _NeverSentError(repr(e))
        return _RawConn(sock), False

    def put_conn(self, conn):
        with self._conn_lock:
            if len(self._conns) < 64:
                self._conns.append(conn)
                return
        conn.close()

    def close_conns(self):
        with self._conn_lock:
            conns, self._conns = list(self._conns), \
                collections.deque()
        for conn in conns:
            conn.close()

    def terminate(self):
        if self.proc.poll() is None:
            try:
                self.proc.terminate()
            except OSError:
                pass

    def kill(self):
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass

    def stats(self):
        return {
            "id": self.rid, "state": self.state, "url": self.url,
            "wire_port": self.wire_port,
            "outstanding": self.outstanding, "served": self.served,
            "reason": self.reason, "pid": self.proc.pid,
            "exit_code": self.proc.poll(),
            "startup_s": self.startup_s,
            "uptime_s": round(time.monotonic() - self.started, 1),
        }


class _RouterWireExchange(object):
    """One client REQUEST frame on the ROUTER's relay listener,
    presented as the handler surface :meth:`FleetRouter
    ._relay_predict` speaks.  The ``.npy`` body passes through to the
    replica UNTOUCHED (``wire_meta`` marks the passthrough for
    :func:`_wire_encode`) — a binary request is decoded exactly once
    fleet-wide, at the replica, zero-copy.  Errors answer typed ERROR
    frames; the winning reply answers a RESPONSE frame via
    ``wire_reply`` (the :func:`_relay_reply` dispatch)."""

    __slots__ = ("request", "wire_meta", "t_recv", "headers",
                 "status")

    def __init__(self, request):
        meta = request.meta
        self.request = request
        self.wire_meta = meta
        self.t_recv = request.t_recv
        self.status = None
        headers = {"Content-Type": "application/octet-stream"}
        rid = meta.get("rid")
        if rid:
            headers["X-Request-Id"] = str(rid)
        priority = meta.get("priority")
        if priority:
            headers["X-Priority"] = str(priority)
        self.headers = headers

    def _read_body(self):
        return self.request.body

    def _drain_body(self):
        pass

    def _send_json(self, code, obj, headers=None):
        headers = headers or {}
        self.status = int(code)
        self.request.reply(wire.error_frame(
            code, obj, rid=headers.get("X-Request-Id"),
            retry_after=headers.get("Retry-After")))

    def wire_reply(self, status, ctype, data, headers):
        self.status = int(status)
        if status >= 400 and (ctype or "").startswith(
                "application/json"):
            # a relayed replica error leaves as the SAME typed ERROR
            # frame a direct-to-replica wire client would see — the
            # payload is the JSON object either HTTP surface answers
            try:
                payload = json.loads(bytes(data))
            except ValueError:
                payload = {"error": bytes(data).decode("latin-1")}
            self.request.reply(wire.error_frame(
                status, payload, rid=headers.get("X-Request-Id"),
                retry_after=headers.get("Retry-After")))
            return
        meta = {"status": int(status), "ctype": ctype}
        for header, key in (("X-Request-Id", "rid"),
                            ("X-Serving-Generation", "generation"),
                            ("X-Serving-Bucket", "bucket"),
                            ("Retry-After", "retry_after")):
            if headers.get(header) is not None:
                meta[key] = headers[header]
        self.request.reply(
            wire.pack_frame(wire.KIND_RESPONSE, meta, data))


def _wire_encode(handler, body, fwd_headers):
    """The relay frame's ``(body, extras)`` for one ingress request.
    A wire-ingest or ``.npy`` HTTP body passes through byte-for-byte
    (decoded ONCE fleet-wide, at the replica); a JSON body is parsed
    here — the edge — and re-leaves as ``.npy`` with
    ``reply="json"``, so the replica answers the exact JSON schema
    (same serializer) the compatibility surface documents.  Raises
    :class:`ValueError` on a client-fault body (the 400 path)."""
    meta = getattr(handler, "wire_meta", None)
    if meta is not None:
        extras = {k: meta[k] for k in ("timeout_ms", "reply")
                  if meta.get(k) is not None}
        return body, extras
    ctype = (fwd_headers.get("Content-Type") or "").split(";")[0]
    if ctype == "application/octet-stream" or \
            body[:6] == b"\x93NUMPY":
        return body, {}
    doc = json.loads(bytes(body).decode() or "null")
    extras = {"reply": "json"}
    if isinstance(doc, dict):
        inputs = doc.get("inputs")
        if doc.get("timeout_ms") is not None:
            extras["timeout_ms"] = doc["timeout_ms"]
        if doc.get("model") is not None:
            if not isinstance(doc["model"], str):
                raise ValueError('"model" must be a string')
            extras["model"] = doc["model"]
        if doc.get("priority") is not None:
            extras["priority"] = doc["priority"]
    else:
        inputs = doc
    if inputs is None:
        raise ValueError('body needs {"inputs": [[...], ...]} '
                         "(or a raw .npy payload)")
    # float64 == JSON's own number type: the replica's parse into the
    # model dtype rounds exactly as it rounds the JSON list itself,
    # so the two codecs answer bit-identical outputs
    return wire.npy_bytes(numpy.asarray(inputs,
                                        dtype=numpy.float64)), extras


def _decode_predict_body(data, ctype):
    """A /predict reply body as an array: the ``.npy`` of an
    octet-stream reply, a JSON reply's ``outputs``."""
    if (ctype or "").startswith("application/octet-stream") or \
            bytes(data[:6]) == b"\x93NUMPY":
        return numpy.load(io.BytesIO(bytes(data)))
    doc = json.loads(bytes(data).decode())
    return numpy.asarray(doc["outputs"], dtype=numpy.float64)


class _FleetTarget(object):
    """The release controller's deployment surface over the fleet (JAX
    :490-605): a candidate deploys by an admin fan-out to every UP
    replica (the fleet stays homogeneous), a shadow predict runs on one
    UP replica under a fresh ``shadow-`` rid (the live rid stays unique
    in every admitted ring) and at the live batch's bucket, a promote is
    a ``/reload`` fan-out; the SLO reads are the fleet's aggregate."""

    def __init__(self, router):
        self._router = router
        self._default = None

    def set_guard(self, fn):
        self._router._release_guard = fn

    def resolve_default(self):
        # the fleet is homogeneous and its default stable for a release
        if self._default is None:
            self._default = self._router.models().get("default")
        return self._default

    def _block(self, name):
        return (self._router.models().get("models") or {}).get(name)

    def live_version(self, model):
        block = self._block(model)
        if block is None:
            raise KeyError("model %r is not served by the fleet" % model)
        return int(block.get("model_version") or 0)

    def serve_dtype(self, name):
        return (self._block(name) or {}).get("serve_dtype")

    def alive(self, name):
        block = self._block(name)
        return bool(block) and bool(block.get("ready"))

    def _fanout(self, method, path, body, replicas=None):
        results, ok = {}, True
        for replica in (replicas if replicas is not None
                        else self._router.replicas()):
            if replicas is None and replica.state != UP:
                continue
            try:
                status, _, _ = self._router._send_to(
                    replica, method, path, body,
                    {"Content-Type": "application/json"})
                results[replica.rid] = status
                ok = ok and status < 400
            except (_NeverSentError, _SentUnknownError) as e:
                results[replica.rid] = repr(e)
                ok = False
        return ok, results

    def deploy(self, name, source, replicas=None):
        """Add the candidate on every UP replica (or on ``replicas``); a
        failure anywhere undeploys it everywhere and raises: a fleet
        where only some replicas hold it would skew every signal."""
        ok, results = self._fanout(
            "POST", "/models/" + name,
            json.dumps({"path": str(source)}).encode(), replicas)
        if not ok:
            self.undeploy(name)
            raise RuntimeError("candidate %s failed to deploy on the "
                               "fleet: %s" % (name, results))

    def undeploy(self, name):
        self._fanout("DELETE", "/models/" + name, b"")

    def promote(self, model, source):
        # a replica boots on the replica argv's package: one entering
        # rotation from now on loads this one, at this generation,
        # first (recorded before the fan-out, which it may miss)
        promoted = self._router._promoted
        version = self.live_version(model) + 1
        with self._router._lock:
            before = promoted.get(model)
            promoted[model] = (str(source), version)
        ok, results = self._fanout(
            "POST", "/reload",
            json.dumps({"path": str(source), "model": model,
                        "version": version}).encode())
        if not ok:
            with self._router._lock:
                if before is None:
                    promoted.pop(model, None)
                else:
                    promoted[model] = before
            # each failed replica rolled back to its generation
            raise RuntimeError("promote reload of %r failed on the "
                               "fleet: %s" % (model, results))

    def join_promoted(self, replica, promoted):
        """Bring a replica entering rotation to each promoted model's
        package and generation; raises when one does not load."""
        for model, (source, version) in promoted.items():
            ok, results = self._fanout(
                "POST", "/reload",
                json.dumps({"path": source, "model": model,
                            "version": version}).encode(), [replica])
            if not ok:
                raise RuntimeError(
                    "replica %s failed to load %r's promoted generation "
                    "%d: %s" % (replica.rid, model, version, results))

    def shadow_predict(self, name, payload, bucket=None):
        body, ctype = payload
        replica = self._router._pick()
        if replica is None:
            raise RuntimeError("no UP replica for shadow traffic")
        headers = {"Content-Type": ctype or "application/json",
                   "X-Request-Id": "shadow-" + uuid.uuid4().hex[:10]}
        if bucket:
            headers["X-Serving-Bucket"] = str(bucket)
        status = None
        try:
            status, resp_headers, data = self._router._send_to(
                replica, "POST", "/predict/" + name, body, headers)
        finally:
            self._router._release(
                replica, served=status is not None and status < 500)
        if status != 200:
            raise RuntimeError("candidate %s answered %s: %s"
                               % (name, status, bytes(data[:200]).decode(
                                   "utf-8", "replace")))
        return _decode_predict_body(data, resp_headers.get("Content-Type"))

    @staticmethod
    def decode_reply(reply):
        data, ctype = reply
        return _decode_predict_body(data, ctype)

    def slo_models(self):
        return self._router.aggregate_slo().get("models") or {}


class FleetRouter(HttpServerBase):
    """The fleet front end (see the module's docstring).

    ``replica_argv`` is the ``serve`` argument list every replica runs
    (model specs and options, without ``--port`` and ``--fleet``);
    ``compile_cache_dir``, where given, is appended to it as
    ``--compile-cache DIR`` (unless it holds that flag already), so the
    fleet shares one kernel compile cache (JAX :612-626); ``env`` is
    the replicas' environment (None: this process's).
    """

    def __init__(self, replica_argv, replicas=None, port=0, host=None,
                 compile_cache_dir=None, env=None):
        super(FleetRouter, self).__init__(
            port=port, host=host or _cfg.get("host", "127.0.0.1"),
            logger_name="FleetRouter")
        argv = list(replica_argv)
        if compile_cache_dir is not None and "--compile-cache" not in argv:
            argv += ["--compile-cache", str(compile_cache_dir)]
        self._replica_argv = argv
        self._env = env
        self._n_initial = int(replicas if replicas is not None
                              else _fleet.get("replicas", 2))
        if self._n_initial < 1:
            raise ValueError("a fleet needs at least 1 replica")
        self._lock = locksmith.lock("serving.router")
        self._replicas = []
        self._next_id = 0
        self._rr = 0               # least-outstanding tie-break cursor
        #: router wall minus replica-reported X-Serving-Ms per proxied
        #: 200 — the hop tax /slo and /statusz summarize
        self._overhead = collections.deque(
            maxlen=int(_fleet.get("overhead_window", 512)))
        self._draining = False
        self._monitor = None
        self._monitor_stop = threading.Event()
        #: attached by ``serve --fleet N --autoscale``
        self.autoscaler = None
        #: the release plane, made at the first POST /release/<model>;
        #: its mutation guard vetoes /reload and /models/ fan-outs
        self.release = None
        self._release_guard = None
        #: model -> (source, version) of each promoted release: what a
        #: replica spawned later loads before it enters rotation
        self._promoted = {}
        #: the binary framed relay (serving/wire.py): the rid-
        #: multiplexed persistent-connection pool to the replicas
        #: (the default transport while serving.wire.enabled) and the
        #: router's own client-facing frame listener
        self._wire_mux = None
        self._wire = None

    # -- fleet membership ---------------------------------------------------
    def _spawn(self):
        """Spawn one replica (no rotation entry yet)."""
        with self._lock:
            rid = "r%d" % self._next_id
            self._next_id += 1
        replica = Replica(rid, self._replica_argv, env=self._env)
        with self._lock:
            self._replicas.append(replica)
        return replica

    def _discover_wire(self, replica):
        """The replica's framed-relay port from its /healthz payload
        (None on any failure — the HTTP relay then carries it until
        the monitor's next probe retries the discovery).  A non-200
        answer still carries the port: a warming/degraded 503 body is
        the same payload."""
        if self._wire_mux is None or replica.url is None:
            return None
        try:
            with urllib.request.urlopen(replica.url + "/healthz",
                                        timeout=5) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
        except _HOP_ERRORS:
            return None
        try:
            return json.loads(body).get("wire_port")
        except ValueError:
            return None

    def _enter_rotation(self, replica):
        if replica.wire_port is None:
            # normally stashed by wait_ready's 200 payload; a replica
            # entering by another path gets one discovery probe here
            replica.wire_port = self._discover_wire(replica)
        with self._lock:
            promoted = dict(self._promoted)
        if promoted:
            try:
                _FleetTarget(self).join_promoted(replica, promoted)
            except RuntimeError:
                # never a fleet serving two generations of one model
                replica.state = DEAD
                replica.reason = "promoted_load_failed"
                replica.kill()
                raise
        release = self.release
        if release is not None:
            # mid-release: the new replica holds every candidate before
            # it takes a canary or shadow request
            for name, source in release.candidates().items():
                try:
                    _FleetTarget(self).deploy(name, source,
                                              replicas=[replica])
                except RuntimeError as e:
                    self.warning("replica %s entering rotation without "
                                 "candidate %s: %s", replica.rid, name, e)
        replica.state = UP
        replica.probe_failures = 0
        telemetry.record_event("fleet.replica_spawn",
                               replica=replica.rid, url=replica.url)
        self._set_gauges()
        self.info("replica %s up at %s", replica.rid, replica.url)

    def start(self, wait_ready=True):
        """Spawn the initial fleet (concurrently), wait until every
        replica is ready, then open the routing surface."""
        if root.common.serving.get("wire", {}).get("enabled", True):
            # the binary relay is the default transport: the mux must
            # exist before the first replica enters rotation (its
            # wire port is discovered there), and the router's own
            # frame listener opens alongside the HTTP surface
            self._wire_mux = wire.WireMux()
            self._wire = wire.WireListener(
                self._wire_group, host=self.host,
                name="router").start()
        spawned = [self._spawn() for _ in range(self._n_initial)]
        timeout_s = float(_fleet.get("spawn_timeout_s", 180.0))
        if wait_ready:
            for replica in spawned:
                if not replica.wait_ready(timeout_s):
                    tails = "\n".join(replica.tail()[-15:])
                    self.shutdown_fleet()
                    raise RuntimeError(
                        "replica %s failed to become ready within "
                        "%.0f s; last output:\n%s"
                        % (replica.rid, timeout_s, tails))
                self._enter_rotation(replica)
        super(FleetRouter, self).start()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="znicz:fleet-monitor",
            daemon=True)
        self._monitor.start()
        return self

    def scale_up(self, wait_ready=True):
        """Spawn one replica and (optionally) wait it into rotation.
        The kernels' libraries are built already, so the new replica
        starts no ``nvcc`` (its ``/statusz`` ``kernels`` block counts
        the libraries it built: 0)."""
        replica = self._spawn()
        if wait_ready:
            if not replica.wait_ready(
                    float(_fleet.get("spawn_timeout_s", 180.0))):
                replica.state = DEAD
                replica.reason = "spawn_failed"
                replica.kill()
                raise RuntimeError(
                    "scale-up replica %s failed to become ready; "
                    "last output:\n%s"
                    % (replica.rid, "\n".join(replica.tail()[-15:])))
            self._enter_rotation(replica)
        return replica

    def retire(self, rid=None, wait_s=None):
        """Graceful scale-down: eject ONE replica from rotation, then
        SIGTERM it — the replica's drain path serves everything it
        already admitted before exiting, so no in-flight request is
        dropped.  ``rid`` picks a specific replica (default: the UP
        replica with the fewest outstanding requests, newest on
        ties).  ``wait_s`` blocks until the process exits."""
        with self._lock:
            ups = [r for r in self._replicas if r.state == UP]
            if rid is not None:
                victims = [r for r in ups if r.rid == rid]
            else:
                victims = sorted(ups, key=lambda r: (r.outstanding,
                                                     -r.started))
            if not victims:
                raise ValueError("no UP replica to retire (%s)"
                                 % (rid or "fleet empty"))
            victim = victims[0]
            # out of rotation FIRST: no new work lands on it while
            # it drains what it has
            victim.state = DRAINING
            victim.reason = "retired"
        telemetry.record_event("fleet.replica_retired",
                               replica=victim.rid)
        self._set_gauges()
        self.info("retiring replica %s (graceful drain)", victim.rid)
        victim.terminate()
        if wait_s:
            deadline = time.monotonic() + float(wait_s)
            while victim.proc.poll() is None and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        return victim

    def shutdown_fleet(self):
        """SIGTERM every live replica and reap them (router stop)."""
        with self._lock:
            replicas = list(self._replicas)
        for r in replicas:
            r.terminate()
        deadline = time.monotonic() + 30.0
        for r in replicas:
            while r.proc.poll() is None and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            if r.proc.poll() is None:
                r.kill()
            r.close_conns()
            r.state = DEAD
            r.reason = r.reason or "shutdown"

    def stop(self):
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.release is not None:
            self.release.stop()
        super(FleetRouter, self).stop()
        if self._wire is not None:
            self._wire.stop()
            self._wire = None
        if self._wire_mux is not None:
            self._wire_mux.stop()
            self._wire_mux = None
        self.shutdown_fleet()

    def drain(self):
        """Graceful fleet shutdown (the SIGTERM path): refuse new
        work, drain every replica, exit."""
        self._draining = True
        telemetry.record_event("fleet.drain")
        self.stop()

    @property
    def wire_port(self):
        """The router's own framed-relay listener port (mirrors the
        replica contract), or None with the wire disabled."""
        return self._wire.port if self._wire is not None else None

    # -- rotation -----------------------------------------------------------
    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def up_count(self):
        with self._lock:
            return sum(1 for r in self._replicas if r.state == UP)

    def alive_count(self):
        """The replicas that count toward the fleet's size: up, spawning
        or draining out (a retire in progress must not read as a
        replica missing, or the autoscaler would replace it)."""
        with self._lock:
            return sum(1 for r in self._replicas
                       if r.state in (UP, SPAWNING, DRAINING))

    def _pick(self, exclude=()):
        """Least-outstanding-requests balancing over UP replicas;
        ties rotate.  Claims one outstanding slot on the winner."""
        with self._lock:
            ups = [r for r in self._replicas
                   if r.state == UP and r.rid not in exclude]
            if not ups:
                return None
            lowest = min(r.outstanding for r in ups)
            tied = [r for r in ups if r.outstanding == lowest]
            replica = tied[self._rr % len(tied)]
            self._rr += 1
            replica.outstanding += 1
            return replica

    def _release(self, replica, served=False):
        with self._lock:
            replica.outstanding = max(0, replica.outstanding - 1)
            if served:
                replica.served += 1

    def _eject(self, replica, state, reason):
        with self._lock:
            if replica.state == DEAD:
                return False
            if replica.state == state:
                # a planned retire raced the monitor's own draining
                # probe: the first eject wins and keeps its reason
                return False
            replica.state = state
            replica.reason = reason
        replica.close_conns()
        if state == DEAD and self._wire_mux is not None:
            # parked frames fail fast ONLY on a dead replica — a
            # DRAINING one is still serving what it already admitted,
            # so its in-flight frames must be left to complete (the
            # zero-loss drain; close_conns above only closes PARKED
            # keep-alives, the HTTP analog of the same rule)
            self._wire_mux.drop(replica.rid)
        if telemetry.enabled():
            telemetry.counter("router.replica_ejections").inc()
        self._set_gauges()
        return True

    def _set_gauges(self):
        if not telemetry.enabled():
            return
        with self._lock:
            total = sum(1 for r in self._replicas
                        if r.state != DEAD)
            up = sum(1 for r in self._replicas if r.state == UP)
        telemetry.gauge("fleet.replicas").set(total)
        telemetry.gauge("fleet.replicas_up").set(up)

    # -- health monitor -----------------------------------------------------
    def _monitor_loop(self):
        interval = float(_fleet.get("probe_interval_s", 1.0))
        max_failures = int(_fleet.get("probe_failures", 3))
        while not self._monitor_stop.wait(interval):
            for replica in self.replicas():
                try:
                    self._probe(replica, max_failures)
                except Exception:  # noqa: BLE001 - the monitor must live
                    # a dead monitor never ejects a replica again
                    self.exception("probe of replica %s failed",
                                   replica.rid)

    def _probe(self, replica, max_failures):
        code = replica.proc.poll()
        if code is not None:
            if replica.state in (UP, SPAWNING):
                # an unplanned exit: eject + count a death (a
                # DRAINING replica exiting 0 is a finished retire)
                if self._eject(replica, DEAD, "exited_%s" % code):
                    if telemetry.enabled():
                        telemetry.counter(
                            "router.replica_deaths").inc()
                    telemetry.record_event(
                        "fleet.replica_dead", replica=replica.rid,
                        exit_code=code)
                    self.warning("replica %s died (exit %s)",
                                 replica.rid, code)
            elif replica.state == DRAINING:
                # a finished drain: now the conns can go — any frame
                # still parked on the mux died with the process
                replica.state = DEAD
                replica.close_conns()
                if self._wire_mux is not None:
                    self._wire_mux.drop(replica.rid)
                self._set_gauges()
            return
        if replica.state != UP:
            return
        try:
            with urllib.request.urlopen(replica.url + "/healthz",
                                        timeout=5) as resp:
                payload = json.loads(resp.read())
            replica.probe_failures = 0
            if replica.wire_port is None:
                # a hiccup at rotation entry must not demote the
                # replica to HTTP relay forever
                replica.wire_port = payload.get("wire_port")
            if payload.get("draining"):
                self._eject(replica, DRAINING, "draining")
        except urllib.error.HTTPError as e:
            body = e.read()
            replica.probe_failures = 0
            try:
                if json.loads(body).get("draining"):
                    self._eject(replica, DRAINING, "draining")
            except ValueError:
                pass
        except (_HOP_ERRORS + (ValueError,)):
            # unreachable, cut short, or a 200 whose body is not JSON
            replica.probe_failures += 1
            if replica.probe_failures >= max_failures:
                if self._eject(replica, DEAD, "unreachable"):
                    telemetry.record_event(
                        "fleet.replica_dead", replica=replica.rid,
                        exit_code=None, reason="unreachable")
                    self.warning("replica %s unreachable after %d "
                                 "probes — ejected", replica.rid,
                                 replica.probe_failures)
                    replica.kill()

    # -- the proxy ----------------------------------------------------------
    def _send_to(self, replica, method, path, body, headers,
                 trace=None, t0=None):
        """One forwarded request over a (reused) keep-alive
        connection.  Raises :class:`_NeverSentError` when the connect
        failed (resend safe) and :class:`_SentUnknownError` when the
        connection broke after bytes went out — including a stale
        parked connection the replica had closed; the admitted-rid
        oracle then clears (or forbids) the resend either way.

        When ``trace`` is a dict, the hop's phase spans are BUFFERED
        into it (``spans``: (kind, t0, t1, attrs) tuples, plus the
        ``first_byte`` stamp) — the caller commits them only for the
        attempt that actually answered, so a failed attempt collapses
        into one ``retry`` span and the partition stays exact."""
        # a frame's body (a memoryview, from a wire ingress to a replica
        # without a relay port) joins the head as it is
        head = ["%s %s HTTP/1.1" % (method, path),
                "Host: %s:%d" % (replica.host, replica.port),
                "Content-Length: %d" % len(body or b"")]
        for key, value in headers.items():
            head.append("%s: %s" % (key, value))
        request_bytes = ("\r\n".join(head) + "\r\n\r\n").encode(
            "latin-1") + (body or b"")
        t_acq = (t0 if t0 is not None else time.monotonic()) \
            if trace is not None else 0.0
        conn, reused = replica.get_conn()
        t_send = time.monotonic() if trace is not None else 0.0
        timing = {} if trace is not None else None
        try:
            status, resp_headers, data, close = conn.round_trip(
                request_bytes, timing=timing)
        except socket.timeout as e:
            conn.close()
            raise _SentUnknownError("proxy timeout: " + repr(e),
                                    timed_out=True)
        except (OSError, ValueError, IndexError) as e:
            conn.close()
            raise _SentUnknownError(
                ("stale-keepalive " if reused else "") + repr(e))
        if close:
            conn.close()
        else:
            replica.put_conn(conn)
        if trace is not None:
            trace["spans"] = [
                ("conn_acquire", t_acq, t_send, {"reused": reused}),
                ("relay_send", t_send, timing["sent"], None),
                ("replica_wait", timing["sent"], timing["first_byte"],
                 {"replica": replica.rid}),
            ]
            trace["first_byte"] = timing["first_byte"]
        return status, resp_headers, data

    def _send_wire(self, replica, meta, body, trace=None, t0=None):
        """One forwarded request over the binary relay — the same
        ``(status, resp_headers, data)`` contract (and the same
        retry-safety exception taxonomy) as :meth:`_send_to`, so the
        relay loop treats the two transports identically.  The frame
        round-trips on the rid-multiplexed persistent mux
        (:class:`~znicz_tpu_torch.serving.wire.WireMux`): no per-request
        connect, no HTTP head, no body re-encode."""
        t_acq = (t0 if t0 is not None else time.monotonic()) \
            if trace is not None else 0.0
        timing = {} if trace is not None else None
        try:
            kind, rmeta, rbody, t_frame = self._wire_mux.round_trip(
                replica.rid, (replica.host, replica.wire_port),
                meta, body, timeout=_PROXY_TIMEOUT, timing=timing)
        except wire.WireConnectError as e:
            raise _NeverSentError(repr(e))
        except wire.WireTimeoutError as e:
            raise _SentUnknownError(repr(e), timed_out=True)
        except (wire.WireDeadError, OSError) as e:
            raise _SentUnknownError(repr(e))
        status = int(rmeta.get("status", 502))
        resp_headers = {}
        if kind == wire.KIND_ERROR:
            # the ERROR frame's payload IS the JSON object the HTTP
            # surface would have answered — every downstream
            # classifier (_refused_pre_admission, the client relay)
            # reads it unchanged
            data = json.dumps(rmeta.get("payload") or {}).encode()
            resp_headers["Content-Type"] = "application/json"
        else:
            data = bytes(rbody)
            resp_headers["Content-Type"] = (rmeta.get("ctype") or
                                            "application/octet-stream")
            if rmeta.get("serving_ms") is not None:
                resp_headers["X-Serving-Ms"] = str(rmeta["serving_ms"])
            if rmeta.get("generation"):
                resp_headers["X-Serving-Generation"] = \
                    rmeta["generation"]
            if rmeta.get("bucket") is not None:
                resp_headers["X-Serving-Bucket"] = str(rmeta["bucket"])
        if rmeta.get("retry_after") is not None:
            resp_headers["Retry-After"] = str(rmeta["retry_after"])
        if trace is not None:
            # the worker stamps t_sent AFTER _sendall_nb returns; on
            # a fast hop the reply frame can complete on the mux loop
            # before this worker is scheduled again — clamp so
            # replica_wait never runs backwards
            t_sent = min(timing.get("t_sent", t_acq), t_frame)
            trace["spans"] = [
                ("conn_acquire", t_acq,
                 timing.get("t_acquire", t_acq), {"mux": True}),
                ("relay_send", timing.get("t_acquire", t_acq),
                 t_sent, None),
                ("replica_wait", t_sent, t_frame,
                 {"replica": replica.rid, "wire": True}),
            ]
            trace["first_byte"] = t_frame
            # frame complete on the mux loop -> this worker resumed:
            # the relay_wait span, NESTED inside relay_reply
            trace["resumed"] = time.monotonic()
        return status, resp_headers, data

    def _rid_admitted(self, replica, rid, sent_at):
        """Ask the replica's admitted-rid oracle.  True/False, or
        None when the answer cannot be trusted — dead/unreachable, a
        batcher that does not track rids (a single-engine
        micro-batcher replica), or a bounded ring whose history no
        longer COVERS our send: once entries admitted after
        ``sent_at`` have been evicted, an evicted rid and a
        never-seen rid are indistinguishable, so a miss stops being
        proof.  None means a resend is UNSAFE.  (``sent_at`` is wall
        time — replicas run on this host, sharing the clock; a small
        margin absorbs scheduling jitter.)"""
        try:
            with urllib.request.urlopen(
                    replica.url + "/admitted/" + rid,
                    timeout=5) as resp:
                doc = json.loads(resp.read())
            if not doc.get("tracked"):
                return None
            if doc.get("admitted"):
                return True
            if doc.get("evictions"):
                oldest = doc.get("oldest_retained_ts")
                if oldest is None or oldest > sent_at - 0.5:
                    return None  # the miss may BE the eviction
            return False
        except (_HOP_ERRORS + (ValueError,)):
            return None

    @staticmethod
    def _refused_pre_admission(status, data):
        """``"draining"`` / ``"warming"`` / None for a reply that
        PROVES the replica refused the request before its batcher
        admitted it — the resend-safe 503s.  (429s are also
        pre-admission, but a shed is the fleet's backpressure signal:
        it relays to the client rather than retrying, or the router
        would amplify overload.)"""
        if status != 503:
            return None
        try:
            doc = json.loads(data)
        except ValueError:
            return None
        err = str(doc.get("error", ""))
        if "draining" in err:
            return "draining"
        if "warming" in err:
            return "warming"
        return None

    def _wire_group(self, group):
        """Front-door binary ingest: every complete frame the
        listener loop drained from one readable socket arrives as a
        group.  Each becomes a :class:`_RouterWireExchange` and runs
        the SAME `_proxy_predict` path as HTTP — same sampling, same
        retry/oracle/breaker logic — only the transport at both edges
        differs.  Trailing requests fan out to the pool so one slow
        relay never holds up its coalesced siblings."""
        exchanges = []
        for req in group:
            exchanges.append(_RouterWireExchange(req))
        for ex in exchanges[1:]:
            self._wire.submit(self._wire_relay_one, ex)
        if exchanges:
            self._wire_relay_one(exchanges[0])

    def _wire_relay_one(self, ex):
        model = ex.wire_meta.get("model")
        path = "/predict/%s" % model if model else "/predict"
        try:
            self._proxy_predict(ex, path)
        except Exception as e:  # noqa: BLE001 -- keep the conn sane
            if ex.status is None:
                ex.request.reply(wire.error_frame(
                    500, {"error": str(e),
                          "request_id": ex.wire_meta.get("rid")},
                    rid=ex.wire_meta.get("rid")))

    def _proxy_predict(self, handler, path):
        """One routed /predict: head-samples the admission under the
        shared ``trace_sample_n`` knob (origin="router"), then hands
        the relay to :meth:`_relay_predict`.  The wrapper owns
        closing the tree so every early-return error path still
        stamps its wall time."""
        # a wire-ingest exchange back-dates receipt to its frame's
        # completion on the listener loop, like the replica side
        t_recv = getattr(handler, "t_recv", None) or time.monotonic()
        if telemetry.enabled():
            telemetry.counter("router.requests").inc()
        rid = (handler.headers.get("X-Request-Id") or "").strip()
        rid = rid[:64] if rid else uuid.uuid4().hex[:12]
        traced = reqtrace.enabled() and reqtrace.begin(
            rid, now=t_recv, origin="router")
        if not traced:
            self._relay_predict(handler, path, rid, t_recv, False)
            return
        try:
            self._relay_predict(handler, path, rid, t_recv, True)
        finally:
            reqtrace.finish(rid)

    def _relay_predict(self, handler, path, rid, t_recv, traced):
        echo = {"X-Request-Id": rid}
        if self._draining:
            handler._drain_body()
            handler._send_json(
                503, {"error": "router draining", "request_id": rid},
                headers=dict(echo, **{"Retry-After": "1"}))
            return
        try:
            body = handler._read_body()
        except BodyTooLargeError as e:
            handler._send_json(413, {"error": str(e),
                                     "request_id": rid}, headers=echo)
            return
        except ValueError as e:
            handler._send_json(400, {"error": str(e),
                                     "request_id": rid}, headers=echo)
            return
        fwd_headers = {"X-Request-Id": rid}
        for name in ("Content-Type", "X-Priority"):
            value = handler.headers.get(name)
            if value:
                fwd_headers[name] = value
        if reqtrace.enabled():
            # propagate the sampling decision: the replica traces the
            # SAME rid the router picked — and ONLY that rid, keeping
            # the two rings aligned (serving/server.py honors it)
            fwd_headers["X-Trace-Sampled"] = "1" if traced else "0"
        model = None
        if path.startswith("/predict/"):
            model = path[len("/predict/"):] or None
        # binary relay (the default transport): encode the frame body
        # ONCE before the attempt loop — a wire/.npy ingress passes
        # through byte-for-byte, a JSON ingress is parsed here at the
        # edge and re-leaves as .npy (decoded exactly once fleet-wide)
        wire_body = wire_extras = None
        if self._wire_mux is not None:
            try:
                wire_body, wire_extras = _wire_encode(
                    handler, body, fwd_headers)
            except ValueError as e:
                handler._send_json(400, {"error": repr(e),
                                         "request_id": rid},
                                   headers=echo)
                return
            if model is None and wire_extras.get("model") is not None:
                # the body's "model" routes exactly as the HTTP relay
                # lets the replica route it — and rides in the frame
                # meta, not re-serialized into the body
                model = wire_extras["model"]
        # the canary split: an active release may send this rid to the
        # candidate, the same generation at every retry of the rid; the
        # shadow mirror keeps the live model's name
        live_model, cand = model, None
        ctl = self.release
        if ctl is not None and ctl.active():
            cand = ctl.route(model, rid)
            if cand is not None:
                path = "/predict/" + cand
                model = cand
        hops = []   # committed (kind, t0, t1) spans — the histograms
        if traced:
            t_route = time.monotonic()
            reqtrace.add_span(rid, "route", t_recv, t_route)
            hops.append(("route", t_recv, t_route))
        retries = int(_fleet.get("route_retries", 2))
        tried = set()
        for attempt in range(retries + 1):
            # the attempt clock starts BEFORE the pick: replica
            # selection (a lock) and per-attempt meta assembly land
            # inside conn_acquire, so the hop phases tile the wall
            # with no gap — the partition pin holds even when the
            # binary relay shrinks the hop to ~1ms
            attempt_t0 = time.monotonic() if traced else 0.0
            replica = self._pick(exclude=tried)
            if replica is None:
                handler._send_json(
                    503, {"error": "no replica available",
                          "request_id": rid},
                    headers=dict(echo, **{"Retry-After": "1"}))
                return
            tried.add(replica.rid)
            sent_at = time.time()
            hop = {} if traced else None
            try:
                if wire_body is not None and replica.wire_port:
                    meta = {"rid": rid}
                    for key, value in wire_extras.items():
                        if key != "model":  # the path wins
                            meta[key] = value
                    if model is not None:
                        meta["model"] = model  # the path or the canary
                    if fwd_headers.get("X-Priority"):
                        meta["priority"] = fwd_headers["X-Priority"]
                    if "X-Trace-Sampled" in fwd_headers:
                        meta["sampled"] = \
                            fwd_headers["X-Trace-Sampled"]
                    status, resp_headers, data = self._send_wire(
                        replica, meta, wire_body, trace=hop,
                        t0=attempt_t0 if traced else None)
                else:
                    status, resp_headers, data = self._send_to(
                        replica, "POST", path, body, fwd_headers,
                        trace=hop, t0=attempt_t0 if traced else None)
            except _NeverSentError:
                # nothing went out: resend is safe by construction
                self._release(replica)
                self._note_retry(replica, rid, "connect_failed")
                self._note_failed_attempt(rid, traced, hops,
                                          attempt_t0, replica,
                                          "connect_failed")
                continue
            except _SentUnknownError as e:
                self._release(replica)
                # a proxy TIMEOUT never consults the oracle: the
                # connection may still be alive with the request
                # buffered, so "not admitted" would only mean "not
                # admitted YET" — a resend could still double-
                # dispatch when the replica catches up.  Only a
                # dead connection (reset/EOF) makes the oracle's
                # answer final.
                admitted = (None if e.timed_out
                            else self._rid_admitted(replica, rid,
                                                    sent_at))
                if admitted is False:
                    # the replica is alive and its batcher never saw
                    # this rid — the socket broke pre-admission
                    self._note_retry(replica, rid, "not_admitted")
                    self._note_failed_attempt(rid, traced, hops,
                                              attempt_t0, replica,
                                              "not_admitted")
                    continue
                # admitted (may have dispatched) or unknowable (the
                # replica died with the answer): an honest 503, never
                # a duplicate dispatch
                if telemetry.enabled():
                    telemetry.counter("router.unsafe_503s").inc()
                self._note_failed_attempt(rid, traced, hops,
                                          attempt_t0, replica,
                                          "unsafe_503")
                handler._send_json(
                    503, {"error": "replica connection lost "
                                   "mid-request; retry unsafe "
                                   "(admission %s): %s"
                                   % ("confirmed" if admitted
                                      else "unknown", e),
                          "request_id": rid,
                          "retry_safe": False},
                    headers=dict(echo, **{"Retry-After": "1"}))
                return
            served = status < 500
            self._release(replica, served=served)
            refusal = self._refused_pre_admission(status, data)
            if refusal is not None:
                # the replica said no BEFORE admission — a resend on
                # a peer is safe.  Draining additionally leaves
                # rotation for good; warming is transient (a model
                # mid-hot-add), so the replica stays in rotation and
                # only this request tries a peer
                if refusal == "draining":
                    self._eject(replica, DRAINING, "draining")
                self._note_retry(replica, rid,
                                 "refused_" + refusal)
                self._note_failed_attempt(rid, traced, hops,
                                          attempt_t0, replica,
                                          "refused_" + refusal)
                continue
            if cand is not None and status == 404:
                # the candidate went between the split and the relay (a
                # rollback removed it): an unknown model is refused
                # before admission, so the live generation may serve the
                # rid, on the same replica too
                path = ("/predict/" + live_model if live_model
                        else "/predict")
                model, cand = live_model, None
                tried.discard(replica.rid)
                self._note_retry(replica, rid, "candidate_gone")
                self._note_failed_attempt(rid, traced, hops,
                                          attempt_t0, replica,
                                          "candidate_gone")
                continue
            ctype = resp_headers.get("Content-Type") or \
                "application/json"
            out_headers = dict(echo)
            if resp_headers.get("Retry-After"):
                out_headers["Retry-After"] = \
                    resp_headers["Retry-After"]
            for name in ("X-Serving-Generation", "X-Serving-Bucket"):
                # which generation answered, at which bucket, rides to
                # the client
                if resp_headers.get(name):
                    out_headers[name] = resp_headers[name]
            if telemetry.enabled():
                telemetry.counter("router.proxied").inc()
            _relay_reply(handler, status, ctype, data, out_headers)
            if ctl is not None and cand is None and status == 200 \
                    and ctl.wants_mirror(live_model, rid):
                # the shadow mirror, after the client has its reply; a
                # frame's body is copied (its buffer is the listener's)
                try:
                    bucket = int(resp_headers.get("X-Serving-Bucket") or 0)
                except ValueError:
                    bucket = 0
                ctl.mirror(live_model, rid,
                           (bytes(body), fwd_headers.get("Content-Type")),
                           (data, ctype), bucket=bucket or None)
            t_done = time.monotonic()
            if traced:
                # commit the winning attempt's buffered phase spans,
                # then close the relay: first reply byte -> reply on
                # the client socket
                for kind, s0, s1, attrs in hop.get("spans", ()):
                    reqtrace.add_span(rid, kind, s0, s1,
                                      **(attrs or {}))
                    hops.append((kind, s0, s1))
                first = hop.get("first_byte", t_done)
                reqtrace.add_span(rid, "relay_reply", first, t_done)
                hops.append(("relay_reply", first, t_done))
                if "resumed" in hop:
                    # binary relay only: frame complete on the mux
                    # loop -> the relay worker resumed (nested in
                    # relay_reply — the partition stays exact)
                    reqtrace.add_span(rid, "relay_wait", first,
                                      hop["resumed"])
                    hops.append(("relay_wait", first,
                                 hop["resumed"]))
                reqtrace.set_model(rid, model)
                # close the tree AT the reply stamp: the histogram
                # and overhead bookkeeping below happen after the
                # client already has its bytes, and must not count
                # against the hop-phase partition
                reqtrace.finish(rid, now=t_done)
                self._note_hops(model, hops)
            serving_ms = resp_headers.get("X-Serving-Ms")
            if status == 200 and serving_ms:
                try:
                    overhead = ((t_done - t_recv) * 1e3
                                - float(serving_ms))
                except ValueError:
                    overhead = None
                if overhead is not None:
                    with self._lock:
                        self._overhead.append(overhead)
            return
        handler._send_json(
            503, {"error": "no replica accepted the request after "
                           "%d attempts" % (retries + 1),
                  "request_id": rid},
            headers=dict(echo, **{"Retry-After": "1"}))

    def _note_failed_attempt(self, rid, traced, hops, t0, replica,
                             reason):
        """Collapse one failed attempt into a single ``retry`` span
        (attrs carry the peer + reason) — its inner phases are
        DISCARDED so retried requests keep the wall-time partition
        exact (retry never overlaps the winning attempt's spans)."""
        if not traced:
            return
        t1 = time.monotonic()
        reqtrace.add_span(rid, "retry", t0, t1, peer=replica.rid,
                          reason=reason)
        hops.append(("retry", t0, t1))

    def _note_hops(self, model, hops):
        """``fleet.hop_seconds.<kind>`` histograms per model — the
        hop tax as an aggregate, fed from the sampled requests' span
        timings (no extra clock reads)."""
        if not telemetry.enabled():
            return
        model = model or "default"
        for kind, s0, s1 in hops:
            telemetry.histogram(telemetry.labeled(
                "fleet.hop_seconds.%s" % kind,
                model=model)).observe(s1 - s0)

    def _note_retry(self, replica, rid, why):
        if telemetry.enabled():
            telemetry.counter("router.retries").inc()
        self.info("retrying %s on a peer (%s was %s)", rid,
                  replica.rid, why)

    def _admin_fanout(self, handler, method, path):
        """Admin mutations (add/reload/remove a model) apply to EVERY
        up replica — the fleet stays homogeneous.  Replies with the
        per-replica outcomes; any failure is a 502.  A mutation of a
        model under release (or of its candidate) answers 409."""
        try:
            body = handler._read_body()
        except ValueError as e:
            handler._send_json(400, {"error": str(e)})
            return
        guard = self._release_guard
        if guard is not None:
            if path.startswith("/models/"):
                name = path[len("/models/"):]
            else:
                try:
                    name = json.loads(body.decode() or "{}").get("model")
                except (ValueError, AttributeError):
                    name = None
            try:
                guard(name, method.lower() + " " + path)
            except ReleaseConflictError as e:
                handler._send_json(409, {"error": str(e)})
                return
        results, ok = {}, True
        for replica in self.replicas():
            if replica.state != UP:
                continue
            try:
                status, _, data = self._send_to(
                    replica, method, path, body,
                    {"Content-Type": "application/json"})
                try:
                    doc = json.loads(data)
                except ValueError:
                    doc = {"raw": data.decode("utf-8", "replace")}
                results[replica.rid] = {"status": status,
                                        "reply": doc}
                ok = ok and status < 400
            except (_NeverSentError, _SentUnknownError) as e:
                results[replica.rid] = {"status": None,
                                        "error": str(e)}
                ok = False
        handler._send_json(200 if ok else 502,
                           {"ok": ok, "replicas": results})

    # -- the release plane --------------------------------------------------
    def _release_controller(self):
        """The fleet's release controller, made at first use."""
        with self._lock:
            if self.release is None:
                self.release = ReleaseController(_FleetTarget(self))
            return self.release

    def _release_post(self, handler, name):
        try:
            doc = json.loads(handler._read_body().decode() or "{}")
            source = doc["path"]
        except (ValueError, TypeError) as e:
            handler._send_json(400, {"error": str(e)})
            return
        except KeyError:
            handler._send_json(400, {"error": 'body needs {"path": '
                                              '"..."}'})
            return
        try:
            payload = self._release_controller().start().start_release(
                name, source, policy=doc.get("policy"))
        except ReleaseConflictError as e:
            handler._send_json(409, {"error": str(e)})
            return
        except ValueError as e:
            handler._send_json(400, {"error": str(e)})
            return
        except KeyError as e:
            handler._send_json(404, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - a bad candidate file
            handler._send_json(400, {"error": repr(e)})
            return
        handler._send_json(200, payload)

    def _release_get(self, handler, name=None):
        if self.release is None:
            if name is None:
                handler._send_json(200, {"active": {}, "recent": {}})
            else:
                handler._send_json(404, {
                    "error": "no release record for model %r" % name})
            return
        try:
            handler._send_json(200, self.release.status(name))
        except KeyError as e:
            handler._send_json(404, {"error": str(e)})

    def _release_delete(self, handler, name):
        if self.release is None:
            handler._send_json(404, {
                "error": "no active release for model %r" % name})
            return
        try:
            handler._send_json(200, self.release.abort(name))
        except KeyError as e:
            handler._send_json(404, {"error": str(e)})

    # -- aggregation --------------------------------------------------------
    def _fetch(self, replica, path, timeout=10):
        with urllib.request.urlopen(replica.url + path,
                                    timeout=timeout) as resp:
            return resp.read()

    def _up_payloads(self, path, parse_json=True):
        """{rid: payload} over the UP replicas; fetch failures are
        skipped (the monitor will eject)."""
        out = {}
        for replica in self.replicas():
            if replica.state != UP:
                continue
            try:
                raw = self._fetch(replica, path)
                out[replica.rid] = (json.loads(raw) if parse_json
                                    else raw.decode())
            except (_HOP_ERRORS + (ValueError,)):
                continue
        return out

    def aggregate_metrics(self):
        """One Prometheus exposition for the whole fleet: the
        per-series SUM over every replica (counters add; gauges add —
        fleet queue depth is the sum of replica queue depths), with
        the router's own registry appended after."""
        texts = list(self._up_payloads("/metrics",
                                       parse_json=False).values())
        merged = _merge_prometheus(texts)
        own = telemetry.prometheus_text() if telemetry.enabled() \
            else ""
        return merged + ("\n" if merged and own else "") + own

    def aggregate_slo(self):
        """The fleet ``/slo``: per-model good/bad/total SUMMED across
        replicas; burn rates aggregate as the fleet MAX and the
        budget as the fleet MIN (the conservative paging view — one
        replica burning its budget pages even when its peers are
        green).  Per-replica payloads ride along."""
        payloads = self._up_payloads("/slo")
        models = {}
        meta = None
        for rid, doc in sorted(payloads.items()):
            meta = meta or doc
            for name, m in (doc.get("models") or {}).items():
                agg = models.setdefault(name, {
                    "good": 0, "bad": 0, "total": 0,
                    "error_budget_remaining": None,
                    "burn_rate": {"fast": None, "slow": None},
                    "burning": False,
                })
                agg["good"] += int(m.get("good") or 0)
                agg["bad"] += int(m.get("bad") or 0)
                agg["total"] += int(m.get("total") or 0)
                budget = m.get("error_budget_remaining")
                if budget is not None:
                    prev = agg["error_budget_remaining"]
                    agg["error_budget_remaining"] = (
                        budget if prev is None else min(prev, budget))
                for window in ("fast", "slow"):
                    burn = (m.get("burn_rate") or {}).get(window)
                    if burn is not None:
                        prev = agg["burn_rate"][window]
                        agg["burn_rate"][window] = (
                            burn if prev is None else max(prev, burn))
                agg["burning"] = agg["burning"] or \
                    bool(m.get("burning"))
        for agg in models.values():
            total = agg["total"]
            agg["good_pct"] = (round(100.0 * agg["good"] / total, 3)
                               if total else None)
        out = {
            "fleet": True,
            "aggregation": {"counts": "sum", "burn_rate": "max",
                            "error_budget_remaining": "min"},
            "models": models,
            "replicas": payloads,
        }
        for key in ("enabled", "slo_ms", "target_pct", "windows_s",
                    "burn_threshold"):
            if meta is not None and key in meta:
                out[key] = meta[key]
        out["router_overhead_ms"] = self.router_overhead()
        return out

    def queued_rows_total(self, payloads=None):
        """Fleet-wide queued rows (the autoscaler's queue-depth
        feed): the sum of every replica's /statusz queued_rows."""
        if payloads is None:
            payloads = self._up_payloads("/statusz")
        return sum(int(doc.get("queued_rows") or 0)
                   for doc in payloads.values())

    def router_overhead(self):
        """The ``router_overhead_ms`` block of ``/slo`` and
        ``/statusz``: router wall minus the replica-reported
        ``X-Serving-Ms``, summarized over the trailing
        ``fleet.overhead_window`` proxied 200s — connection
        management, relay framing, reply serialization and both
        socket hops: the Python tax of the data plane."""
        with self._lock:
            vals = sorted(self._overhead)
        n = len(vals)
        if not n:
            return {"count": 0, "mean_ms": None, "p50_ms": None,
                    "p99_ms": None, "max_ms": None}
        return {
            "count": n,
            "mean_ms": round(sum(vals) / n, 3),
            "p50_ms": round(vals[int(0.50 * (n - 1))], 3),
            "p99_ms": round(vals[int(0.99 * (n - 1))], 3),
            "max_ms": round(vals[-1], 3),
        }

    # -- fleet debug surfaces (trace stitch + merged timeseries) ------------
    def trace_index(self):
        """``GET /debug/trace`` at the router: the router's own
        sampled rids plus a per-replica fan-out, each replica
        attributed by id."""
        payloads = self._up_payloads("/debug/trace")
        return {
            "enabled": reqtrace.enabled(),
            "fleet": True,
            "rids": reqtrace.rids(),
            "replicas": {
                rid: {"enabled": bool(doc.get("enabled")),
                      "rids": doc.get("rids") or []}
                for rid, doc in sorted(payloads.items())},
        }

    def stitched_trace(self, rid):
        """``GET /debug/trace/<rid>`` at the router: ``(status,
        payload)`` — the router's own tree with the serving replica's
        tree fetched over the keep-alive pool and stitched inside the
        ``replica_wait`` span (reqtrace.stitch).  An unsampled rid
        404s exactly like a replica's endpoint; a fetch failure
        degrades to the router-only tree (``stitched: false``) — a
        dead replica must not take the router's half of the story
        with it."""
        tree = reqtrace.get(rid)
        if tree is None:
            return 404, {
                "error": "no sampled trace for rid %r at the router "
                         "(sampling %s; see root.common.serving."
                         "trace_sample_n)"
                         % (rid, "on" if reqtrace.enabled()
                            else "off")}
        peer = None
        for span in reversed(tree.get("spans") or []):
            if span["kind"] == "replica_wait":
                peer = (span.get("attrs") or {}).get("replica")
                break
        replica = None
        if peer is not None:
            with self._lock:
                for r in self._replicas:
                    if r.rid == peer:
                        replica = r
                        break
        if replica is None or replica.state != UP or \
                replica.url is None:
            tree["stitched"] = False
            return 200, tree
        try:
            status, _, data = self._send_to(
                replica, "GET", "/debug/trace/" + rid, b"", {})
            peer_tree = json.loads(data) if status == 200 else None
        except (_NeverSentError, _SentUnknownError, ValueError):
            peer_tree = None
        if not peer_tree:
            tree["stitched"] = False
            return 200, tree
        if telemetry.enabled():
            telemetry.counter(telemetry.labeled(
                "router.traces_stitched", replica=peer)).inc()
        return 200, reqtrace.stitch(tree, peer_tree, replica=peer)

    def merged_timeseries(self):
        """``GET /debug/timeseries`` at the router: every replica's
        rings fanned out and TIMESTAMP-MERGED with the router's own
        (core/timeseries.py merge_snapshots) — counters/gauges sum
        step-wise, so ``rate()`` works at the front door, and each
        series carries its per-source last values for attribution."""
        payloads = self._up_payloads("/debug/timeseries")
        payloads["router"] = timeseries.snapshot()
        return timeseries.merge_snapshots(payloads)

    def merged_pyprof(self, seconds=2.0):
        """``GET /debug/pyprof`` at the router: every UP replica's
        windowed capture fanned out IN PARALLEL (a pyprof capture
        blocks for its whole window, so the sequential
        ``_up_payloads`` walk would cost replicas x seconds) and
        summed with the router's own concurrent capture into ONE
        stitched fleet flamegraph (core/pyprof.py merge_profiles) —
        per-source sample counts ride along for attribution, the PR
        16 merged-timeseries pattern one layer down."""
        payloads = {}
        merge_lock = threading.Lock()

        def fan(replica):
            try:
                raw = self._fetch(
                    replica, "/debug/pyprof?seconds=%g" % seconds,
                    timeout=seconds + 15)
                payload = json.loads(raw)
            except (_HOP_ERRORS + (ValueError,)):
                return  # fetch failures skip (monitor will eject)
            with merge_lock:
                payloads[replica.rid] = payload

        fanout = []
        for i, replica in enumerate(self.replicas()):
            if replica.state != UP:
                continue
            t = threading.Thread(
                target=fan, args=(replica,),
                name=pyprof.thread_name("router-fanout-%d" % i),
                daemon=True)
            t.start()
            fanout.append(t)
        # the router's own capture runs CONCURRENTLY with the fan-out
        # (same window) — {"enabled": False} merges as zero samples
        # when only the replica half of the fleet is armed
        own = pyprof.capture(seconds)
        for t in fanout:
            t.join(timeout=seconds + 20)
        with merge_lock:
            payloads["router"] = own
            return pyprof.merge_profiles(payloads)

    def healthz(self):
        with self._lock:
            blocks = {r.rid: r.stats() for r in self._replicas}
        up = sum(1 for b in blocks.values() if b["state"] == UP)
        payload = {
            "ready": up > 0 and not self._draining,
            "degraded": 0 < up < sum(
                1 for b in blocks.values() if b["state"] != DEAD),
            "fleet": True,
            "replicas_up": up,
            "replicas": blocks,
        }
        if self._wire is not None:
            # mirrors the replica contract: wire-aware clients
            # (loadgen --wire binary) discover the relay port here
            payload["wire_port"] = self._wire.port
        if self._draining:
            payload["draining"] = True
            return 503, payload
        return (200 if up else 503), payload

    def statusz(self):
        """Router and replica stats; ``replicas`` carries each UP
        replica's device and ``kernels`` block (its launch counters and
        the libraries it built), read from its /statusz."""
        with self._lock:
            blocks = [r.stats() for r in self._replicas]
        replicas = self._up_payloads("/statusz")
        payload = {
            "fleet": {
                "replicas": blocks,
                "up": sum(1 for b in blocks if b["state"] == UP),
                "draining": self._draining,
                "replica_argv": self._replica_argv,
            },
            "queued_rows_total": self.queued_rows_total(replicas),
            "router_overhead_ms": self.router_overhead(),
            "replicas": {
                rid: {key: doc.get(key) for key in
                      ("device", "device_name", "kernels", "queued_rows")}
                for rid, doc in sorted(replicas.items())},
        }
        if self.autoscaler is not None:
            payload["autoscaler"] = self.autoscaler.status()
        if self.release is not None:
            payload["release"] = self.release.status()
        if self._wire is not None:
            payload["wire"] = dict(self._wire_mux.stats(),
                                   port=self._wire.port)
        return payload

    def models(self):
        """One replica's /models payload (the fleet is homogeneous)
        plus the fleet block — loadgen's ``discover_models`` works
        against the router unchanged."""
        payloads = self._up_payloads("/models")
        doc = next(iter(payloads.values()), {"models": {}})
        doc["fleet"] = {"replicas_up": len(payloads)}
        return doc

    # -- the handler --------------------------------------------------------
    def make_handler(self):
        router = self

        class Handler(HandlerBase):
            owner = router

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/healthz":
                    code, payload = router.healthz()
                    self._send_json(code, payload)
                elif path == "/metrics":
                    self._send(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        router.aggregate_metrics().encode())
                elif path == "/slo":
                    self._send_json(200, router.aggregate_slo())
                elif path == "/models":
                    self._send_json(200, router.models())
                elif path == "/release":
                    router._release_get(self)
                elif path.startswith("/release/"):
                    router._release_get(self, path[len("/release/"):])
                elif path in ("/", "/statusz"):
                    self._send_json(200, router.statusz())
                elif path == "/debug/timeseries":
                    # fleet fan-out + merge — NOT the router-local
                    # rings _handle_debug would serve
                    self._send_json(200, router.merged_timeseries())
                elif path == "/debug/trace":
                    self._send_json(200, router.trace_index())
                elif path.startswith("/debug/trace/"):
                    code, payload = router.stitched_trace(
                        path[len("/debug/trace/"):])
                    self._send_json(code, payload)
                elif path == "/debug/pyprof":
                    # fleet fan-out + merge — NOT the router-local
                    # capture _handle_debug would serve
                    from urllib.parse import parse_qs
                    qs = parse_qs(self.path.partition("?")[2])
                    try:
                        seconds = float(
                            qs.get("seconds", ["2"])[0])
                    except ValueError:
                        self._send_json(400, {
                            "error": "seconds must be a number"})
                        return
                    seconds = max(0.05, min(seconds, 30.0))
                    fmt = qs.get("format", ["json"])[0]
                    try:
                        merged = router.merged_pyprof(seconds)
                    except Exception as e:  # noqa: BLE001 - to HTTP
                        self._send_json(500, {"error": repr(e)})
                        return
                    # the merged payload sums per-process collapsed
                    # stacks, so the renderers apply to it unchanged
                    if fmt == "collapsed":
                        self._send(
                            200, "text/plain; charset=utf-8",
                            (pyprof.collapsed(merged) + "\n")
                            .encode())
                    elif fmt == "speedscope":
                        self._send_json(
                            200, pyprof.speedscope(
                                merged, name="pyprof:fleet"))
                    else:
                        self._send_json(200, merged)
                elif self._handle_debug():
                    pass
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                path = self.path.partition("?")[0]
                if path == "/predict" or \
                        path.startswith("/predict/"):
                    router._proxy_predict(self, path)
                elif path == "/fleet/scale_up":
                    # operator/autoscaler surface: spawn one replica,
                    # wait it into rotation, reply with its stats
                    self._drain_body()
                    try:
                        replica = router.scale_up()
                    except Exception as e:  # noqa: BLE001 - to HTTP
                        self._send_json(500, {"error": repr(e)})
                        return
                    self._send_json(200, {"scaled_up": True,
                                          "replica": replica.stats()})
                elif path == "/fleet/retire":
                    try:
                        doc = json.loads(
                            self._read_body().decode() or "{}")
                        victim = router.retire(
                            rid=doc.get("replica"),
                            wait_s=float(doc.get("wait_s") or 30.0))
                    except ValueError as e:
                        self._send_json(400, {"error": str(e)})
                        return
                    except Exception as e:  # noqa: BLE001 - to HTTP
                        self._send_json(500, {"error": repr(e)})
                        return
                    self._send_json(200, {"retired": True,
                                          "replica": victim.stats()})
                elif path == "/reload" or \
                        path.startswith("/models/"):
                    router._admin_fanout(self, "POST", path)
                elif path.startswith("/release/"):
                    router._release_post(self, path[len("/release/"):])
                else:
                    self._drain_body()
                    self._send_json(404, {"error": "not found"})

            def do_DELETE(self):
                path = self.path.partition("?")[0]
                if path.startswith("/models/"):
                    router._admin_fanout(self, "DELETE", path)
                elif path.startswith("/release/"):
                    self._drain_body()
                    router._release_delete(self, path[len("/release/"):])
                else:
                    self._drain_body()
                    self._send_json(404, {"error": "not found"})

        return Handler


#: reason phrases for the fast relay write (the statuses a replica's
#: /predict can produce)
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}


def _relay_reply(handler, status, ctype, data, headers):
    """Write a proxied reply in ONE buffered send, bypassing
    ``send_response``'s per-reply date formatting and logging — the
    relay's reply path is as hot as its forward path.  A wire-ingest
    exchange (:class:`_RouterWireExchange`) answers a RESPONSE frame
    instead."""
    wire_reply = getattr(handler, "wire_reply", None)
    if wire_reply is not None:
        wire_reply(status, ctype, data, headers)
        return
    lines = ["HTTP/1.1 %d %s" % (status,
                                 _REASONS.get(status, "Status")),
             "Content-Type: %s" % ctype,
             "Content-Length: %d" % len(data)]
    for key, value in headers.items():
        lines.append("%s: %s" % (key, value))
    try:
        handler.wfile.write(
            ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
            + data)
    except (BrokenPipeError, ConnectionResetError):
        pass  # the client went away; nothing to tell it


#: per-series aggregation overrides for ratio-style gauges, matched
#: by sample-name prefix: summing two replicas' error budgets would
#: read 2.0 on a healthy fleet (an alert on budget < 0.5 could never
#: fire) — these take the same conservative view the /slo aggregation
#: uses: budget = fleet MIN, burn = fleet MAX
_MERGE_RULES = (
    ("znicz_slo_error_budget_remaining", min),
    ("znicz_slo_burn_rate", max),
)


def _merge_rule(name):
    for prefix, rule in _MERGE_RULES:
        if name.startswith(prefix):
            return rule
    return None  # default: sum


def _merge_prometheus(texts):
    """Merge Prometheus text expositions sample-by-sample: counters,
    histogram buckets and additive gauges SUM (fleet queue depth =
    the sum of replica queue depths); ratio gauges follow
    ``_MERGE_RULES`` (budget = min, burn = max — the conservative
    paging view, matching :meth:`FleetRouter.aggregate_slo`).
    HELP/TYPE lines come from the first exposition that carries each
    family; sample order follows first appearance."""
    meta = {}           # family -> [help line, type line]
    merged = {}         # full sample key (name{labels}) -> float
    order = []          # sample keys, first-seen order
    families = {}       # sample key -> family
    for text in texts:
        pending_help = pending_type = None
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("# HELP "):
                pending_help = line
                continue
            if line.startswith("# TYPE "):
                pending_type = line
                family = line.split()[2]
                if family not in meta:
                    meta[family] = [pending_help, pending_type]
                continue
            if line.startswith("#"):
                continue
            key, _, value = line.rpartition(" ")
            if not key:
                continue
            try:
                v = float(value)
            except ValueError:
                continue
            if key not in merged:
                merged[key] = v
                order.append(key)
                name = key.partition("{")[0]
                # histogram samples (_bucket/_sum/_count) belong to
                # the base family's HELP/TYPE block
                for suffix in ("_bucket", "_sum", "_count"):
                    if name.endswith(suffix) and \
                            name[:-len(suffix)] in meta:
                        name = name[:-len(suffix)]
                        break
                families[key] = name
            else:
                rule = _merge_rule(key.partition("{")[0])
                merged[key] = (rule(merged[key], v) if rule
                               else merged[key] + v)
    lines = []
    emitted = set()
    for key in order:
        family = families[key]
        if family not in emitted:
            emitted.add(family)
            help_line, type_line = meta.get(family, (None, None))
            if help_line:
                lines.append(help_line)
            if type_line:
                lines.append(type_line)
        v = merged[key]
        lines.append("%s %s" % (key, int(v) if v == int(v) else v))
    return "\n".join(lines)
