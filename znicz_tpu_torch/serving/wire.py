"""The fleet's binary data plane: a persistent, length-prefixed framed
protocol between the router and its replicas.

Counterpart of ``znicz_tpu/serving/wire.py``; its frames are byte for
byte the JAX package's, so either package's reader decodes the other's
frames.  Frame layout (integers big-endian)::

    offset  size  field
    0       2     magic  b"zW"
    2       1     version (currently 1)
    3       1     kind    (1=REQUEST, 2=RESPONSE, 3=ERROR)
    4       4     meta_len  (u32, compact-JSON metadata)
    8       4     body_len  (u32, raw ``.npy`` bytes, may be 0)
    12      ...   meta, then body

REQUEST meta carries ``rid`` / ``model`` / ``priority`` /
``timeout_ms`` / ``sampled`` / ``reply``; the body is the request's
``.npy`` bytes, encoded once by the client and never re-encoded at a
hop.  RESPONSE mirrors it (``rid`` / ``status`` / ``serving_ms`` /
``generation`` + an ``.npy`` body); ERROR frames carry the
HTTP-equivalent ``status`` and the JSON ``payload`` the HTTP surface
would have answered.  ``rid`` is the multiplexing key: the router keeps
N persistent connections per replica and matches responses to waiters
by rid on one :mod:`selectors` loop (:class:`WireMux`).

Ingest without a copy: :func:`parse_npy` gives ``numpy.frombuffer``
over the frame body's :class:`memoryview`, a writable view of the
reader's own buffer, and the replica hands that array to batch
admission; the engine's ``torch.from_numpy`` shares it, so the bytes
the socket delivered are the bytes the host-to-device copy reads.

A malformed frame (``bad_magic`` / ``bad_version`` / ``bad_kind`` /
``oversize`` / ``bad_meta``) is answered with a typed ERROR frame before
the connection closes, and a half-frame connection idle past
``read_timeout_ms`` is swept with a 408 without wedging the loop.
Knobs: ``root.common.serving.wire`` (``enabled``, ``conns_per_replica``,
``max_frame_mb``, ``read_timeout_ms``, ``workers``).
"""

import ast
import io
import json
import select
import selectors
import socket
import struct
import threading
import time

import numpy

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger

#: frame header: magic + version + kind + meta_len + body_len
MAGIC = b"zW"
VERSION = 1
_HDR = struct.Struct("!2sBBII")

telemetry.register_help(
    "wire", "binary framed relay (serving/wire.py): frames/bytes in "
            "and out, protocol errors answered as typed error "
            "frames, slowloris sweeps, mux round-trips and dead "
            "connections")

KIND_REQUEST, KIND_RESPONSE, KIND_ERROR = 1, 2, 3
_KINDS = frozenset((KIND_REQUEST, KIND_RESPONSE, KIND_ERROR))

#: metadata is small JSON — a corrupt length field must not buffer
#: gigabytes before the oversize check fires
_MAX_META = 1 << 20

_RECV_CHUNK = 1 << 18


def _wire_cfg():
    return root.common.serving.get("wire", {})


def max_frame_bytes():
    """The configured frame-body ceiling (bytes)."""
    return int(float(_wire_cfg().get("max_frame_mb", 32.0)) * (1 << 20))


class WireProtocolError(Exception):
    """A malformed frame.  ``reason`` is the typed classification the
    peer receives in the ERROR frame: ``bad_magic`` / ``bad_version``
    / ``bad_kind`` / ``oversize`` / ``bad_meta``."""

    def __init__(self, reason, detail=""):
        self.reason = reason
        super(WireProtocolError, self).__init__(
            "%s%s" % (reason, ": " + detail if detail else ""))


class WireConnectError(Exception):
    """The connect failed before one request byte went out — a resend
    is safe by construction (maps to the router's never-sent class)."""


class WireDeadError(Exception):
    """The connection died after (part of) a request may have gone
    out — only the admitted-rid oracle can clear a resend, and its
    answer is final (the peer can never read a request off a dead
    socket)."""


class WireTimeoutError(Exception):
    """No response frame within the deadline and the connection is
    still alive — the request may yet be read and dispatched, so the
    oracle CANNOT clear a resend (the router's timed-out class)."""


def pack_frame(kind, meta, body=b""):
    """Serialize one frame.  ``meta`` is a small dict (compact JSON);
    ``body`` is raw bytes (typically ``.npy``)."""
    mbytes = json.dumps(meta, separators=(",", ":")).encode() \
        if meta else b""
    return b"".join((
        _HDR.pack(MAGIC, VERSION, kind, len(mbytes), len(body)),
        mbytes, bytes(body) if isinstance(body, memoryview) else body))


class FrameReader(object):
    """Incremental frame decoder: :meth:`feed` bytes as they arrive,
    :meth:`next_frame` yields ``(kind, meta, body)`` with ``body`` a
    zero-copy :class:`memoryview` over the frame's own storage
    (detached from the accumulation buffer, so it stays valid while
    the reader keeps consuming).  Violations raise
    :class:`WireProtocolError` as EARLY as the bytes allow — a bad
    magic fails on byte 2, not after a length's worth of garbage."""

    __slots__ = ("_buf", "max_body")

    def __init__(self, max_body=None):
        self._buf = bytearray()
        self.max_body = (max_frame_bytes() if max_body is None
                         else int(max_body))

    @property
    def pending(self):
        """Bytes buffered toward an incomplete frame (the slowloris
        sweep's evidence)."""
        return len(self._buf)

    def feed(self, data):
        self._buf += data

    def next_frame(self):
        buf = self._buf
        n = len(buf)
        if n >= 1 and buf[0] != MAGIC[0] or n >= 2 and buf[1] != MAGIC[1]:
            raise WireProtocolError(
                "bad_magic", repr(bytes(buf[:2])))
        if n >= 3 and buf[2] != VERSION:
            raise WireProtocolError(
                "bad_version", "got %d, speak %d" % (buf[2], VERSION))
        if n >= 4 and buf[3] not in _KINDS:
            raise WireProtocolError("bad_kind", "kind %d" % buf[3])
        if n < _HDR.size:
            return None
        _, _, kind, meta_len, body_len = _HDR.unpack_from(buf)
        if meta_len > _MAX_META or body_len > self.max_body:
            raise WireProtocolError(
                "oversize", "meta %d / body %d bytes (body ceiling "
                            "%d)" % (meta_len, body_len, self.max_body))
        total = _HDR.size + meta_len + body_len
        if n < total:
            return None
        # detach this frame's storage from the accumulation buffer:
        # the returned body view must stay valid (and zero-copy) while
        # the reader buffers the next frame
        self._buf = (bytearray(memoryview(buf)[total:]) if n > total
                     else bytearray())
        mv = memoryview(buf)
        try:
            meta = (json.loads(bytes(mv[_HDR.size:_HDR.size + meta_len]))
                    if meta_len else {})
            if not isinstance(meta, dict):
                raise ValueError("meta is not an object")
        except ValueError as e:
            raise WireProtocolError("bad_meta", str(e))
        return kind, meta, mv[_HDR.size + meta_len:total]


def parse_npy(buf):
    """A ``.npy`` payload materialized ZERO-COPY over ``buf`` — the
    returned array is ``numpy.frombuffer`` at the payload offset, so
    its storage IS the wire frame's storage (no ``io.BytesIO``, no
    ``numpy.load`` copy).  Raises :class:`ValueError` on anything
    that is not a plain v1/v2 ``.npy`` of a non-object dtype."""
    mv = memoryview(buf)
    if len(mv) < 10 or bytes(mv[:6]) != b"\x93NUMPY":
        raise ValueError("not a .npy payload")
    major = mv[6]
    if major == 1:
        hlen, off = struct.unpack_from("<H", mv, 8)[0], 10
    elif major in (2, 3):
        hlen, off = struct.unpack_from("<I", mv, 8)[0], 12
    else:
        raise ValueError("unsupported .npy major version %d" % major)
    if len(mv) < off + hlen:
        raise ValueError("truncated .npy header")
    try:
        hdr = ast.literal_eval(
            bytes(mv[off:off + hlen]).decode("latin1"))
        dtype = numpy.dtype(hdr["descr"])
        shape = tuple(hdr["shape"])
        fortran = bool(hdr.get("fortran_order"))
    except (ValueError, SyntaxError, KeyError, TypeError) as e:
        raise ValueError("malformed .npy header: %s" % e)
    if dtype.hasobject:
        raise ValueError("object arrays are not servable")
    count = 1
    for dim in shape:
        count *= int(dim)
    start = off + hlen
    if len(mv) - start < count * dtype.itemsize:
        raise ValueError("truncated .npy data")
    arr = numpy.frombuffer(mv, dtype=dtype, count=count, offset=start)
    return arr.reshape(shape, order="F" if fortran else "C")


def npy_bytes(arr):
    """Encode ``arr`` as ``.npy`` bytes (the frame-body codec)."""
    buf = io.BytesIO()
    numpy.save(buf, numpy.ascontiguousarray(arr))
    return buf.getvalue()


def _sendall_nb(sock, data, timeout=30.0):
    """``sendall`` for a non-blocking socket owned by an event loop:
    worker threads write under the channel's send lock, parking on
    ``select`` when the kernel buffer is full."""
    mv = memoryview(data)
    deadline = time.monotonic() + timeout
    while mv.nbytes:
        try:
            mv = mv[sock.send(mv):]
        except (BlockingIOError, InterruptedError):
            wait = deadline - time.monotonic()
            if wait <= 0:
                raise OSError("send stalled for %.0f s" % timeout)
            select.select((), (sock,), (), min(wait, 1.0))


class _Channel(object):
    """One accepted connection on a :class:`WireListener`."""

    __slots__ = ("sock", "reader", "last_recv", "send_lock", "open")

    def __init__(self, sock, max_body):
        self.sock = sock
        self.reader = FrameReader(max_body)
        self.last_recv = time.monotonic()
        self.send_lock = threading.Lock()
        self.open = True

    def send_frame(self, frame):
        """Thread-safe frame write (workers reply out of order)."""
        with self.send_lock:
            if not self.open:
                raise OSError("channel closed")
            _sendall_nb(self.sock, frame)
        if telemetry.enabled():
            telemetry.counter("wire.frames_out").inc()


class WireRequest(object):
    """One REQUEST frame as handed to the listener's handler.
    ``t_recv`` stamps when the frame's bytes completed on the loop;
    ``reply(frame)`` writes back on the originating connection."""

    __slots__ = ("channel", "meta", "body", "t_recv")

    def __init__(self, channel, meta, body, t_recv):
        self.channel = channel
        self.meta = meta
        self.body = body
        self.t_recv = t_recv

    def reply(self, frame):
        try:
            self.channel.send_frame(frame)
            return True
        except OSError:
            return False  # client went away; nothing to answer


def error_frame(status, payload, rid=None, retry_after=None,
                fatal=False):
    """The typed ERROR frame — ``payload`` is the JSON object the
    HTTP surface would have answered with this ``status``; ``fatal``
    marks a protocol-level failure after which the sender closes the
    connection."""
    meta = {"status": int(status), "payload": payload}
    if rid:
        meta["rid"] = rid
    if retry_after is not None:
        meta["retry_after"] = retry_after
    if fatal:
        meta["fatal"] = True
    return pack_frame(KIND_ERROR, meta)


class WireListener(Logger):
    """The framed-relay listener: a ``selectors`` event loop accepting
    persistent connections, draining complete REQUEST frames per
    readable pass and handing each drained GROUP to ``handler(reqs)``
    on a worker thread (the coalesced frame decode).  Protocol
    violations answer a typed ERROR frame, then close; half-frame
    connections idle past ``read_timeout_ms`` are swept with a 408
    ERROR frame — the loop itself never blocks on a client."""

    def __init__(self, handler, host="127.0.0.1", port=0, name="wire",
                 workers=None, max_body=None, read_timeout_ms=None):
        super(WireListener, self).__init__()
        cfg = _wire_cfg()
        self._handler = handler
        self._host = host
        self._want_port = port
        self._name = name
        self._workers = int(workers if workers is not None
                            else cfg.get("workers", 16))
        self._max_body = (max_frame_bytes() if max_body is None
                          else int(max_body))
        self._read_timeout = float(
            read_timeout_ms if read_timeout_ms is not None
            else cfg.get("read_timeout_ms", 10000.0)) / 1e3
        self.port = None
        self._sock = None
        self._sel = None
        self._pool = None
        self._thread = None
        self._running = False
        self._channels = set()
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        from concurrent.futures import ThreadPoolExecutor
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._want_port))
        self._sock.listen(128)
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, None)
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers,
            thread_name_prefix="znicz:wire-%s" % self._name)
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="znicz:wire-listener-%s" % self._name,
            daemon=True)
        self._thread.start()
        self.debug("wire listener %s on %s:%d", self._name, self._host,
                   self.port)
        return self

    def stop(self):
        if not self._running:
            return
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
        # the graceful-drain contract: every handler already holding
        # a request gets to WRITE its reply before any channel closes
        # (a drained replica's flushed answers must reach the router;
        # bounded so a wedged handler cannot hang shutdown forever)
        with self._inflight_cv:
            self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout=30)
        for ch in list(self._channels):
            self._close_channel(ch)
        try:
            self._sel.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)

    def submit(self, fn, *args):
        """Run work on the listener's worker pool (the server glue
        fans a coalesced group's tail out here).  Tracked: stop()
        waits for every submitted job to finish writing its reply
        before closing channels."""
        with self._inflight_cv:
            self._inflight += 1
        return self._pool.submit(self._tracked, fn, *args)

    def _tracked(self, fn, *args):
        try:
            fn(*args)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    # -- the event loop -----------------------------------------------------
    def _loop(self):
        last_sweep = time.monotonic()
        while self._running:
            try:
                events = self._sel.select(timeout=0.25)
            except OSError:
                return
            now = time.monotonic()
            for key, _ in events:
                if key.data is None:
                    self._accept()
                else:
                    self._readable(key.data, now)
            if now - last_sweep >= 1.0:
                last_sweep = now
                self._sweep(now)

    def _accept(self):
        while True:
            try:
                sock, _ = self._sock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            ch = _Channel(sock, self._max_body)
            self._channels.add(ch)
            self._sel.register(sock, selectors.EVENT_READ, ch)

    def _readable(self, ch, now):
        chunks = []
        while True:
            try:
                data = ch.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_channel(ch)
                return
            if not data:
                if not chunks:
                    self._close_channel(ch)
                    return
                break
            chunks.append(data)
            if len(data) < _RECV_CHUNK:
                break
        if not chunks:
            return
        ch.last_recv = now
        ch.reader.feed(b"".join(chunks) if len(chunks) > 1
                       else chunks[0])
        if telemetry.enabled():
            telemetry.counter("wire.bytes_in").inc(
                sum(len(c) for c in chunks))
        # drain EVERY complete frame this pass — the whole group goes
        # to the handler at once (coalesced decode for queued
        # same-lane requests, mirroring batch admission downstream)
        group = []
        while True:
            try:
                frame = ch.reader.next_frame()
            except WireProtocolError as e:
                if telemetry.enabled():
                    telemetry.counter("wire.protocol_errors").inc()
                self.warning("wire %s: protocol error from peer: %s",
                             self._name, e)
                self._hangup(ch, 400, {"error": str(e),
                                       "reason": e.reason})
                break
            if frame is None:
                break
            kind, meta, body = frame
            if kind != KIND_REQUEST:
                if telemetry.enabled():
                    telemetry.counter("wire.protocol_errors").inc()
                self._hangup(ch, 400, {
                    "error": "a listener only accepts REQUEST "
                             "frames, got kind %d" % kind,
                    "reason": "bad_kind"})
                group = []
                break
            group.append(WireRequest(ch, meta, body, now))
        if group:
            if telemetry.enabled():
                telemetry.counter("wire.frames_in").inc(len(group))
            self.submit(self._dispatch, group)

    def _dispatch(self, group):
        try:
            self._handler(group)
        except Exception:  # noqa: BLE001 - a worker must never die
            self.exception("wire %s: handler failed", self._name)
            for req in group:
                req.reply(error_frame(
                    500, {"error": "internal relay error"},
                    rid=req.meta.get("rid")))

    def _sweep(self, now):
        """Slowloris: a connection parked mid-frame past the read
        timeout is answered 408 and closed; idle KEEP-ALIVE
        connections (no partial frame) live forever."""
        for ch in list(self._channels):
            if ch.reader.pending and \
                    now - ch.last_recv > self._read_timeout:
                if telemetry.enabled():
                    telemetry.counter("wire.timeouts").inc()
                self.warning(
                    "wire %s: sweeping half-frame connection (%d "
                    "bytes buffered, idle %.1f s)", self._name,
                    ch.reader.pending, now - ch.last_recv)
                self._hangup(ch, 408, {
                    "error": "half frame idle past read_timeout_ms",
                    "reason": "timeout"})

    def _hangup(self, ch, status, payload):
        try:
            ch.send_frame(error_frame(status, payload, fatal=True))
        except OSError:
            pass
        self._close_channel(ch)

    def _close_channel(self, ch):
        ch.open = False
        self._channels.discard(ch)
        try:
            self._sel.unregister(ch.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            ch.sock.close()
        except OSError:
            pass


class WireConn(object):
    """A blocking lock-step client connection (loadgen, tests, the
    smoke): one request in flight, the next frame is the reply."""

    def __init__(self, host, port, timeout=30.0, max_body=None):
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
        except OSError as e:
            raise WireConnectError(str(e))
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._reader = FrameReader(max_body)

    def request(self, meta, body=b"", timeout=30.0):
        """One round-trip; returns ``(kind, meta, body)``."""
        self.sock.settimeout(timeout)
        try:
            self.sock.sendall(pack_frame(KIND_REQUEST, meta, body))
        except OSError as e:
            raise WireDeadError("send failed: %s" % e)
        return self.recv_frame(timeout)

    def recv_frame(self, timeout=30.0):
        deadline = time.monotonic() + timeout
        while True:
            frame = self._reader.next_frame()
            if frame is not None:
                return frame
            wait = deadline - time.monotonic()
            if wait <= 0:
                raise WireTimeoutError(
                    "no frame within %.1f s" % timeout)
            self.sock.settimeout(wait)
            try:
                data = self.sock.recv(_RECV_CHUNK)
            except socket.timeout:
                raise WireTimeoutError(
                    "no frame within %.1f s" % timeout)
            except OSError as e:
                raise WireDeadError(str(e))
            if not data:
                raise WireDeadError("peer closed the connection")
            self._reader.feed(data)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class _MuxConn(object):
    """One persistent multiplexed connection to a target."""

    __slots__ = ("sock", "reader", "pending", "send_lock", "open",
                 "key")

    def __init__(self, sock, max_body, key):
        self.sock = sock
        self.reader = FrameReader(max_body)
        self.pending = {}  # rid -> _Waiter (guarded by the mux lock)
        self.send_lock = threading.Lock()
        self.open = True
        self.key = key


class _Waiter(object):
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None

    def resolve(self, result):
        self.result = result
        self.event.set()

    def fail(self, exc):
        self.error = exc
        self.event.set()


class WireMux(Logger):
    """The router's side of the relay: N persistent connections per
    target, responses matched to waiting relay threads by rid on ONE
    ``selectors`` read loop.  Failure classes map onto the router's
    retry-safety taxonomy: a connect failure raises
    :class:`WireConnectError` (never sent — resend safe), a dead
    connection fails every rid parked on it with
    :class:`WireDeadError` (oracle's answer is final), and a waiter
    deadline raises :class:`WireTimeoutError` (connection may still
    be alive — the oracle cannot clear a resend)."""

    def __init__(self, conns_per_target=None, max_body=None,
                 connect_timeout=10.0):
        super(WireMux, self).__init__()
        cfg = _wire_cfg()
        self._per_target = int(
            conns_per_target if conns_per_target is not None
            else cfg.get("conns_per_replica", 2))
        self._max_body = (max_frame_bytes() if max_body is None
                          else int(max_body))
        self._connect_timeout = float(connect_timeout)
        self._lock = threading.Lock()
        self._targets = {}  # key -> {"addr": (h, p), "conns": [], "rr": n}
        self._sel = selectors.DefaultSelector()
        self._running = True
        self._round_trips = 0
        self._thread = threading.Thread(
            target=self._loop, name="znicz:wire-mux", daemon=True)
        self._thread.start()

    # -- public surface -----------------------------------------------------
    def round_trip(self, key, addr, meta, body=b"", timeout=30.0,
                   timing=None):
        """Send one REQUEST frame to ``key`` (connecting ``addr`` as
        needed) and block until its rid's response frame arrives.
        Returns ``(kind, meta, body, t_frame)`` where ``t_frame``
        stamps the loop's frame-completion instant (the hop's first
        byte / the ``relay_wait`` span's start).  ``timing``, when a
        dict, gains ``t_acquire`` / ``t_sent`` stamps for the
        router's hop spans."""
        rid = meta.get("rid")
        if not rid:
            raise ValueError("wire mux requests require a rid")
        conn = self._acquire(key, addr)
        if timing is not None:
            timing["t_acquire"] = time.monotonic()
        waiter = _Waiter()
        with self._lock:
            if not conn.open:
                raise WireDeadError("connection died before send")
            conn.pending[rid] = waiter
        frame = pack_frame(KIND_REQUEST, meta, body)
        if timing is not None:
            # stamped BEFORE the write: between a returned syscall
            # and its next bytecode this worker can be parked for
            # milliseconds (GIL), which would bill the replica's
            # whole turnaround to relay_send and collapse the
            # replica_wait window the stitch aligns into.  The
            # pre-stamp keeps t_sent <= the replica's frame receipt;
            # the loopback write itself is microseconds and lands in
            # replica_wait.
            timing["t_sent"] = time.monotonic()
        try:
            with conn.send_lock:
                _sendall_nb(conn.sock, frame, timeout=timeout)
        except OSError as e:
            # bytes may have partially gone out — sent-unknown class;
            # the dead connection also frees every other parked rid
            self._kill_conn(conn, "send failed: %s" % e)
            raise WireDeadError("send failed: %s" % e)
        if telemetry.enabled():
            telemetry.counter("wire.round_trips").inc()
        if not waiter.event.wait(timeout):
            with self._lock:
                conn.pending.pop(rid, None)
            if telemetry.enabled():
                telemetry.counter("wire.mux_timeouts").inc()
            raise WireTimeoutError(
                "no response frame for rid %s within %.1f s"
                % (rid, timeout))
        if waiter.error is not None:
            raise waiter.error
        return waiter.result

    def drop(self, key):
        """Forget a target (replica ejected/retired): close its
        connections; parked rids fail as dead-connection class."""
        with self._lock:
            target = self._targets.pop(key, None)
            conns = list(target["conns"]) if target else []
        for conn in conns:
            self._kill_conn(conn, "target %s dropped" % (key,))

    def stats(self):
        with self._lock:
            conns = sum(len(t["conns"]) for t in
                        self._targets.values())
            inflight = sum(
                len(c.pending) for t in self._targets.values()
                for c in t["conns"])
            return {"targets": len(self._targets), "conns": conns,
                    "in_flight": inflight,
                    "round_trips": self._round_trips}

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            conns = [c for t in self._targets.values()
                     for c in t["conns"]]
            self._targets.clear()
        for conn in conns:
            self._kill_conn(conn, "mux stopped")
        try:
            self._sel.close()
        except OSError:
            pass

    # -- connection management ----------------------------------------------
    def _acquire(self, key, addr):
        with self._lock:
            target = self._targets.get(key)
            if target is None:
                target = self._targets[key] = {
                    "addr": addr, "conns": [], "rr": 0}
            target["conns"] = [c for c in target["conns"] if c.open]
            if len(target["conns"]) >= self._per_target:
                target["rr"] += 1
                return target["conns"][target["rr"]
                                       % len(target["conns"])]
        # connect OUTSIDE the lock (blocking), then register
        try:
            sock = socket.create_connection(
                addr, timeout=self._connect_timeout)
        except OSError as e:
            if telemetry.enabled():
                telemetry.counter("wire.conn_failures").inc()
            raise WireConnectError("connect %s:%d failed: %s"
                                   % (addr[0], addr[1], e))
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        sock.setblocking(False)
        conn = _MuxConn(sock, self._max_body, key)
        with self._lock:
            target = self._targets.setdefault(
                key, {"addr": addr, "conns": [], "rr": 0})
            target["conns"].append(conn)
        self._sel.register(sock, selectors.EVENT_READ, conn)
        return conn

    def _kill_conn(self, conn, why):
        with self._lock:
            if not conn.open:
                return
            conn.open = False
            pending, conn.pending = dict(conn.pending), {}
            target = self._targets.get(conn.key)
            if target is not None and conn in target["conns"]:
                target["conns"].remove(conn)
        if pending and telemetry.enabled():
            telemetry.counter("wire.dead_conns").inc()
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        for waiter in pending.values():
            waiter.fail(WireDeadError(why))

    # -- the read loop ------------------------------------------------------
    def _loop(self):
        while self._running:
            try:
                events = self._sel.select(timeout=0.25)
            except OSError:
                return
            now = time.monotonic()
            for key, _ in events:
                self._readable(key.data, now)

    def _readable(self, conn, now):
        chunks = []
        while True:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self._kill_conn(conn, "recv failed: %s" % e)
                return
            if not data:
                if not chunks:
                    self._kill_conn(conn, "peer closed the connection")
                    return
                break
            chunks.append(data)
            if len(data) < _RECV_CHUNK:
                break
        if not chunks:
            return
        conn.reader.feed(b"".join(chunks) if len(chunks) > 1
                         else chunks[0])
        while True:
            try:
                frame = conn.reader.next_frame()
            except WireProtocolError as e:
                if telemetry.enabled():
                    telemetry.counter("wire.protocol_errors").inc()
                self._kill_conn(conn, "protocol error: %s" % e)
                return
            if frame is None:
                return
            kind, meta, body = frame
            rid = meta.get("rid")
            if rid is None or meta.get("fatal"):
                # a protocol-level ERROR frame poisons the connection
                self._kill_conn(
                    conn, "peer error frame: %s"
                          % (meta.get("payload") or meta))
                return
            with self._lock:
                waiter = conn.pending.pop(rid, None)
                self._round_trips += 1
            if waiter is not None:
                waiter.resolve((kind, meta, body, now))
