"""The port's binary relay (``znicz_tpu_torch/serving/wire.py``) held
against ``znicz_tpu/serving/wire.py``, after ``tests/unit/test_wire.py``:

* ``pack_frame`` and ``error_frame`` bytes equal JAX's, and each
  package's ``FrameReader`` decodes the other's frames (the framing
  cases run for every writer / reader pair);
* a malformed frame fails with the same typed reason in both readers,
  as early as the offending byte;
* ``parse_npy`` answers JAX's array, over the payload's own storage;
* the port's ``WireListener``, ``WireConn`` and ``WireMux`` complete
  loopback round trips — with each other and with the JAX package's
  peers — answer typed errors then close, sweep a half frame and map
  failures onto the router's retry classes.  Waits are for frames.
"""

import io
import socket
import struct
import threading
import time

import numpy
import pytest

from znicz_tpu.serving import wire as jax_wire
from znicz_tpu_torch.serving import wire

PAIRS = [(wire, wire), (wire, jax_wire), (jax_wire, wire)]
PAIR_IDS = ["port-port", "port-jax", "jax-port"]


def _frame_of(writer, reader, kind, meta, body=b""):
    r = reader.FrameReader()
    r.feed(writer.pack_frame(kind, meta, body))
    return r.next_frame()


# -- framing, byte for byte --------------------------------------------------

@pytest.mark.parametrize("kind,meta,body", [
    (1, {"rid": "r-1", "model": "m", "priority": "high",
         "timeout_ms": 250.0, "sampled": "1"}, b"\x00\x01binary\xff"),
    (2, {"rid": "r-2", "status": 200, "serving_ms": "1.250",
         "generation": "gen_1", "ctype": "application/octet-stream"},
     jax_wire.npy_bytes(numpy.arange(6.0).reshape(2, 3))),
    (2, {}, b""),
    (3, {"status": 503, "payload": {"error": "x"}}, b""),
])
def test_pack_frame_bytes_equal_jaxs(kind, meta, body):
    assert wire.pack_frame(kind, meta, body) == \
        jax_wire.pack_frame(kind, meta, body)
    assert wire.pack_frame(kind, meta, memoryview(body)) == \
        jax_wire.pack_frame(kind, meta, body)


@pytest.mark.parametrize("args,kwargs", [
    ((429, {"error": "queue full"}), {"rid": "r9", "retry_after": "1"}),
    ((400, {"error": "bad", "reason": "oversize"}), {"fatal": True}),
    ((503, {"error": "draining", "request_id": "q"}), {}),
])
def test_error_frame_bytes_equal_jaxs(args, kwargs):
    assert wire.error_frame(*args, **kwargs) == \
        jax_wire.error_frame(*args, **kwargs)


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_pack_roundtrip_meta_and_body(writer, reader):
    body = b"\x00\x01binary\xffpayload"
    kind, meta, got = _frame_of(writer, reader, wire.KIND_REQUEST,
                                {"rid": "r-1", "model": "m"}, body)
    assert kind == wire.KIND_REQUEST
    assert meta == {"rid": "r-1", "model": "m"}
    assert bytes(got) == body
    kind, meta, got = _frame_of(writer, reader, wire.KIND_RESPONSE, {})
    assert (kind, meta, bytes(got)) == (wire.KIND_RESPONSE, {}, b"")


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_reader_byte_at_a_time_and_back_to_back_frames(writer, reader):
    f1 = writer.pack_frame(wire.KIND_REQUEST, {"rid": "a"}, b"one")
    f2 = writer.pack_frame(wire.KIND_REQUEST, {"rid": "b"}, b"two")
    r = reader.FrameReader()
    for i in range(len(f1) - 1):
        r.feed(f1[i:i + 1])
        assert r.next_frame() is None
    r.feed(f1[-1:] + f2)
    kind, meta, body = r.next_frame()
    assert (kind, meta, bytes(body)) == (wire.KIND_REQUEST, {"rid": "a"},
                                         b"one")
    kind, meta, body = r.next_frame()
    assert (kind, meta, bytes(body)) == (wire.KIND_REQUEST, {"rid": "b"},
                                         b"two")
    assert r.next_frame() is None and r.pending == 0


def test_reader_body_view_survives_next_frame():
    r = wire.FrameReader()
    r.feed(wire.pack_frame(wire.KIND_REQUEST, {"rid": "a"}, b"stable"))
    _, _, body = r.next_frame()
    assert isinstance(body, memoryview) and not body.readonly
    r.feed(wire.pack_frame(wire.KIND_REQUEST, {"rid": "b"}, b"XXXXXX"))
    r.next_frame()
    assert bytes(body) == b"stable"


def _reason(mod, data, max_body=None):
    r = mod.FrameReader(max_body=max_body)
    r.feed(data)
    with pytest.raises(mod.WireProtocolError) as err:
        r.next_frame()
    return err.value.reason


@pytest.mark.parametrize("mutate,reason,early_at", [
    (lambda f: b"XY" + f[2:], "bad_magic", 2),
    (lambda f: f[:2] + b"\x63" + f[3:], "bad_version", 3),
    (lambda f: f[:3] + b"\x2a" + f[4:], "bad_kind", 4),
])
def test_reader_rejects_typed_and_early_as_jax(mutate, reason, early_at):
    bad = mutate(wire.pack_frame(wire.KIND_REQUEST, {"rid": "x"}, b"body"))
    for mod in (wire, jax_wire):
        assert _reason(mod, bad) == reason
        assert _reason(mod, bad[:early_at]) == reason


@pytest.mark.parametrize("data,max_body,reason", [
    (struct.pack("!2sBBII", wire.MAGIC, wire.VERSION, wire.KIND_REQUEST,
                 0, 1 << 30), 1 << 16, "oversize"),
    (struct.pack("!2sBBII", wire.MAGIC, wire.VERSION, wire.KIND_REQUEST,
                 (1 << 20) + 1, 0), None, "oversize"),
    (struct.pack("!2sBBII", wire.MAGIC, wire.VERSION, wire.KIND_REQUEST,
                 8, 0) + b"not json", None, "bad_meta"),
    (struct.pack("!2sBBII", wire.MAGIC, wire.VERSION, wire.KIND_REQUEST,
                 2, 0) + b"[]", None, "bad_meta"),
])
def test_reader_rejects_oversize_and_bad_meta_as_jax(data, max_body,
                                                     reason):
    assert _reason(wire, data, max_body) == reason
    assert _reason(jax_wire, data, max_body) == reason


def test_default_ceiling_refuses_a_batch_64_alexnet_frame():
    """The JAX default ceiling (32 MB, ``wire.max_frame_mb``) refuses a
    batch-64 227x227x3 float32 request (39.6 MB) from its header."""
    body_len = 64 * 227 * 227 * 3 * 4 + 128
    hdr = struct.pack("!2sBBII", wire.MAGIC, wire.VERSION,
                      wire.KIND_REQUEST, 0, body_len)
    assert wire.max_frame_bytes() == jax_wire.max_frame_bytes() == 32 << 20
    assert _reason(wire, hdr) == _reason(jax_wire, hdr) == "oversize"


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_error_frame_carries_http_equivalent_payload(writer, reader):
    frame = writer.error_frame(429, {"error": "queue full"}, rid="r9",
                               retry_after="1", fatal=False)
    r = reader.FrameReader()
    r.feed(frame)
    kind, meta, _ = r.next_frame()
    assert kind == wire.KIND_ERROR and meta["status"] == 429
    assert meta["payload"] == {"error": "queue full"}
    assert meta["rid"] == "r9" and meta["retry_after"] == "1"
    assert "fatal" not in meta


# -- the .npy codec ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i8", "|u1", ">f4"])
def test_parse_npy_equals_jaxs_over_the_payload(dtype):
    x = (numpy.random.RandomState(3).uniform(-1, 1, (4, 6)) * 100).astype(
        dtype)
    payload = wire.npy_bytes(x)
    assert payload == jax_wire.npy_bytes(x)
    arr = wire.parse_npy(payload)
    numpy.testing.assert_array_equal(arr, jax_wire.parse_npy(payload))
    assert arr.dtype == x.dtype
    assert numpy.shares_memory(arr, numpy.frombuffer(payload, numpy.uint8))


def test_parse_npy_over_memoryview_slice_and_fortran():
    x = numpy.random.RandomState(3).uniform(-1, 1, (3, 5))
    framed = b"prefix" + wire.npy_bytes(x)
    numpy.testing.assert_array_equal(
        wire.parse_npy(memoryview(framed)[6:]), x)
    f = numpy.asfortranarray(numpy.arange(12, dtype=numpy.float32)
                             .reshape(3, 4))
    buf = io.BytesIO()
    numpy.save(buf, f)
    numpy.testing.assert_array_equal(wire.parse_npy(buf.getvalue()), f)


@pytest.mark.parametrize("payload", [
    b"", b"\x93NUMPY", b"not npy at all" * 3,
    wire.npy_bytes(numpy.zeros((4, 4)))[:-7],
    wire.npy_bytes(numpy.array([object()], dtype=object)
                   .astype("U3")).replace(b"<U3", b"|O8"),
])
def test_parse_npy_rejects_malformed(payload):
    with pytest.raises(ValueError):
        wire.parse_npy(payload)
    with pytest.raises(ValueError):
        jax_wire.parse_npy(payload)


# -- the listener, the client and the mux over real sockets -------------------

def _echo(mod):
    def handler(group):
        for req in group:
            req.reply(mod.pack_frame(
                mod.KIND_RESPONSE, {"rid": req.meta.get("rid"),
                                    "status": 200}, bytes(req.body)))
    return handler


@pytest.fixture
def listener():
    lst = wire.WireListener(_echo(wire), name="test", workers=2,
                            max_body=1 << 16, read_timeout_ms=300.0).start()
    yield lst
    lst.stop()


@pytest.mark.parametrize("server_mod,client_mod",
                         [(wire, wire), (wire, jax_wire), (jax_wire, wire)],
                         ids=PAIR_IDS)
def test_listener_round_trip(server_mod, client_mod):
    lst = server_mod.WireListener(_echo(server_mod), name="rt",
                                  workers=2).start()
    try:
        conn = client_mod.WireConn("127.0.0.1", lst.port, timeout=10)
        try:
            for i in range(3):
                kind, meta, body = conn.request(
                    {"rid": "t-%d" % i}, b"payload-%d" % i, timeout=10)
                assert kind == wire.KIND_RESPONSE
                assert meta == {"rid": "t-%d" % i, "status": 200}
                assert bytes(body) == b"payload-%d" % i
        finally:
            conn.close()
    finally:
        lst.stop()


@pytest.mark.parametrize("raw,reason", [
    (b"XY" + b"\x00" * 20, "bad_magic"),
    (wire.MAGIC + b"\x63" + b"\x00" * 20, "bad_version"),
    (struct.pack("!2sBBII", wire.MAGIC, wire.VERSION, wire.KIND_REQUEST,
                 0, 1 << 30), "oversize"),
    (wire.pack_frame(wire.KIND_RESPONSE, {"rid": "x"}), "bad_kind"),
])
def test_listener_answers_typed_error_then_closes(listener, raw, reason):
    conn = wire.WireConn("127.0.0.1", listener.port, timeout=10)
    try:
        conn.sock.sendall(raw)
        kind, meta, _ = conn.recv_frame(timeout=10)
        assert kind == wire.KIND_ERROR and meta["status"] == 400
        assert meta["fatal"] is True
        assert meta["payload"]["reason"] == reason
        with pytest.raises(wire.WireDeadError):
            conn.recv_frame(timeout=10)
    finally:
        conn.close()


def test_listener_sweeps_slowloris_without_wedging(listener):
    half = wire.pack_frame(wire.KIND_REQUEST, {"rid": "slow"},
                           b"x" * 64)[:20]
    slow = wire.WireConn("127.0.0.1", listener.port, timeout=10)
    healthy = wire.WireConn("127.0.0.1", listener.port, timeout=10)
    try:
        slow.sock.sendall(half)
        deadline = time.monotonic() + 10.0
        swept = None
        while time.monotonic() < deadline and swept is None:
            kind, meta, _ = healthy.request(
                {"rid": "ok-%f" % time.monotonic()}, b"fine", timeout=10)
            assert kind == wire.KIND_RESPONSE and meta["status"] == 200
            slow.sock.settimeout(0.05)
            try:
                data = slow.sock.recv(1 << 16)
            except socket.timeout:
                continue
            if data:
                slow._reader.feed(data)
                swept = slow._reader.next_frame()
        assert swept is not None, "slowloris was never swept"
        kind, meta, _ = swept
        assert kind == wire.KIND_ERROR and meta["status"] == 408
        assert meta["payload"]["reason"] == "timeout"
    finally:
        slow.close()
        healthy.close()


def test_listener_coalesces_batched_frames():
    groups = []
    echo = _echo(wire)
    lst = wire.WireListener(lambda g: groups.append(len(g)) or echo(g),
                            name="grp", workers=2).start()
    try:
        conn = wire.WireConn("127.0.0.1", lst.port, timeout=10)
        conn.sock.sendall(b"".join(wire.pack_frame(
            wire.KIND_REQUEST, {"rid": "b-%d" % i}, b"x")
            for i in range(8)))
        seen = {conn.recv_frame(timeout=10)[1]["rid"] for _ in range(8)}
        conn.close()
        assert seen == {"b-%d" % i for i in range(8)}
        assert max(groups) > 1, groups
    finally:
        lst.stop()


@pytest.mark.parametrize("server_mod", [wire, jax_wire],
                         ids=["port", "jax"])
def test_mux_round_trip_and_stats(server_mod):
    lst = server_mod.WireListener(_echo(server_mod), name="mx",
                                  workers=4).start()
    mux = wire.WireMux(conns_per_target=2)
    try:
        results = {}

        def call(i):
            results[i] = mux.round_trip(
                "r0", ("127.0.0.1", lst.port), {"rid": "m-%d" % i},
                b"abc%d" % i, timeout=10)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        for i in range(6):
            kind, meta, body, t_frame = results[i]
            assert kind == wire.KIND_RESPONSE and meta["rid"] == "m-%d" % i
            assert bytes(body) == b"abc%d" % i
            assert t_frame <= time.monotonic()
        st = mux.stats()
        assert st["targets"] == 1 and st["round_trips"] == 6
        # concurrent first calls each connect (outside the mux's lock,
        # as in JAX); later calls reuse the parked connections
        assert st["in_flight"] == 0 and 1 <= st["conns"] <= 6
    finally:
        mux.stop()
        lst.stop()


def test_mux_connect_failure_is_never_sent_class():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    mux = wire.WireMux()
    try:
        with pytest.raises(wire.WireConnectError):
            mux.round_trip("gone", ("127.0.0.1", dead_port),
                           {"rid": "m-2"}, b"", timeout=5)
    finally:
        mux.stop()


def test_mux_dead_connection_fails_parked_waiters():
    admitted = threading.Event()
    sink = wire.WireListener(lambda group: admitted.set(),  # no reply
                             name="sink", workers=1).start()
    mux = wire.WireMux(conns_per_target=1)
    errors = []

    def call():
        try:
            mux.round_trip("s0", ("127.0.0.1", sink.port), {"rid": "m-3"},
                           b"", timeout=30)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    t = threading.Thread(target=call)
    t.start()
    try:
        assert admitted.wait(10)
        assert mux.stats()["in_flight"] == 1
        mux.drop("s0")
        t.join(timeout=10)
        assert not t.is_alive()
        assert len(errors) == 1 and isinstance(errors[0], wire.WireDeadError)
    finally:
        mux.stop()
        sink.stop()


def test_mux_timeout_is_its_own_class():
    sink = wire.WireListener(lambda group: None, name="mute",
                             workers=1).start()
    mux = wire.WireMux()
    try:
        with pytest.raises(wire.WireTimeoutError):
            mux.round_trip("t0", ("127.0.0.1", sink.port), {"rid": "m-4"},
                           b"", timeout=0.2)
    finally:
        mux.stop()
        sink.stop()


def test_mux_requires_a_rid():
    mux = wire.WireMux()
    try:
        with pytest.raises(ValueError):
            mux.round_trip("k", ("127.0.0.1", 1), {}, b"")
    finally:
        mux.stop()
