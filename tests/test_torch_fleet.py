"""The port's serving fleet over real processes on the CPU, mirroring
``tests/functional/test_fleet_router.py``, ``test_wire_fleet.py`` and
``test_fleet_tracing.py`` by name.

The shared fleet is the real CLI, ``python -m znicz_tpu_torch serve
m=ZIP --fleet 2 --device cpu --port 0``, on a 784-64-64-10 package (JAX's
``build_fc_package_zip``), with the SLO plane, head sampling of every
request, the time-series sampler and the blackbox armed through
``--config``.  Its tests run in file order on one worker; the ones that
change the fleet (kill, scale up, retire, SIGTERM) come last and each
first brings the fleet to the size it needs.  The fault cases spawn
fleets of their own through :class:`FleetRouter` in this process.

Replies are held to ``znicz_tpu.serving.engine.InferenceEngine`` on the
same package within ``TOL`` = 1e-5 (float32 products summed in another
order), and replicas to each other bit for bit.  Waits are for events:
a banner line, a reply, a state seen on a status surface.
"""

import http.client
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from znicz_tpu.serving import router as jax_router
from znicz_tpu.serving import wire as jax_wire
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu_torch.core import blackbox, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import reqtrace, router, server, wire
from znicz_tpu_torch.serving.router import DEAD, FleetRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")
DIMS = [784, 64, 64, 10]
MAX_BATCH = 8
TOL = 1e-5


def _synth_zip(directory):
    return build_fc_package_zip(os.path.join(directory, "synth.zip"), DIMS,
                                seed=42, scale=0.05)


def _x(seed, rows=2):
    return numpy.random.RandomState(seed).uniform(-1.0, 1.0,
                                                  (rows, DIMS[0]))


def _npy(x):
    buf = io.BytesIO()
    numpy.save(buf, numpy.asarray(x, numpy.float32))
    return buf.getvalue()


def _predict(url, x, rid=None, model="m", priority=None, timeout=60):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    if priority:
        headers["X-Priority"] = priority
    req = urllib.request.Request(
        url + "/predict/" + model,
        json.dumps({"inputs": numpy.asarray(x).tolist()}).encode(), headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _predict_npy(url, x, rid=None, model="m", timeout=60):
    headers = {"Content-Type": "application/octet-stream"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(url + "/predict/" + model, _npy(x), headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def _get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.loads(resp.read())


def _post(url, path, doc=None, timeout=120):
    req = urllib.request.Request(url + path, json.dumps(doc or {}).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _until(predicate, timeout=30.0, what="condition"):
    """Poll ``predicate`` until it holds (the state is read from a live
    surface, so there is no event to block on)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError("%s not reached within %.0f s" % (what, timeout))


def _want(package, x):
    return numpy.asarray(JaxEngine(package, max_batch=MAX_BATCH)
                         .predict(numpy.asarray(x, numpy.float32)))


class _Cli(object):
    """The ``serve --fleet`` CLI as a subprocess: the banner parsed from
    its output, which a reader thread keeps draining."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "znicz_tpu_torch", "serve"] + argv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=ENV, cwd=REPO)
        self.lines = []
        self.url = None
        self._banner = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()
        if not self._banner.wait(120) or self.url is None:
            self.stop()
            raise AssertionError("no fleet banner:\n" +
                                 "\n".join(self.lines[-30:]))

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if self.url is None and "replicas behind http://" in line:
                self.url = line.split("behind ", 1)[1].split("/ ")[0]
                self._banner.set()
        self._banner.set()

    def replicas(self, state=None):
        blocks = _get(self.url, "/statusz")["fleet"]["replicas"]
        return [b for b in blocks if state is None or b["state"] == state]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fleet")
    package = _synth_zip(str(tmp))
    bb = str(tmp / "blackbox")
    cli = _Cli(["m=" + package, "--fleet", "2", "--device", "cpu",
                "--port", "0", "--max-batch", str(MAX_BATCH),
                "--config", "common.serving.slo_enabled=True",
                # generous: a loaded test host must not burn the budget
                "--config", "common.serving.slo_ms=5000.0",
                "--config", "common.serving.trace_sample_n=1",
                "--config", "common.telemetry.timeseries.enabled=True",
                "--config", "common.telemetry.timeseries.interval_ms=100.0",
                "--config", "common.telemetry.blackbox.enabled=True",
                "--config", "common.telemetry.blackbox.dir=" + bb])
    cli.package, cli.blackbox = package, bb
    yield cli
    pids = []
    if cli.proc.poll() is None:
        pids = [b["pid"] for b in cli.replicas()]
    cli.stop()
    for pid in pids:   # a fleet that failed to drain leaves nothing
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def _ensure_two_up(cli):
    if len(cli.replicas("up")) < 2:
        assert _post(cli.url, "/fleet/scale_up")[0] == 200
    return cli.replicas("up")


# -- routing, replies, aggregation (test_fleet_router.py) ----------------------

def test_routing_balances_and_echoes_rid(fleet):
    for i in range(8):
        code, doc, headers = _predict(fleet.url, _x(i), rid="bal-%d" % i)
        assert code == 200 and headers["X-Request-Id"] == "bal-%d" % i
        assert doc["request_id"] == "bal-%d" % i
    served = [b["served"] for b in fleet.replicas("up")]
    assert len(served) == 2 and all(s > 0 for s in served), served
    for b in fleet.replicas("up"):
        block = _get(b["url"], "/statusz")
        assert block["device"] == "cpu"
        assert block["kernels"]["libraries_built"] == 0


def test_replies_bit_identical_across_replicas(fleet):
    x = _x(11, rows=3)
    want = _want(fleet.package, x)
    bodies = [_predict_npy(b["url"], x)[1] for b in fleet.replicas("up")]
    assert len(bodies) == 2 and bodies[0] == bodies[1]
    y = numpy.load(io.BytesIO(bodies[0]))
    numpy.testing.assert_allclose(y, want, rtol=0, atol=TOL)
    code, doc, _ = _predict(fleet.url, x)
    numpy.testing.assert_allclose(doc["outputs"], want, rtol=0, atol=TOL)


def test_priority_rides_through_the_router(fleet):
    assert _predict(fleet.url, _x(3), priority="high")[0] == 200
    assert _predict(fleet.url, _x(3), priority="low")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as err:
        _predict(fleet.url, _x(3), priority="urgent")
    assert err.value.code == 400
    assert "unknown priority" in json.loads(err.value.read())["error"]


def test_aggregated_surfaces_match_per_replica_sums(fleet):
    for i in range(4):
        assert _predict(fleet.url, _x(20 + i))[0] == 200
    ups = fleet.replicas("up")
    texts = []
    for b in ups:
        with urllib.request.urlopen(b["url"] + "/metrics", timeout=30) as r:
            texts.append(r.read().decode())
    assert router._merge_prometheus(texts) == \
        jax_router._merge_prometheus(texts)

    def sample(text, name):
        for line in text.splitlines():
            if line.startswith(name + " "):
                return float(line.split()[-1])
        return 0.0

    with urllib.request.urlopen(fleet.url + "/metrics", timeout=30) as r:
        merged = r.read().decode()
    # an aggregate read after the per-replica reads: no fewer batches
    assert sample(merged, "znicz_serving_batches") >= sum(
        sample(t, "znicz_serving_batches") for t in texts) > 0
    budget = sample(merged, "znicz_slo_error_budget_remaining_model_m")
    assert 0.0 < budget <= 1.0
    slo_doc = _get(fleet.url, "/slo")
    per = [_get(b["url"], "/slo")["models"]["m"] for b in ups]
    assert slo_doc["fleet"] is True
    assert slo_doc["models"]["m"]["total"] >= sum(p["total"] for p in per)
    assert slo_doc["aggregation"] == {"counts": "sum", "burn_rate": "max",
                                      "error_budget_remaining": "min"}
    health = _get(fleet.url, "/healthz")
    assert health["replicas_up"] == 2 and health["ready"] is True
    models = _get(fleet.url, "/models")
    assert models["fleet"] == {"replicas_up": 2}
    assert "m" in models["models"]
    assert _get(fleet.url, "/statusz")["queued_rows_total"] == 0


def test_admitted_oracle_visible_per_replica(fleet):
    assert _predict(fleet.url, _x(7), rid="oracle-1")[0] == 200
    admitted = [_get(b["url"], "/admitted/oracle-1")["admitted"]
                for b in fleet.replicas("up")]
    assert sorted(admitted) == [False, True]


# -- the binary relay (test_wire_fleet.py) ------------------------------------

def test_wire_ports_discovered_everywhere(fleet):
    for b in fleet.replicas("up"):
        assert b["wire_port"]
        assert _get(b["url"], "/healthz")["wire_port"] == b["wire_port"]
    router_port = _get(fleet.url, "/healthz")["wire_port"]
    assert router_port and \
        _get(fleet.url, "/statusz")["wire"]["port"] == router_port


def _wire_predict(port, x, rid, model="m", timeout=60, **meta):
    conn = wire.WireConn("127.0.0.1", port, timeout=timeout)
    try:
        return conn.request(dict({"rid": rid, "model": model}, **meta),
                            wire.npy_bytes(numpy.asarray(x, numpy.float32)),
                            timeout=timeout)
    finally:
        conn.close()


def test_replies_bit_identical_across_codecs(fleet):
    x = numpy.asarray(_x(31, rows=4), numpy.float32)
    _, doc, _ = _predict(fleet.url, x.astype(numpy.float64), rid="c-json")
    _, npy_body, _ = _predict_npy(fleet.url, x, rid="c-npy")
    kind, meta, body = _wire_predict(
        _get(fleet.url, "/healthz")["wire_port"], x, "c-wire")
    assert kind == wire.KIND_RESPONSE and meta["status"] == 200
    direct = _wire_predict(fleet.replicas("up")[0]["wire_port"], x,
                           "c-direct")
    y_json = numpy.asarray(doc["outputs"], numpy.float32)
    y_npy = numpy.load(io.BytesIO(npy_body))
    y_wire = jax_wire.parse_npy(body)
    y_direct = wire.parse_npy(direct[2])
    assert (y_json == y_npy).all() and (y_npy == y_wire).all()
    assert (y_wire == y_direct).all()
    numpy.testing.assert_allclose(y_npy, _want(fleet.package, x), rtol=0,
                                  atol=TOL)


def test_error_frames_match_the_http_payload(fleet):
    port = _get(fleet.url, "/healthz")["wire_port"]
    kind, meta, _ = _wire_predict(port, _x(1), "e-wire", model="nope")
    assert kind == wire.KIND_ERROR and meta["status"] == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _predict(fleet.url, _x(1), rid="e-http", model="nope")
    assert err.value.code == 404
    payload = json.loads(err.value.read())
    assert meta["payload"]["error"] == payload["error"]
    # a frame over the replica's 32 MB default ceiling: typed refusal
    conn = wire.WireConn("127.0.0.1", fleet.replicas("up")[0]["wire_port"])
    try:
        conn.sock.sendall(struct.pack("!2sBBII", wire.MAGIC, wire.VERSION,
                                      wire.KIND_REQUEST, 2, 40 << 20) +
                          b"{}")
        kind, meta, _ = conn.recv_frame(timeout=30)
    finally:
        conn.close()
    assert kind == wire.KIND_ERROR and meta["fatal"] is True
    assert meta["payload"]["reason"] == "oversize"


def test_statusz_mux_and_replica_codec_split(fleet):
    port = _get(fleet.url, "/healthz")["wire_port"]
    for i in range(4):   # ties rotate: both replicas take frames
        _wire_predict(port, _x(2), "s-%d" % i)
    st = _get(fleet.url, "/statusz")
    assert st["wire"]["targets"] == 2 and st["wire"]["round_trips"] > 0
    binary = 0.0
    for b in fleet.replicas("up"):
        with urllib.request.urlopen(b["url"] + "/metrics", timeout=30) as r:
            for line in r.read().decode().splitlines():
                if line.startswith(
                        "znicz_serving_codec_requests_codec_binary "):
                    binary += float(line.split()[-1])
    assert binary > 0


# -- fleet tracing (test_fleet_tracing.py) ------------------------------------

def test_stitched_tree_partitions_router_wall(fleet):
    assert _predict(fleet.url, _x(1), rid="stitch-1")[0] == 200
    tree = _get(fleet.url, "/debug/trace/stitch-1")
    assert tree["stitched"] is True and tree["origin"] == "router"
    assert tree["complete"] is True, tree["span_kinds"]
    assert tree["replica"] in {b["id"] for b in fleet.replicas("up")}
    kinds = set(tree["span_kinds"])
    assert set(reqtrace.ROUTER_REQUIRED_KINDS) <= kinds
    assert set(reqtrace.SPAN_KINDS) <= kinds and "replica" in kinds
    assert {"frame_decode", "relay_wait"} <= kinds
    ratio = tree["parts_ms"] / tree["wall_ms"]
    assert 0.9 <= ratio <= 1.05, ratio
    wait = [s for s in tree["spans"] if s["kind"] == "replica_wait"][-1]
    lo = wait["start_ms"] - 0.5
    hi = wait["start_ms"] + wait["duration_ms"] + 2.0
    rep = [s for s in tree["spans"] if s["process"] == "replica"]
    for s in rep:
        assert lo <= s["start_ms"] and \
            s["start_ms"] + s["duration_ms"] <= hi, (s, wait)
    dev = [s for s in rep if s["kind"] == "device"][0]
    disp = [s for s in rep if s["kind"] == "dispatch"][0]
    assert disp["start_ms"] - 1e-3 <= dev["start_ms"]
    assert dev["start_ms"] + dev["duration_ms"] <= \
        disp["start_ms"] + disp["duration_ms"] + 1e-3
    assert {e["pid"] for e in tree["traceEvents"] if e["ph"] == "X"} == \
        {0, 1}


def test_stitched_trace_carries_the_wire_span_kinds(fleet):
    """A request relayed over the wire stitches with both wire kinds,
    each nested where it belongs: ``frame_decode`` inside the replica's
    ``admission``, ``relay_wait`` inside the router's ``relay_reply``;
    neither joins a partition."""
    port = _get(fleet.url, "/healthz")["wire_port"]
    kind, meta, _ = _wire_predict(port, _x(4), "wire-trace-1")
    assert kind == wire.KIND_RESPONSE and meta["status"] == 200
    tree = _get(fleet.url, "/debug/trace/wire-trace-1")
    assert tree["stitched"] is True and tree["complete"] is True
    by = {}
    for s in tree["spans"]:
        by.setdefault((s["process"], s["kind"]), s)

    def inside(inner, outer):
        return (outer["start_ms"] - 1e-3 <= inner["start_ms"] and
                inner["start_ms"] + inner["duration_ms"] <=
                outer["start_ms"] + outer["duration_ms"] + 1e-3)

    assert inside(by[("replica", "frame_decode")],
                  by[("replica", "admission")])
    assert inside(by[("router", "relay_wait")],
                  by[("router", "relay_reply")])
    assert 0.9 <= tree["parts_ms"] / tree["wall_ms"] <= 1.05
    assert by[("router", "replica_wait")]["attrs"]["wire"] is True


def test_trace_index_fans_out_with_replica_attribution(fleet):
    assert _predict(fleet.url, _x(2), rid="index-1")[0] == 200
    index = _get(fleet.url, "/debug/trace")
    assert index["enabled"] is True and index["fleet"] is True
    assert "index-1" in index["rids"]
    assert set(index["replicas"]) == {b["id"] for b in fleet.replicas("up")}
    holders = [rid for rid, b in index["replicas"].items()
               if "index-1" in b["rids"]]
    assert len(holders) == 1


def test_unsampled_rid_404s_at_router(fleet):
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(fleet.url, "/debug/trace/never-sent")
    assert err.value.code == 404
    assert "trace_sample_n" in json.loads(err.value.read())["error"]


def test_router_overhead_summary_and_serving_ms_header(fleet):
    for i in range(4):
        assert _predict(fleet.url, _x(10 + i))[0] == 200
    _, _, headers = _predict(fleet.replicas("up")[0]["url"], _x(20))
    assert float(headers["X-Serving-Ms"]) > 0.0
    for surface in ("/slo", "/statusz"):
        block = _get(fleet.url, surface)["router_overhead_ms"]
        assert block["count"] >= 4, (surface, block)
        assert block["p99_ms"] >= block["p50_ms"]
        assert block["max_ms"] >= block["p99_ms"]


def test_fleet_timeseries_merges_at_the_front_door(fleet):
    for i in range(4):
        assert _predict(fleet.url, _x(50 + i))[0] == 200

    def merged_batches():
        doc = _get(fleet.url, "/debug/timeseries")
        series = doc["series"].get("serving.batches")
        if not series:
            return None
        parts = [v for v in series["sources"].values() if v is not None]
        return doc if len(parts) == 2 else None

    merged = _until(merged_batches, what="both replicas sampled")
    assert merged["merged"] is True
    assert set(merged["sources"]) == \
        {b["id"] for b in fleet.replicas("up")} | {"router"}
    batches = merged["series"]["serving.batches"]
    parts = [v for v in batches["sources"].values() if v is not None]
    assert batches["points"][-1][1] == sum(parts) > 0


def test_obs_rid_over_the_fleet_blackbox(fleet, capsys):
    """The router's and the replica's persisted trees re-stitch: the
    port's ``obs --rid`` answers JAX's ``query_rid`` on the same
    directory, and its tree has the live stitched tree's spans."""
    from znicz_tpu.core import blackbox as jax_blackbox
    assert _predict(fleet.url, _x(5), rid="obs-1")[0] == 200
    live = _get(fleet.url, "/debug/trace/obs-1")

    def persisted():
        out = blackbox.query_rid(fleet.blackbox, "obs-1")
        return out if out["stitched"] else None

    out = _until(persisted, what="both trees persisted")
    theirs = jax_blackbox.query_rid(fleet.blackbox, "obs-1")
    # ``torn`` is left out: the replicas' samplers keep appending, so a
    # read can meet a record half written
    for key in ("rid", "events", "traces", "stitched"):
        assert json.loads(json.dumps(out[key], default=str)) == \
            json.loads(json.dumps(theirs[key], default=str)), key
    stitched = out["stitched"]
    assert stitched["span_kinds"] == live["span_kinds"]
    assert stitched["wall_ms"] == live["wall_ms"]
    assert [s["kind"] for s in stitched["spans"]] == \
        [s["kind"] for s in live["spans"]]
    capsys.readouterr()
    assert blackbox.cli_main(["--dir", fleet.blackbox, "--rid", "obs-1",
                              "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["stitched"]["wall_ms"] == \
        live["wall_ms"]


def test_cli_refuses_compile_cache(tmp_path, capsys):
    """The flag is no longer refused: the port maps it to the kernels'
    build directory (``core/compile_cache.py``), so the CLI enables the
    cache at DIR and goes on to the model, here a missing one."""
    from znicz_tpu_torch.core import compile_cache
    cache = str(tmp_path / "c")
    try:
        with pytest.raises(FileNotFoundError, match="unused.zip"):
            server.main(["m=unused.zip", "--device", "cpu",
                         "--compile-cache", cache])
        assert compile_cache.active_dir() == cache
    finally:
        compile_cache.disable()
    assert "not in this slice" not in capsys.readouterr().err


def test_replica_argv_drops_the_routers_flags():
    argv = ["m=p.zip", "--fleet", "2", "--port=0", "--host", "h",
            "--device", "cpu", "--config", "a.b=1"]
    assert server.replica_argv(argv) == ["m=p.zip", "--device", "cpu",
                                         "--config", "a.b=1"]


# -- changing the fleet: kill, scale up, retire, SIGTERM ----------------------

def _refused(url):
    host, port = url.split("//", 1)[1].split(":")
    try:
        socket.create_connection((host, int(port)), timeout=5).close()
    except ConnectionRefusedError:
        return True
    return False


def test_dead_replica_ejected_and_safe_retry_on_peer(fleet):
    """SIGKILL one replica.  A request that picks it before the monitor
    ejects it either never went out (connect refused: retried on the
    peer, 200) or died on a connection the replica held (its oracle is
    gone with it: an honest 503 marked unsafe to retry) — never a
    duplicate, never a hang; once it is ejected every request is 200."""
    ups = _ensure_two_up(fleet)
    victim = ups[0]
    os.kill(victim["pid"], signal.SIGKILL)
    _until(lambda: _refused(victim["url"]), what="the victim's exit")
    for i in range(4):
        try:
            assert _predict(fleet.url, _x(300 + i))[0] == 200
        except urllib.error.HTTPError as e:
            assert e.code == 503
            assert json.loads(e.read())["retry_safe"] is False
    _until(lambda: _get(fleet.url, "/healthz")["replicas_up"] ==
           len(ups) - 1, what="the dead replica's ejection")
    dead = [b for b in fleet.replicas() if b["id"] == victim["id"]][0]
    assert dead["state"] == DEAD and dead["exit_code"] == -signal.SIGKILL
    for i in range(4):
        assert _predict(fleet.url, _x(310 + i))[0] == 200


def test_scale_up_builds_nothing_and_answers_bit_identically(fleet):
    before = {b["id"] for b in fleet.replicas("up")}
    code, doc = _post(fleet.url, "/fleet/scale_up")
    assert code == 200 and doc["scaled_up"] is True
    new = doc["replica"]
    assert new["id"] not in before and new["state"] == "up"
    assert new["startup_s"] > 0
    assert _get(new["url"], "/statusz")["kernels"]["libraries_built"] == 0
    x = _x(77, rows=2)
    peer = [b for b in fleet.replicas("up") if b["id"] != new["id"]][0]
    assert _predict_npy(new["url"], x)[1] == _predict_npy(peer["url"], x)[1]


def test_scale_down_drain_loses_zero_inflight(fleet):
    n_up = len(_ensure_two_up(fleet))
    inputs = [_x(1000 + i) for i in range(8)]
    want = [_predict(fleet.url, x)[1]["outputs"] for x in inputs]
    stop = threading.Event()
    failures, replies = [], []
    lock = threading.Lock()

    def client():
        i = 0
        while not stop.is_set():
            try:
                code, doc, _ = _predict(fleet.url, inputs[i % 8])
                with lock:
                    replies.append((i % 8, code, doc["outputs"]))
            except Exception as e:  # noqa: BLE001 - asserted below
                with lock:
                    failures.append(repr(e))
            i += 1

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    _until(lambda: len(replies) >= 8, what="traffic before the retire")
    code, doc = _post(fleet.url, "/fleet/retire", {"wait_s": 60})
    _until(lambda: len(replies) >= 8 + 20, what="traffic after the retire")
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert code == 200 and doc["retired"] is True
    assert not failures, failures[:5]
    assert all(c == 200 for _, c, _ in replies)
    # a burst coalesces requests into larger buckets, whose products
    # round differently on the CPU: held to the quiet answers within TOL
    # (bit for bit where a request is alone, as the tests above hold)
    for idx, _, outputs in replies:
        numpy.testing.assert_allclose(outputs, want[idx], rtol=0, atol=TOL)
    victim = doc["replica"]
    assert victim["exit_code"] == 0 and victim["reason"] == "retired"
    assert len(fleet.replicas("up")) == n_up - 1


def test_sigterm_drains_the_fleet_and_exits_0(fleet):
    pids = [b["pid"] for b in fleet.replicas()]
    fleet.proc.send_signal(signal.SIGTERM)
    assert fleet.proc.wait(60) == 0
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# -- fleets of their own -------------------------------------------------------

def _alive(pid):
    """Whether ``pid`` runs (a zombie that nobody reaped counts as gone)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_sigkill_of_the_cli_leaves_no_replica(tmp_path):
    cli = _Cli(["m=" + _synth_zip(str(tmp_path)), "--fleet", "2",
                "--device", "cpu", "--port", "0", "--max-batch",
                str(MAX_BATCH)])
    pids = [b["pid"] for b in cli.replicas()]
    try:
        assert len(pids) == 2 and all(_alive(pid) for pid in pids)
        cli.proc.kill()
        cli.proc.wait(30)
        _until(lambda: not any(_alive(pid) for pid in pids), timeout=60,
               what="the exit of the replicas of a SIGKILLed router")
    finally:
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


@pytest.fixture
def package(tmp_path):
    return _synth_zip(str(tmp_path))


@pytest.fixture
def router_knobs():
    saved = (root.common.serving.get("trace_sample_n", 0),
             root.common.serving.fleet.get("probe_interval_s", 1.0),
             root.common.telemetry.get("enabled"))
    reqtrace.reset()
    yield root.common.serving
    (root.common.serving.trace_sample_n,
     root.common.serving.fleet.probe_interval_s,
     root.common.telemetry.enabled) = saved
    reqtrace.reset()
    telemetry.reset()


@pytest.fixture(params=["wire", "http"])
def relay(request):
    """The router's relay to its replicas: the binary wire (the default)
    or the HTTP relay (``common.serving.wire.enabled=False`` in the
    router and in its replicas).  Yields the replicas' flags."""
    saved = root.common.serving.wire.get("enabled", True)
    root.common.serving.wire.enabled = request.param == "wire"
    yield ([] if request.param == "wire" else
           ["--config", "common.serving.wire.enabled=False"])
    root.common.serving.wire.enabled = saved


def _fleet(package, extra=(), replicas=2):
    return FleetRouter(["m=" + package, "--device", "cpu", "--max-batch",
                        str(MAX_BATCH)] + list(extra), replicas=replicas,
                       env=ENV).start()


#: the first dispatch after the four warmup buckets stalls 4 s
STALL = ["--config", "common.faults.enabled=True", "--config",
         "common.faults.rules={'serving.forward': {'kind': 'stall', "
         "'stall_ms': 4000, 'at': 5}}"]


def _victim_and_peer(rt, rid):
    def find():
        found = {}
        for r in rt.replicas():
            try:
                found[_get(r.url, "/admitted/" + rid)["admitted"]] = r
            except (OSError, ValueError):
                pass
        return found if True in found and False in found else None
    found = _until(find, what="the admission of %s" % rid)
    return found[True], found[False]


@pytest.mark.parametrize("scenario", ["kill_mid_dispatch"])
def test_kill_mid_dispatch_honest_503_no_duplicate(package, router_knobs,
                                                   relay, scenario):
    rt = _fleet(package, STALL + relay)
    url = "http://127.0.0.1:%d" % rt.port
    result = {}

    def fire():
        try:
            result["reply"] = _predict(url, _x(1), rid="victim-rid")
        except urllib.error.HTTPError as e:
            result["code"] = e.code
            result["body"] = json.loads(e.read())

    try:
        t = threading.Thread(target=fire)
        t.start()
        victim, peer = _victim_and_peer(rt, "victim-rid")
        victim.proc.kill()
        t.join(timeout=60)
        assert result.get("code") == 503, result
        assert result["body"]["retry_safe"] is False
        assert "retry unsafe" in result["body"]["error"]
        assert _get(peer.url, "/admitted/victim-rid")["admitted"] is False
        assert _predict(url, _x(2))[0] == 200
    finally:
        rt.stop()


def test_kill_mid_dispatch_over_the_wire_honest_error(package,
                                                      router_knobs):
    rt = _fleet(package, STALL)
    result = {}

    def fire():
        try:
            result["frame"] = _wire_predict(rt.wire_port, _x(1),
                                            "wire-victim")
        except Exception as e:  # noqa: BLE001 - asserted below
            result["exc"] = e

    try:
        t = threading.Thread(target=fire)
        t.start()
        victim, peer = _victim_and_peer(rt, "wire-victim")
        victim.proc.kill()
        t.join(timeout=60)
        assert "frame" in result, result.get("exc")
        kind, meta, _ = result["frame"]
        assert kind == wire.KIND_ERROR and meta["status"] == 503
        assert meta["payload"]["retry_safe"] is False
        assert "retry unsafe" in meta["payload"]["error"]
        assert _get(peer.url, "/admitted/wire-victim")["admitted"] is False
        kind, meta, _ = _wire_predict(rt.wire_port, _x(2), "wire-after")
        assert kind == wire.KIND_RESPONSE and meta["status"] == 200
    finally:
        rt.stop()


def test_retried_request_tree_shows_both_peers(package, router_knobs,
                                               relay):
    root.common.serving.trace_sample_n = 1
    root.common.serving.fleet.probe_interval_s = 60.0
    rt = _fleet(package,
                ["--config", "common.serving.trace_sample_n=1"] + relay)
    url = "http://127.0.0.1:%d" % rt.port
    try:
        victim, survivor = rt.replicas()
        victim.proc.kill()
        victim.proc.wait(timeout=30)
        victim.close_conns()
        retried = None
        for i in range(8):
            rid = "retry-%d" % i
            assert _predict(url, _x(30 + i), rid=rid)[0] == 200
            tree = _get(url, "/debug/trace/" + rid)
            if "retry" in tree["span_kinds"]:
                retried = tree
                break
        assert retried is not None
        spans = [s for s in retried["spans"] if s["kind"] == "retry"]
        assert spans[0]["attrs"]["peer"] == victim.rid
        assert spans[0]["attrs"]["reason"] == "connect_failed"
        waits = [s for s in retried["spans"] if s["kind"] == "replica_wait"]
        assert waits[-1]["attrs"]["replica"] == survivor.rid
        assert retried["replica"] == survivor.rid
        assert retried["stitched"] is True
        assert 0.9 <= retried["parts_ms"] / retried["wall_ms"] <= 1.05
    finally:
        rt.stop()


def test_http_relay_resends_a_stale_keepalive_the_oracle_cleared(
        package, router_knobs):
    """The HTTP relay to replicas without a wire listener, behind a
    router with one: replies equal the engine's in JSON, ``.npy`` and a
    frame (its body relayed as it is), and a parked keep-alive
    connection that died before the replica read from it is resent to
    the peer only once the replica's admitted-rid oracle says the rid
    never reached its batcher."""
    root.common.serving.trace_sample_n = 1
    root.common.serving.fleet.probe_interval_s = 60.0
    rt = _fleet(package, ["--config", "common.serving.trace_sample_n=1",
                          "--config", "common.serving.wire.enabled=False"])
    url = "http://127.0.0.1:%d" % rt.port
    try:
        assert rt.wire_port is not None
        assert [r.wire_port for r in rt.replicas()] == [None, None]
        x = _x(50, rows=3)
        want = _want(package, x)
        code, doc, _ = _predict(url, x, rid="http-json")
        assert code == 200
        numpy.testing.assert_allclose(doc["outputs"], want, rtol=0, atol=TOL)
        code, body, _ = _predict_npy(url, x, rid="http-npy")
        assert code == 200
        y = numpy.load(io.BytesIO(body))
        assert numpy.array_equal(y, numpy.asarray(doc["outputs"],
                                                  numpy.float32))
        kind, meta, body = _wire_predict(rt.wire_port, x, "http-frame")
        assert kind == wire.KIND_RESPONSE and meta["status"] == 200
        assert numpy.array_equal(wire.parse_npy(body), y)
        stale_on, peer = rt.replicas()
        retried = None
        for i in range(4):
            ours, theirs = socket.socketpair()
            theirs.close()
            stale_on.close_conns()
            stale_on.put_conn(router._RawConn(ours))
            rid = "stale-%d" % i
            code, doc, _ = _predict(url, x, rid=rid)
            assert code == 200
            numpy.testing.assert_allclose(doc["outputs"], want, rtol=0,
                                          atol=TOL)
            tree = _get(url, "/debug/trace/" + rid)
            if "retry" in tree["span_kinds"]:
                retried = rid, tree
                break
        assert retried is not None
        rid, tree = retried
        spans = [s for s in tree["spans"] if s["kind"] == "retry"]
        assert [(s["attrs"]["peer"], s["attrs"]["reason"]) for s in spans] \
            == [(stale_on.rid, "not_admitted")]
        assert tree["replica"] == peer.rid
        assert _get(stale_on.url, "/admitted/" + rid)["admitted"] is False
        assert _get(peer.url, "/admitted/" + rid)["admitted"] is True
    finally:
        rt.stop()


def test_disabled_default_fleet_plane_is_inert(package, router_knobs,
                                               monkeypatch):
    root.common.serving.trace_sample_n = 0

    def boom(*a, **k):
        raise AssertionError("disabled fleet tracing touched reqtrace")

    monkeypatch.setattr(reqtrace, "begin", boom)
    monkeypatch.setattr(reqtrace, "add_span", boom)
    rt = _fleet(package, replicas=1)
    url = "http://127.0.0.1:%d" % rt.port
    try:
        for i in range(3):
            assert _predict(url, _x(40 + i), rid="off-%d" % i)[0] == 200
        index = _get(url, "/debug/trace")
        assert index["enabled"] is False and index["rids"] == []
        assert not any(b["enabled"] for b in index["replicas"].values())
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(url, "/debug/trace/off-0")
        assert err.value.code == 404
        # the kernels' libraries: none built by a replica
        for b in _get(url, "/statusz")["replicas"].values():
            assert b["kernels"]["libraries_built"] == 0
    finally:
        rt.stop()


def test_zero_copy_frame_body_reaches_the_engine(package, monkeypatch):
    """With a full bucket in the engine's dtype, the array the engine's
    forward reads shares memory with the array ``parse_npy`` made over
    the frame body: zero host copies between the socket and the copy
    to the device."""
    import torch
    from znicz_tpu_torch.serving import engine as engine_mod
    from znicz_tpu_torch.serving.registry import ModelRegistry
    registry = ModelRegistry(models={"m": package}, max_batch=MAX_BATCH,
                             device="cpu")
    srv = server.ServingServer(registry=registry, port=0).start()
    try:
        captured = {}
        real_parse = wire.parse_npy

        def spy_parse(buf):
            arr = real_parse(buf)
            captured.setdefault("parsed", arr)
            return arr

        real_forward = engine_mod.forward

        def spy_forward(layers, params, x, serve_dtype="f32"):
            captured.setdefault("device_x", x)
            return real_forward(layers, params, x, serve_dtype)

        monkeypatch.setattr(wire, "parse_npy", spy_parse)
        monkeypatch.setattr(engine_mod, "forward", spy_forward)
        x = numpy.asarray(_x(77, rows=MAX_BATCH), numpy.float32)
        kind, meta, _ = _wire_predict(srv.wire_port, x, "zc-1")
        assert kind == wire.KIND_RESPONSE and meta["status"] == 200
        assert captured["parsed"].flags.writeable
        dev_x = captured["device_x"]
        assert isinstance(dev_x, torch.Tensor)
        numpy.testing.assert_array_equal(dev_x.numpy(), x)
        assert numpy.shares_memory(dev_x.numpy(), captured["parsed"]), \
            "the frame body was copied between decode and dispatch"
    finally:
        srv.stop()


# -- the health monitor under a replica dying mid-reply -----------------------

class _StubReplica(object):
    """Just enough of :class:`router.Replica` for the monitor."""

    def __init__(self):
        self.rid, self.state, self.url = "r9", router.UP, "http://x:1"
        self.wire_port, self.probe_failures, self.reason = 7, 0, None
        self.killed = 0

        class _Proc(object):
            @staticmethod
            def poll():
                return None
        self.proc = _Proc()

    def close_conns(self):
        pass

    def kill(self):
        self.killed += 1


@pytest.mark.parametrize("error", [
    http.client.IncompleteRead(b"{"), http.client.BadStatusLine(""),
    ConnectionResetError("reset"), ValueError("not json")])
def test_probe_counts_a_reply_cut_short_as_a_failure(error, monkeypatch):
    """A replica killed while it answers a probe cuts the reply short
    (``http.client`` errors that are not ``OSError``): a failure of the
    probe, never of the monitor."""
    rt = FleetRouter(["m=unused.zip"], replicas=1)
    replica = _StubReplica()
    rt._replicas.append(replica)

    def urlopen(*a, **k):
        raise error

    monkeypatch.setattr(router.urllib.request, "urlopen", urlopen)
    rt._probe(replica, max_failures=2)
    assert replica.probe_failures == 1 and replica.state == router.UP
    rt._probe(replica, max_failures=2)
    assert replica.state == DEAD and replica.reason == "unreachable"
    assert replica.killed == 1


def test_monitor_survives_a_failing_probe(monkeypatch):
    rt = FleetRouter(["m=unused.zip"], replicas=1)
    calls = []

    def probe(replica, max_failures):
        calls.append(replica.rid)
        if len(calls) == 1:
            raise RuntimeError("a probe that fails unexpectedly")
        rt._monitor_stop.set()

    monkeypatch.setattr(rt, "replicas", lambda: [_StubReplica()])
    monkeypatch.setattr(rt, "_probe", probe)
    monkeypatch.setattr(root.common.serving.fleet, "probe_interval_s", 0.01)
    rt._monitor_loop()
    assert calls == ["r9", "r9"]


# -- the metrics merge against JAX's ------------------------------------------

_TEXTS = [
    "# TYPE znicz_serving_batches counter\nznicz_serving_batches 3\n"
    "# TYPE znicz_slo_error_budget_remaining_model_m gauge\n"
    "znicz_slo_error_budget_remaining_model_m 0.75\n"
    "# TYPE znicz_slo_burn_rate_fast_model_m gauge\n"
    "znicz_slo_burn_rate_fast_model_m 2.5\n"
    "# TYPE znicz_serving_request_seconds histogram\n"
    'znicz_serving_request_seconds_bucket{le="0.001"} 1\n'
    'znicz_serving_request_seconds_bucket{le="+Inf"} 3\n'
    "znicz_serving_request_seconds_sum 0.0125\n"
    "znicz_serving_request_seconds_count 3\n",
    "# HELP znicz_serving_batches batches\n"
    "# TYPE znicz_serving_batches counter\nznicz_serving_batches 4\n"
    "znicz_slo_error_budget_remaining_model_m 0.5\n"
    "znicz_slo_burn_rate_fast_model_m 1.0\n"
    'znicz_serving_request_seconds_bucket{le="0.001"} 2\n'
    'znicz_serving_request_seconds_bucket{le="+Inf"} 2\n'
    "znicz_serving_request_seconds_sum 0.5\n"
    "znicz_serving_request_seconds_count 2\n"
    "znicz_serving_queue_depth 1.5\nnot a sample\n",
]


@pytest.mark.parametrize("texts", [_TEXTS, _TEXTS[::-1], _TEXTS[:1], []],
                         ids=["ab", "ba", "a", "none"])
def test_merge_prometheus_equals_jaxs(texts):
    mine = router._merge_prometheus(texts)
    assert mine == jax_router._merge_prometheus(texts)
    if len(texts) == 2:
        assert "znicz_serving_batches 7" in mine
        assert "znicz_slo_error_budget_remaining_model_m 0.5" in mine
        assert "znicz_slo_burn_rate_fast_model_m 2.5" in mine
