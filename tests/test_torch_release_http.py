"""The port's release plane over real HTTP on the CPU, mirroring
``tests/functional/test_release_http.py``: the ``POST /release/<model>``
loop on a registry server (shadow, canary, promote; 409s on racing
mutations; the candidate-gone fallback; the error surface), then across
the real ``serve m=ZIP --fleet 2 --autoscale --device cpu`` CLI: a
promote, an operator abort in a canary storm with every request
answered 200 and each rid admitted by exactly one replica (the
admitted-rid oracle: no duplicate dispatch), and the fleet's error
surface.

Every test runs under its own deadline (``SIGALRM``), every HTTP call
has a timeout, and nothing sleeps to wait for a state: the in-process
cases tick the controller by hand (its loop parked), the fleet cases
drive real traffic until the release's state is read.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy
import pytest

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving.registry import ModelRegistry
from znicz_tpu_torch.serving.release import (ABORTED, CANARY, FAILED,
                                             PROMOTED, ROLLED_BACK, SHADOW,
                                             split_point)
from znicz_tpu_torch.serving.server import ServingServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")
N_IN, N_OUT = 6, 3
#: green windows of zero: a manual tick advances at once
FAST = {"green_window_s": 0.0, "min_requests": 1,
        "shadow_min_compares": 2, "canary_steps": [100.0]}


@pytest.fixture(autouse=True)
def _deadline(request):
    """The test's own time limit: SIGALRM raises in it when it runs
    over (the fleet tests get more: their replicas start)."""
    seconds = 240 if "fleet" in request.fixturenames or \
        "fleet" in request.node.name else 60

    def over(signum, frame):
        raise TimeoutError("%s ran over its %d s"
                           % (request.node.name, seconds))
    old = signal.signal(signal.SIGALRM, over)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _zip(directory, name, seed):
    return build_fc_package_zip(os.path.join(str(directory), name),
                                [N_IN, 8, N_OUT], seed=seed)


def _request(url, doc=None, method=None, timeout=60):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(
        url, data, {"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _predict(url, x, rid=None, model="m", timeout=60):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        url + "/predict/" + model,
        json.dumps({"inputs": numpy.asarray(x).tolist()}).encode(), headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _x(seed, rows=2):
    return numpy.random.RandomState(seed).uniform(-1.0, 1.0, (rows, N_IN))


# -- a registry server in this process ----------------------------------------

def _mirrors(ctl, n):
    """An event set once ``n`` live replies were offered to the shadow
    mirror (the server mirrors after the reply is written, so a client
    can read its reply first)."""
    done, calls = threading.Event(), []
    mirror = ctl.mirror

    def counted(*args, **kwargs):
        queued = mirror(*args, **kwargs)
        calls.append(queued)
        if len(calls) >= n:
            done.set()
        return queued
    ctl.mirror = counted
    return done


@pytest.fixture
def served(tmp_path, monkeypatch):
    monkeypatch.setattr(root.common.serving, "slo_enabled", True)
    monkeypatch.setattr(root.common.telemetry, "enabled", True)
    # the loop parked: the tests tick by hand
    monkeypatch.setattr(root.common.serving.release, "tick_interval_s",
                        3600.0)
    telemetry.reset()
    registry = ModelRegistry(max_batch=8, device="cpu")
    registry.add("m", _zip(tmp_path, "live.zip", seed=42))
    server = ServingServer(registry=registry).start()
    try:
        yield (server, registry,
               "http://%s:%d" % (server.host, server.port), tmp_path)
    finally:
        server.stop()


def test_zero_touch_release_over_http(served):
    server, registry, url, tmp = served
    ctl = server.release
    code, doc, _ = _request(url + "/release/m",
                            {"path": _zip(tmp, "cand.zip", seed=42),
                             "policy": FAST})
    assert code == 200 and doc["state"] == SHADOW
    cand = doc["candidate"]
    mirrored = _mirrors(ctl, 4)
    gens = set()
    for i in range(4):
        code, _, headers = _predict(url, _x(i), rid="shadow-%d" % i)
        assert code == 200
        gens.add(headers["X-Serving-Generation"])
        assert headers["X-Serving-Bucket"] == "2"
    assert gens == {"gen_1"}
    assert mirrored.wait(30) and ctl.drain_shadow()
    assert ctl.status("m")["shadow"]["compares"] == 4
    assert ctl.status("m")["shadow"]["mismatches"] == 0
    ctl.tick()
    assert ctl.status("m")["state"] == CANARY
    # the SLO plane records a request after its reply was written: wait
    # for the candidate's record before the judge reads it
    recorded = threading.Event()
    record = server.slo.record

    def noted(model, *args, **kwargs):
        record(model, *args, **kwargs)
        if model == cand:
            recorded.set()
    server.slo.record = noted
    code, _, headers = _predict(url, _x(9), rid="canary-1")
    assert code == 200
    assert headers["X-Serving-Generation"] == "gen_%d" % doc["generation"]
    assert recorded.wait(30)
    ctl.tick()
    code, doc, _ = _request(url + "/release/m")
    assert (code, doc["state"]) == (200, PROMOTED)
    assert registry.peek("m").version == 2
    assert cand not in registry
    code, doc, _ = _request(url + "/release")
    assert doc["active"] == {} and doc["recent"]["m"]["state"] == PROMOTED
    assert server.statusz()["release"]["recent"]["m"]["state"] == PROMOTED
    kinds = [(e["kind"], e.get("model")) for e in telemetry.journal_events()
             if e["kind"].startswith(("release.", "registry."))]
    assert kinds == [("registry.add", "m"), ("registry.add", cand),
                     ("release.start", "m"), ("release.advance", "m"),
                     ("registry.remove", cand), ("release.promote", "m")]


def test_a_different_candidate_rolls_back_over_http(served):
    server, registry, url, tmp = served
    ctl = server.release
    code, doc, _ = _request(url + "/release/m",
                            {"path": _zip(tmp, "bad.zip", seed=7),
                             "policy": FAST})
    assert code == 200
    mirrored = _mirrors(ctl, 3)
    live = [_predict(url, _x(i), rid="live-%d" % i)[1]["outputs"]
            for i in range(3)]
    assert mirrored.wait(30) and ctl.drain_shadow()
    ctl.tick()
    code, doc, _ = _request(url + "/release/m")
    assert doc["state"] == ROLLED_BACK
    assert doc["shadow"]["exemplar_rid"].startswith("live-")
    ev = [e for e in telemetry.journal_events()
          if e["kind"] == "release.rollback"][0]
    assert ev["exemplar_rid"] == doc["shadow"]["exemplar_rid"]
    assert doc["candidate"] not in registry
    # the clients saw the live generation's replies only
    assert [_predict(url, _x(i))[1]["outputs"] for i in range(3)] == live


def test_mutations_409_while_release_is_active(served):
    server, registry, url, tmp = served
    cand_zip = _zip(tmp, "cand.zip", seed=42)
    other = _zip(tmp, "other.zip", seed=5)
    assert _request(url + "/release/m", {"path": cand_zip})[0] == 200
    code, doc, _ = _request(url + "/reload", {"path": cand_zip,
                                              "model": "m"})
    assert code == 409 and "release" in doc["error"]
    assert _request(url + "/models/m.gen2", {"path": other})[0] == 409
    assert _request(url + "/models/m.gen2", method="DELETE")[0] == 409
    assert _request(url + "/release/m", {"path": other})[0] == 409
    assert _request(url + "/models/x", {"path": other})[0] == 200
    code, doc, _ = _request(url + "/release/m", method="DELETE")
    assert (code, doc["state"]) == (200, ABORTED)
    assert _request(url + "/reload", {"path": cand_zip,
                                      "model": "m"})[0] == 200


def test_candidate_vanishing_mid_canary_never_drops_a_client(served):
    server, registry, url, tmp = served
    ctl = server.release
    code, doc, _ = _request(url + "/release/m",
                            {"path": _zip(tmp, "cand.zip", seed=42),
                             "policy": dict(FAST, hold=True)})
    assert code == 200
    cand = doc["candidate"]
    mirrored = _mirrors(ctl, 3)
    for i in range(3):
        assert _predict(url, _x(i), rid="w-%d" % i)[0] == 200
    assert mirrored.wait(30) and ctl.drain_shadow()
    ctl.tick()
    rel = ctl._active["m"]
    rel.policy["hold"] = False
    ctl.tick()
    assert rel.state == CANARY and rel.canary_pct == 100.0
    with ctl._as_controller():
        registry.remove(cand)
    code, doc, headers = _predict(url, _x(50), rid="race-1")
    assert code == 200
    assert headers["X-Serving-Generation"] == "gen_1"
    assert doc["model_version"] == 1
    ctl.tick()
    assert ctl.status("m")["state"] == FAILED


def test_release_http_error_surface(served, monkeypatch):
    server, registry, url, tmp = served
    cand_zip = _zip(tmp, "cand.zip", seed=42)
    assert _request(url + "/release/ghost", {"path": cand_zip})[0] == 404
    assert _request(url + "/release/m", {"nope": 1})[0] == 400
    assert _request(url + "/release/m")[0] == 404
    assert _request(url + "/release/m", method="DELETE")[0] == 404
    assert _request(url + "/release/m",
                    {"path": str(tmp / "missing.zip")})[0] == 400
    monkeypatch.setattr(root.common.serving, "slo_enabled", False)
    code, doc, _ = _request(url + "/release/m", {"path": cand_zip})
    assert code == 400 and "slo" in doc["error"].lower()


def test_one_engine_has_no_release_plane(tmp_path):
    from znicz_tpu_torch.serving.engine import InferenceEngine
    engine = InferenceEngine(_zip(tmp_path, "one.zip", seed=42),
                             max_batch=4, device="cpu")
    srv = ServingServer(engine, port=0).start()
    url = "http://%s:%d" % (srv.host, srv.port)
    try:
        assert _request(url + "/release")[:2] == (
            200, {"active": {}, "recent": {}})
        assert _request(url + "/release/m", {"path": "x"})[0] == 400
        assert _request(url + "/release/m", method="DELETE")[0] == 404
    finally:
        srv.stop()


# -- the real fleet: serve --fleet 2 --autoscale ------------------------------

class _Cli(object):
    """The ``serve --fleet 2 --autoscale`` CLI as a subprocess, its
    output drained by a thread; the URL from its banner."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "znicz_tpu_torch", "serve"] + argv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=ENV, cwd=REPO)
        self.lines = []
        self.url = self.banner = None
        self._banner = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()
        if not self._banner.wait(150) or self.url is None:
            self.stop()
            raise AssertionError("no fleet banner:\n" +
                                 "\n".join(self.lines[-30:]))

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if self.url is None and "replicas behind http://" in line:
                self.banner = line
                self.url = line.split("behind ", 1)[1].split("/ ")[0]
                self._banner.set()
        self._banner.set()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("release_fleet")
    live = _zip(tmp, "live.zip", seed=42)
    cli = _Cli(["m=" + live, "--fleet", "2", "--autoscale", "--device",
                "cpu", "--port", "0", "--max-batch", "8",
                "--config", "common.serving.slo_enabled=True",
                "--config", "common.serving.release.tick_interval_s=0.05",
                # the autoscaler holds the fleet at 2: the release tests
                # read both replicas' oracles
                "--config", "common.serving.fleet.min_replicas=2",
                "--config", "common.serving.fleet.max_replicas=2",
                "--config", "common.serving.fleet.autoscale_interval_s=0.5"])
    try:
        yield cli, cli.url, tmp
    finally:
        cli.stop()


def _get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.loads(resp.read())


def _drive_until(url, states, n_max=2000, prefix="drv"):
    """Real traffic through the fleet until the release's state is one
    of ``states``: (its status, the generations that answered)."""
    gens = []
    for i in range(n_max):
        code, _, headers = _predict(url, _x(i), rid="%s-%d" % (prefix, i))
        assert code == 200
        gens.append(headers.get("X-Serving-Generation"))
        if i % 4 == 3:
            code, doc, _ = _request(url + "/release/m")
            if code == 200 and doc["state"] in states:
                return doc, gens
    raise AssertionError("the release never reached %s" % (states,))


def test_fleet_banner_says_autoscaler_armed(fleet):
    cli, url, _ = fleet
    assert "autoscaler armed" in cli.banner
    status = _get(url, "/statusz")
    assert status["fleet"]["up"] == 2
    assert "--autoscale" not in status["fleet"]["replica_argv"]
    scaler = status["autoscaler"]
    assert scaler["knobs"]["min"] == scaler["knobs"]["max"] == 2


def _live_version(url):
    return _get(url, "/models")["models"]["m"]["model_version"]


def test_fleet_zero_touch_promote(fleet):
    cli, url, tmp = fleet
    version = _live_version(url)
    code, doc, _ = _request(
        url + "/release/m",
        {"path": _zip(tmp, "cand.zip", seed=42),
         "policy": {"green_window_s": 0.4, "min_requests": 2,
                    "shadow_min_compares": 3, "canary_steps": [50.0]}})
    assert code == 200 and doc["state"] == SHADOW
    cand = doc["candidate"]
    assert cand == "m.gen%d" % (version + 1)
    assert cand in _get(url, "/models")["models"]
    final, gens = _drive_until(url, {PROMOTED, FAILED, ROLLED_BACK},
                               prefix="promote")
    assert final["state"] == PROMOTED, final
    assert final["shadow"]["mismatches"] == 0
    assert final["shadow"]["compares"] >= 3
    new = "gen_%d" % (version + 1)
    assert set(gens) <= {"gen_%d" % version, new} and new in gens
    models = _get(url, "/models")["models"]
    assert models["m"]["model_version"] == version + 1
    assert cand not in models
    assert _get(url, "/statusz")["release"]["recent"]["m"]["state"] == \
        PROMOTED


def test_fleet_rolls_back_a_different_candidate(fleet):
    cli, url, tmp = fleet
    live = "gen_%d" % _live_version(url)
    # the live reply, taken before the release: every request during it
    # is one of _drive_until's, so the exemplar is one of theirs
    x = _x(77)
    before = _predict(url, x)[1]["outputs"]
    code, doc, _ = _request(
        url + "/release/m",
        {"path": _zip(tmp, "bad.zip", seed=9),
         "policy": {"green_window_s": 0.4, "min_requests": 2,
                    "shadow_min_compares": 3, "canary_steps": [50.0]}})
    assert code == 200
    final, gens = _drive_until(url, {PROMOTED, FAILED, ROLLED_BACK},
                               prefix="bad")
    assert final["state"] == ROLLED_BACK, final
    assert final["shadow"]["exemplar_rid"].startswith("bad-")
    assert set(gens) == {live}          # the live generation only
    assert doc["candidate"] not in _get(url, "/models")["models"]
    assert _predict(url, x)[1]["outputs"] == before


def test_fleet_abort_during_ramp_storm_no_duplicates(fleet):
    cli, url, tmp = fleet
    code, doc, _ = _request(
        url + "/release/m",
        {"path": _zip(tmp, "cand2.zip", seed=42),
         "policy": {"green_window_s": 0.2, "min_requests": 1,
                    "shadow_min_compares": 2,
                    "canary_steps": [60.0] * 8}})
    assert code == 200
    cand = doc["candidate"]
    _drive_until(url, {CANARY}, prefix="warm")
    rids = ["storm-%03d" % n for n in range(48)]
    assert any(split_point(r) < 60.0 for r in rids)
    results, errors = {}, []

    def fire(rid, seed):
        try:
            code, _, headers = _predict(url, _x(seed), rid=rid)
            results[rid] = (code, headers.get("X-Serving-Generation"))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append((rid, repr(e)))

    threads = [threading.Thread(target=fire, args=(rid, 100 + n))
               for n, rid in enumerate(rids)]
    for t in threads[:24]:
        t.start()
    code, doc, _ = _request(url + "/release/m", method="DELETE")
    assert (code, doc["state"]) == (200, ABORTED)
    for t in threads[24:]:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert sorted(results) == sorted(rids)
    assert all(code == 200 for code, _ in results.values()), results
    replicas = [r for r in _get(url, "/statusz")["fleet"]["replicas"]
                if r["state"] == "up"]
    assert len(replicas) == 2
    for rid in rids:
        admitted = [_get(r["url"], "/admitted/" + rid)["admitted"]
                    for r in replicas]
        assert sorted(admitted) == [False, True], (rid, admitted)
    assert cand not in _get(url, "/models")["models"]
    x = _x(999)
    replies = [_predict(url, x)[1]["outputs"] for _ in range(4)]
    assert all(r == replies[0] for r in replies)


def test_fleet_release_error_surface(fleet):
    cli, url, tmp = fleet
    cand = _zip(tmp, "cand3.zip", seed=42)
    assert _request(url + "/release/ghost", {"path": cand})[0] == 404
    assert _request(url + "/release/m", {"nope": 1})[0] == 400
    assert _request(url + "/release/m", method="DELETE")[0] == 404
    code, doc, _ = _request(url + "/release/m",
                            {"path": str(tmp / "missing.zip")})
    assert code == 400
    code, doc, _ = _request(url + "/release/m", {"path": cand,
                                                 "policy": {"hold": True}})
    assert code == 200
    # the router's guard: mutations of the released pair answer 409
    assert _request(url + "/reload", {"path": cand, "model": "m"})[0] == 409
    assert _request(url + "/models/" + doc["candidate"], method="DELETE")[
        0] == 409
    assert _request(url + "/release/m", {"path": cand})[0] == 409
    code, doc, _ = _request(url + "/release/m", method="DELETE")
    assert (code, doc["state"]) == (200, ABORTED)
    assert doc["candidate"] not in _get(url, "/models")["models"]
    # at min_replicas and max_replicas alike, the autoscaler only holds
    decision = _get(url, "/statusz")["autoscaler"]["last_decision"]
    assert decision.get("action", "hold") == "hold"
    conn = http.client.HTTPConnection(url.split("//")[1].split(":")[0],
                                      int(url.rsplit(":", 1)[1]),
                                      timeout=30)
    try:
        conn.request("PUT", "/release/m")
        assert conn.getresponse().status in (404, 501)
    finally:
        conn.close()


def test_a_replica_entering_mid_release_gets_the_candidate(tmp_path,
                                                           monkeypatch):
    """A replica that enters rotation while a release is in flight holds
    the candidate before it takes a request (an in-process router over
    one replica, scaled up by hand mid-shadow)."""
    from znicz_tpu_torch.serving.router import FleetRouter
    monkeypatch.setattr(root.common.serving, "slo_enabled", True)
    live = _zip(tmp_path, "live.zip", seed=42)
    router = FleetRouter(["m=" + live, "--device", "cpu", "--max-batch", "8",
                          "--config", "common.serving.slo_enabled=True"],
                         replicas=1, env=ENV).start()
    url = "http://127.0.0.1:%d" % router.port
    try:
        code, doc, _ = _request(url + "/release/m", {
            "path": _zip(tmp_path, "cand.zip", seed=42),
            "policy": {"hold": True}})
        assert code == 200
        new = router.scale_up()
        assert doc["candidate"] in _get(new.url, "/models")["models"]
        code, doc, _ = _request(url + "/release/m", method="DELETE")
        assert (code, doc["state"]) == (200, ABORTED)
        for replica in router.replicas():
            assert doc["candidate"] not in \
                _get(replica.url, "/models")["models"]
    finally:
        router.stop()


def test_fleet_replica_joining_after_a_promote_serves_its_generation(
        tmp_path, monkeypatch):
    """A replica spawned after a promote boots on the replica argv's
    package; it enters rotation serving the promoted package at the
    promoted generation, as the replicas that took the promote do (an
    in-process router over one replica, another seed's package promoted
    under a policy that tolerates its shadow mismatches)."""
    from znicz_tpu_torch.serving.engine import InferenceEngine
    from znicz_tpu_torch.serving.router import FleetRouter
    monkeypatch.setattr(root.common.serving, "slo_enabled", True)
    live = _zip(tmp_path, "live.zip", seed=42)
    promoted = _zip(tmp_path, "promoted.zip", seed=9)
    router = FleetRouter(["m=" + live, "--device", "cpu", "--max-batch", "8",
                          "--config", "common.serving.slo_enabled=True"],
                         replicas=1, env=ENV).start()
    url = "http://127.0.0.1:%d" % router.port
    try:
        version = _live_version(url)
        code, doc, _ = _request(url + "/release/m", {
            "path": promoted,
            "policy": {"shadow_mismatch_max": 10 ** 6, "green_window_s": 0.0,
                       "min_requests": 1, "shadow_min_compares": 1,
                       "canary_steps": [100.0]}})
        assert code == 200
        final, _ = _drive_until(url, {PROMOTED, FAILED, ROLLED_BACK},
                                prefix="join")
        assert final["state"] == PROMOTED, final
        new = router.scale_up()
        x = _x(5)
        want = InferenceEngine(promoted, max_batch=8, device="cpu").predict(x)
        replicas = router.replicas()
        assert [r.rid for r in replicas] == ["r0", new.rid]
        for replica in replicas:
            _, doc, headers = _predict(replica.url, x)
            assert headers["X-Serving-Generation"] == "gen_%d" % (version + 1)
            assert doc["outputs"] == want.astype(numpy.float64).tolist()
            block = _get(replica.url, "/models")["models"]["m"]
            assert block["model_version"] == version + 1
    finally:
        router.stop()
