"""The port's durable blackbox (``znicz_tpu_torch/core/blackbox.py``)
held against ``znicz_tpu/core/blackbox.py``, case by case after
``tests/unit/test_blackbox.py``: the segment format is the JAX
package's byte for byte, so each package reads the other's segments,
torn tails included; ``scan``, ``read_all``, ``timeline``,
``checkpoint_payloads``, ``query_rate`` and ``postmortem`` answer the
same for the same segments in both (exactly: tolerance 0); the port's
writer, sinks, rotation and retention, crash report, ``/debug/blackbox``
and ``obs`` CLI behave as the JAX package's, ``obs --rid`` and
``query_rid`` included.
"""

import json
import os
import subprocess
import sys
import urllib.request

import pytest

from znicz_tpu.core import blackbox as jax_blackbox
from znicz_tpu_torch.core import blackbox, telemetry, timeseries
from znicz_tpu_torch.core.config import root

KNOBS = ("enabled", "dir", "role", "segment_bytes", "retention_bytes",
         "checkpoint_every_sweeps")


@pytest.fixture(autouse=True)
def _bb_isolated():
    saved = {k: root.common.telemetry.blackbox.get(k) for k in KNOBS}
    tel_on = root.common.telemetry.get("enabled")
    telemetry.reset()
    blackbox.reset()
    yield
    blackbox.reset()
    telemetry.reset()
    for k, v in saved.items():
        setattr(root.common.telemetry.blackbox, k, v)
    root.common.telemetry.enabled = tel_on


RECORDS = [{"bb": "journal", "kind": "a.one", "t": 1.5},
           {"bb": "ts", "t": 2.0, "sweeps": 1, "series": {}},
           {"unicode": "å∂", "n": 3, "f": 0.1}]


@pytest.mark.parametrize("writer,reader", [
    (jax_blackbox, blackbox), (blackbox, jax_blackbox),
    (blackbox, blackbox)])
def test_framing_is_jaxs_byte_for_byte(tmp_path, writer, reader):
    for r in RECORDS:
        assert blackbox._frame(r) == jax_blackbox._frame(r)
    path = str(tmp_path / "seg")
    with open(path, "wb") as f:
        for r in RECORDS:
            f.write(writer._frame(r))
    assert reader.read_segment(path) == (RECORDS, 0)


@pytest.mark.parametrize("writer,reader", [
    (jax_blackbox, blackbox), (blackbox, jax_blackbox)])
def test_torn_tail_recovered_around_across_packages(tmp_path, writer,
                                                    reader):
    """A tail torn inside the length prefix, the payload or before the
    newline: every complete record survives and the torn bytes are
    counted, whichever package wrote and whichever reads."""
    framed = [writer._frame({"i": i, "pad": "x" * 40}) for i in range(5)]
    blob = b"".join(framed)
    keep = len(blob) - len(framed[-1])
    for cut in (keep + 1, keep + 12, len(blob) - 1):
        path = str(tmp_path / ("seg%d" % cut))
        with open(path, "wb") as f:
            f.write(blob[:cut])
        got = reader.read_segment(path)
        assert got == writer.read_segment(path)
        assert [r["i"] for r in got[0]] == [0, 1, 2, 3]
        assert got[1] == cut - keep


def test_corrupt_payload_stops_loudly(tmp_path):
    good = blackbox._frame({"i": 0})
    bad = blackbox._frame({"i": 1})
    bad = bad.split(b" ", 1)[0] + b" " + b"#" * (len(bad.split(
        b" ", 1)[1]) - 1) + b"\n"
    path = str(tmp_path / "seg")
    with open(path, "wb") as f:
        f.write(good + bad)
    got = blackbox.read_segment(path)
    assert got == jax_blackbox.read_segment(path) == ([{"i": 0}], len(bad))


def test_read_all_counts_and_journals_torn_tails(tmp_path):
    root.common.telemetry.enabled = True
    d = tmp_path / "bb"
    d.mkdir()
    seg = d / "dead.12345.ff.000"
    with open(str(seg), "wb") as f:
        f.write(jax_blackbox._frame({"bb": "journal", "t": 1.0,
                                     "kind": "pre.crash"}))
        f.write(b"999 {\"torn")
    records, torn = blackbox.read_all(str(d))
    assert (records, torn) == jax_blackbox.read_all(str(d))
    assert [r["kind"] for _, r in records] == ["pre.crash"]
    assert torn == {str(seg): len(b"999 {\"torn")}
    assert telemetry.counter("blackbox.torn_tails").value == 1
    evs = [e for e in telemetry.journal_events()
           if e["kind"] == "blackbox.torn_tail"]
    assert evs and evs[0]["segment"] == str(seg)


@pytest.mark.parametrize("name", [
    "fleet.router.8.1a2b.007", "serve.1.zz.abc", "README.txt",
    "train.4242.18f3a.000"])
def test_segment_names(name):
    assert blackbox.parse_segment_name(name) == \
        jax_blackbox.parse_segment_name(name)


def test_disabled_blackbox_touches_no_filesystem(monkeypatch):
    root.common.telemetry.blackbox.enabled = False
    root.common.telemetry.enabled = True

    def boom(*a, **k):
        raise AssertionError("disabled blackbox touched the fs")

    monkeypatch.setattr(blackbox, "_Writer", boom)
    monkeypatch.setattr(blackbox, "open", boom, raising=False)
    monkeypatch.setattr(blackbox.os, "makedirs", boom)
    assert blackbox.maybe_arm("test") is False
    assert blackbox.armed() is False
    assert blackbox.current_segment() is None
    telemetry.record_event("off.path", rid="r-0")
    assert telemetry.journal_events()[-1]["kind"] == "off.path"
    assert telemetry._journal_sink is None
    assert blackbox.stats() == {"enabled": False, "armed": False}


def test_role_knob_beats_argument_and_first_arm_wins(tmp_path):
    blackbox.enable(dir=str(tmp_path / "bb"), role="cfgrole")
    assert blackbox.maybe_arm("argrole") is True
    assert blackbox.stats()["role"] == "cfgrole"
    root.common.telemetry.blackbox.role = None
    assert blackbox.maybe_arm("other") is True
    assert blackbox.stats()["role"] == "cfgrole"
    blackbox.reset()
    assert blackbox.maybe_arm() is True
    assert blackbox.stats()["role"] == "proc"


def test_write_through_sinks_land_on_disk(tmp_path, monkeypatch):
    """A journal event and a time-series checkpoint each become a
    durable record when they are emitted; the JAX package's reader
    reads them back the same."""
    root.common.telemetry.enabled = True
    monkeypatch.setattr(root.common.telemetry.timeseries, "enabled", True)
    timeseries.reset()
    d = str(tmp_path / "bb")
    blackbox.enable(dir=d, role="test", checkpoint_every_sweeps=1)
    assert blackbox.maybe_arm() is True
    try:
        telemetry.record_event("unit.ping", rid="r-42", detail=7)
        telemetry.counter("serving.batches").inc(3)
        timeseries.sample_once(now=100.0)
        records, torn = blackbox.read_all(d)
    finally:
        timeseries.reset()
    assert (records, torn) == jax_blackbox.read_all(d)
    assert not torn
    by = {}
    for _, rec in records:
        by.setdefault(rec["bb"], []).append(rec)
    ev = [r for r in by["journal"] if r.get("kind") == "unit.ping"]
    assert ev and ev[0]["rid"] == "r-42" and ev[0]["detail"] == 7
    assert by["ts"][-1]["series"]["serving.batches"] == {
        "kind": "counter", "t": 100.0, "v": 3.0}


def test_a_sink_that_raises_is_swallowed():
    root.common.telemetry.enabled = True
    telemetry.set_journal_sink(lambda ev: 1 / 0)
    try:
        ev = telemetry.record_event("still.recorded")
    finally:
        telemetry.set_journal_sink(None)
    assert ev["kind"] == "still.recorded"
    assert telemetry.journal_events()[-1] is ev


def test_rotation_retention_bounded_and_newest_queryable(tmp_path):
    root.common.telemetry.enabled = True
    d = str(tmp_path / "bb")
    blackbox.enable(dir=d, role="rot", segment_bytes=512,
                    retention_bytes=2048)
    assert blackbox.maybe_arm() is True
    for i in range(300):
        telemetry.record_event("rot.tick", i=i)
    st = blackbox.stats()
    assert st["rotations"] > 0 and st["retention_deleted"] > 0
    assert st["total_bytes"] <= 2048 + 1024
    live = blackbox.current_segment()
    assert live is not None and os.path.exists(live)
    out = blackbox.timeline(d, kind="rot")
    assert out == jax_blackbox.timeline(d, kind="rot")
    assert out["events"][-1]["i"] == 299 and out["events"][0]["i"] > 0


def test_crash_report_points_at_live_segment(tmp_path):
    root.common.telemetry.enabled = True
    blackbox.enable(dir=str(tmp_path / "bb"), role="cr")
    assert blackbox.maybe_arm() is True
    telemetry.record_event("boom.precursor")
    path = telemetry.write_crash_report(
        reason="test", directory=str(tmp_path / "crash"))
    with open(os.path.join(path, "report.json")) as f:
        report = json.load(f)
    assert report["blackbox_segment"] == blackbox.current_segment()
    assert os.path.exists(report["blackbox_segment"])
    blackbox.reset()
    path = telemetry.write_crash_report(
        reason="test", directory=str(tmp_path / "crash"))
    with open(os.path.join(path, "report.json")) as f:
        assert json.load(f)["blackbox_segment"] is None


def _two_sources(d, writers):
    """A router's and a replica's segments written by ``writers``
    (the blackbox module of each)."""
    w1 = writers[0]._Writer("router", d)
    w1.write({"bb": "journal", "t": 2.0, "kind": "b.two", "rid": "r-1"})
    w1.close()
    w2 = writers[1]._Writer("replica", d)
    w2.boot = "f" + w2.boot
    w2.write({"bb": "journal", "t": 1.0, "kind": "a.one"})
    w2.write({"bb": "journal", "t": 3.0, "kind": "a.three",
              "exemplar_rid": "r-1"})
    w2.write({"bb": "ts", "t": 4.0, "sweeps": 1, "series": {}})
    w2.close()


@pytest.mark.parametrize("writers", [
    (blackbox, blackbox), (jax_blackbox, blackbox),
    (blackbox, jax_blackbox)])
def test_timeline_merges_sources_and_filters(tmp_path, writers):
    d = str(tmp_path / "bb")
    _two_sources(d, writers)
    for kwargs in ({}, {"kind": "a"}, {"rid": "r-1"}, {"n": 1},
                   {"roles": ("router",)}):
        assert blackbox.timeline(d, **kwargs) == \
            jax_blackbox.timeline(d, **kwargs)
    assert [e["kind"] for e in blackbox.timeline(d)["events"]] == \
        ["a.one", "b.two", "a.three"]
    assert [e["kind"] for e in
            blackbox.timeline(d, rid="r-1")["events"]] == \
        ["b.two", "a.three"]


def test_query_rid_raises_naming_the_roadmap(tmp_path, capsys):
    """``obs --rid`` no longer raises (the request traces are in the
    port now): ``query_rid`` answers JAX's payload for the same
    segments — journal events by rid, the persisted trees, and the
    router tree re-stitched with the replica's."""
    from znicz_tpu.serving import reqtrace as jax_reqtrace
    d = str(tmp_path / "bb")
    _two_sources(d, (blackbox, blackbox))
    assert blackbox.query_rid(d, "q-1") == jax_blackbox.query_rid(d, "q-1")
    router_tree = {"rid": "r-1", "origin": "router", "complete": True,
                   "wall_ms": 10.0, "spans": [
                       {"kind": "replica_wait", "start_ms": 2.0,
                        "duration_ms": 6.0,
                        "attrs": {"replica": "r0"}}]}
    replica_tree = {"rid": "r-1", "origin": "serving", "complete": True,
                    "wall_ms": 4.0, "spans": [
                        {"kind": "dispatch", "start_ms": 1.0,
                         "duration_ms": 2.0}]}
    w = blackbox._Writer("router", d)
    w.boot = "e" + w.boot
    w.write({"bb": "trace", "t": 5.0, "rid": "r-1", "tree": router_tree})
    w.close()
    w = blackbox._Writer("replica", d)
    w.boot = "d" + w.boot
    w.write({"bb": "trace", "t": 5.5, "rid": "r-1", "tree": replica_tree})
    w.close()
    got = blackbox.query_rid(d, "r-1")
    assert got == jax_blackbox.query_rid(d, "r-1")
    assert [e["kind"] for e in got["events"]] == ["b.two", "a.three"]
    assert len(got["traces"]) == 2
    source = [t["source"] for t in got["traces"]
              if t["tree"]["origin"] == "serving"][0]
    assert got["stitched"] == jax_reqtrace.stitch(
        router_tree, replica_tree, replica=source)
    capsys.readouterr()
    assert blackbox.cli_main(["--dir", d, "--rid", "r-1", "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(got, default=str))
    assert blackbox.cli_main(["--dir", d, "--rid", "r-1"]) == 0
    out = capsys.readouterr().out
    assert "2 persisted trace trees, stitched" in out


def test_query_rate_spans_restarts(tmp_path):
    d = str(tmp_path / "bb")

    def ckpt(w, t, v, sweeps):
        w.write({"bb": "ts", "t": t, "sweeps": sweeps,
                 "series": {"serving.requests": {
                     "kind": "counter", "t": t, "v": v}}})

    w1 = jax_blackbox._Writer("serve", d)   # a JAX boot ...
    w1.boot = "aaa"
    ckpt(w1, 100.0, 0.0, 1)
    ckpt(w1, 160.0, 60.0, 2)
    w1.close()
    w2 = blackbox._Writer("serve", d)       # ... and the port's
    w2.boot = "bbb"
    ckpt(w2, 170.0, 0.0, 1)
    ckpt(w2, 220.0, 30.0, 2)
    w2.close()
    assert blackbox.checkpoint_payloads(d) == \
        jax_blackbox.checkpoint_payloads(d)
    for window_s in (None, 60.0):
        out = blackbox.query_rate(d, "serving.requests", window_s=window_s)
        assert out == jax_blackbox.query_rate(d, "serving.requests",
                                              window_s=window_s)
    out = blackbox.query_rate(d, "serving.requests")
    vs = [v for _, v in out["points"]]
    assert vs == sorted(vs) and vs[-1] == 90.0 and out["rate"] > 0


def test_postmortem_prefers_newest_dead_boot(tmp_path):
    d = str(tmp_path / "bb")
    reaped = subprocess.Popen([sys.executable, "-c", "pass"])
    reaped.wait(timeout=30)
    dead = blackbox._Writer("replica", d)
    dead.pid = reaped.pid
    dead.boot = "ffffffffffff"
    dead.write({"bb": "journal", "t": 5.0, "kind": "last.words"})
    dead.write({"bb": "ts", "t": 6.0, "sweeps": 3,
                "series": {"serving.requests": {
                    "kind": "counter", "t": 6.0, "v": 9.0}}})
    dead.close()
    alive = blackbox._Writer("replica", d)
    alive.boot = "fffffffffffff"
    alive.write({"bb": "journal", "t": 8.0, "kind": "still.here"})
    alive.close()
    pm = blackbox.postmortem(d, "replica")
    assert pm == jax_blackbox.postmortem(d, "replica")
    assert pm["pid"] == dead.pid and pm["alive"] is False
    assert [e["kind"] for e in pm["events"]] == ["last.words"]
    assert pm["last_checkpoint"]["sweeps"] == 3
    assert blackbox.postmortem(d, "ghost")["error"]


def test_obs_cli_timeline_and_filters(tmp_path, capsys):
    from znicz_tpu_torch import __main__ as cli
    d = str(tmp_path / "bb")
    w = blackbox._Writer("train", d)
    w.write({"bb": "journal", "t": 1.0, "kind": "faults.injected",
             "rid": "r-1"})
    w.write({"bb": "journal", "t": 2.0, "kind": "launcher.restart"})
    w.close()
    assert cli.main(["obs", "--dir", d, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [e["kind"] for e in out["events"]] == \
        ["faults.injected", "launcher.restart"]
    assert cli.main(["obs", "--dir", d, "--kind", "faults",
                     "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [e["kind"] for e in out["events"]] == ["faults.injected"]
    assert cli.main(["obs", "--dir", d, "--postmortem", "train"]) == 0
    assert "faults.injected" in capsys.readouterr().out
    assert cli.main(["obs", "--dir", d]) == 0
    assert "launcher.restart" in capsys.readouterr().out
    assert cli.main(["obs", "--dir", str(tmp_path / "nope")]) == 1
    capsys.readouterr()


def test_debug_blackbox_endpoint_and_server_arming(tmp_path):
    from znicz_tpu_torch.core.status_server import StatusServer
    root.common.telemetry.enabled = True
    blackbox.enable(dir=str(tmp_path / "bb"), role="http")
    server = StatusServer(None, port=0).start()   # start() arms
    try:
        assert blackbox.armed() is True
        telemetry.record_event("gamma.tick")
        url = "http://127.0.0.1:%d/debug/blackbox" % server.port
        with urllib.request.urlopen(url, timeout=10) as r:
            st = json.loads(r.read())
        assert st["enabled"] and st["armed"] and st["role"] == "http"
        assert st["records"] >= 2 and st["segments_on_disk"] >= 1
    finally:
        server.stop()


_VICTIM = r"""
import sys
sys.path.insert(0, sys.argv[2])
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core import blackbox, telemetry
root.common.telemetry.enabled = True
blackbox.enable(dir=sys.argv[1], role="victim")
assert blackbox.maybe_arm()
i = 0
while True:
    telemetry.record_event("victim.tick", i=i, pad="x" * 64)
    print(i, flush=True)
    i += 1
"""


def test_sigkill_mid_write_recovers_every_acked_record(tmp_path):
    """A port process journaling in a tight loop is SIGKILLed: every
    record it acknowledged is read back, by either package."""
    import signal
    d = str(tmp_path / "bb")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _VICTIM, d, repo],
                            stdout=subprocess.PIPE, text=True)
    acked = -1
    try:
        for line in proc.stdout:
            acked = int(line)
            if acked >= 200:
                break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
    out = blackbox.timeline(d, kind="victim")
    assert out["events"] == jax_blackbox.timeline(d, kind="victim")[
        "events"]
    got = [e["i"] for e in out["events"]]
    assert got[:acked + 1] == list(range(acked + 1))
