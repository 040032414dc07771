"""The port's request trace trees (``znicz_tpu_torch/serving/reqtrace.py``)
held against ``znicz_tpu/serving/reqtrace.py``: the cases of
``tests/unit/test_reqtrace.py`` on the port (injected stamps, no
sleeps); the same span streams built in both packages give equal
``get()`` payloads and equal ``stitch()`` trees (exactly); and a tree
the port persists through its armed blackbox is read back by JAX's
``blackbox.query_rid`` as the port's ``obs --rid`` prints it.
"""

import json

import pytest

from znicz_tpu.core import blackbox as jax_blackbox
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving import reqtrace as jax_reqtrace
from znicz_tpu_torch.core import blackbox
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import reqtrace


@pytest.fixture
def traced(monkeypatch):
    for r in (root, jax_root):
        monkeypatch.setattr(r.common.serving, "trace_sample_n", 1)
        monkeypatch.setattr(r.common.serving, "trace_capacity", 8)
    reqtrace.reset()
    jax_reqtrace.reset()
    yield reqtrace
    reqtrace.reset()
    jax_reqtrace.reset()


def _full_tree(rt, rid, t0=100.0):
    assert rt.begin(rid, now=t0) is True
    rt.add_span(rid, "admission", t0, t0 + 0.001)
    rt.add_span(rid, "queue_wait", t0 + 0.001, t0 + 0.002)
    rt.add_span(rid, "assembly", t0 + 0.002, t0 + 0.003)
    rt.add_span(rid, "dispatch", t0 + 0.003, t0 + 0.009, bucket=1)
    rt.add_span(rid, "device", t0 + 0.004, t0 + 0.008)
    rt.add_span(rid, "reply", t0 + 0.009, t0 + 0.010)
    rt.finish(rid, now=t0 + 0.010, model="m")


def _router_tree(rt, rid, t0=500.0, wait_s=0.012):
    assert rt.begin(rid, now=t0, origin="router") is True
    rt.add_span(rid, "route", t0, t0 + 0.001)
    rt.add_span(rid, "conn_acquire", t0 + 0.001, t0 + 0.002, reused=True)
    rt.add_span(rid, "relay_send", t0 + 0.002, t0 + 0.003)
    rt.add_span(rid, "replica_wait", t0 + 0.003, t0 + 0.003 + wait_s,
                replica="fleet-2")
    rt.add_span(rid, "relay_reply", t0 + 0.003 + wait_s,
                t0 + 0.004 + wait_s)
    rt.finish(rid, now=t0 + 0.004 + wait_s, model="m")


def _retry_tree(rt, rid, t0=700.0):
    assert rt.begin(rid, now=t0, origin="router") is True
    rt.add_span(rid, "route", t0, t0 + 0.001)
    rt.add_span(rid, "retry", t0 + 0.001, t0 + 0.005, peer="fleet-1",
                reason="connect_failed")
    rt.add_span(rid, "conn_acquire", t0 + 0.005, t0 + 0.006)
    rt.add_span(rid, "relay_send", t0 + 0.006, t0 + 0.007)
    rt.add_span(rid, "replica_wait", t0 + 0.007, t0 + 0.015,
                replica="fleet-2")
    rt.add_span(rid, "relay_reply", t0 + 0.015, t0 + 0.016)
    rt.add_span(rid, "relay_wait", t0 + 0.015, t0 + 0.0155)
    rt.finish(rid, now=t0 + 0.016)


def _wire_replica_tree(rt, rid, t0=300.0):
    assert rt.begin(rid, now=t0) is True
    rt.add_span(rid, "admission", t0, t0 + 0.002)
    rt.add_span(rid, "frame_decode", t0 + 0.0005, t0 + 0.0015)
    rt.add_span(rid, "queue_wait", t0 + 0.002, t0 + 0.003)
    rt.add_span(rid, "assembly", t0 + 0.003, t0 + 0.004)
    rt.add_span(rid, "dispatch", t0 + 0.004, t0 + 0.009)
    rt.add_span(rid, "device", t0 + 0.005, t0 + 0.008)
    rt.add_span(rid, "reply", t0 + 0.009, t0 + 0.010)
    rt.finish(rid, now=t0 + 0.010, model="m")


BUILDS = [_full_tree, _router_tree, _retry_tree, _wire_replica_tree]


# -- equal to JAX's ----------------------------------------------------------

@pytest.mark.parametrize("build", BUILDS, ids=lambda f: f.__name__)
def test_get_equals_jaxs(traced, build):
    build(reqtrace, "x1")
    build(jax_reqtrace, "x1")
    assert reqtrace.get("x1") == jax_reqtrace.get("x1")
    assert reqtrace.rids() == jax_reqtrace.rids()


@pytest.mark.parametrize("wait_s", [0.012, 0.008, 0.0])
@pytest.mark.parametrize("replica_build", [_full_tree, _wire_replica_tree],
                         ids=lambda f: f.__name__)
def test_stitch_equals_jaxs(traced, wait_s, replica_build):
    for rt in (reqtrace, jax_reqtrace):
        _router_tree(rt, "h", wait_s=wait_s)
        replica_build(rt, "rep")
    mine = reqtrace.stitch(reqtrace.get("h"), reqtrace.get("rep"),
                           replica="r1")
    theirs = jax_reqtrace.stitch(jax_reqtrace.get("h"),
                                 jax_reqtrace.get("rep"), replica="r1")
    assert mine == theirs
    # and each package stitches the other's payloads alike
    assert reqtrace.stitch(jax_reqtrace.get("h"), jax_reqtrace.get("rep"),
                           replica="r1") == theirs


def test_head_sampling_cursor_equals_jaxs(traced, monkeypatch):
    for r in (root, jax_root):
        monkeypatch.setattr(r.common.serving, "trace_sample_n", 3)
    calls = [("a", False), ("b", False), ("c", True), ("d", False),
             ("e", False), ("f", False), ("g", True), ("h", False)]
    got = [reqtrace.begin(rid, now=1.0, force=f) for rid, f in calls]
    want = [jax_reqtrace.begin(rid, now=1.0, force=f) for rid, f in calls]
    assert got == want
    assert reqtrace.rids() == jax_reqtrace.rids()


# -- the cases of tests/unit/test_reqtrace.py on the port --------------------

def test_tree_math_and_completeness(traced):
    _full_tree(traced, "r1")
    tree = traced.get("r1")
    assert tree["complete"] is True and tree["model"] == "m"
    assert tree["wall_ms"] == pytest.approx(10.0)
    assert tree["parts_ms"] == pytest.approx(10.0)
    assert tree["spans"][0]["kind"] == "admission"
    assert len(tree["traceEvents"]) == 6


def test_head_sampling_every_nth(traced, monkeypatch):
    monkeypatch.setattr(root.common.serving, "trace_sample_n", 3)
    hits = [traced.begin("s-%d" % i) for i in range(9)]
    assert hits == [True, False, False] * 3
    assert traced.rids() == ["s-6", "s-3", "s-0"]


def test_unknown_kind_is_loud(traced):
    traced.begin("r1")
    with pytest.raises(ValueError, match="unknown span kind"):
        traced.add_span("r1", "teleport", 0.0, 1.0)
    traced.begin("h3", origin="router")
    with pytest.raises(ValueError, match="unknown span kind"):
        traced.add_span("h3", "hyperspace", 0.0, 1.0)


def test_finished_tree_rejects_reused_rid_spans(traced):
    _full_tree(traced, "r1")
    assert traced.sampled("r1") is False
    assert traced.add_span("r1", "dispatch", 900.0, 901.0) is False
    assert len(traced.get("r1")["spans"]) == 6


def test_begin_never_clobbers_a_live_tree(traced):
    assert traced.begin("r1", now=50.0) is True
    assert traced.begin("r1", now=60.0) is False
    traced.add_span("r1", "dispatch", 50.001, 50.002)
    traced.finish("r1", now=50.01)
    assert traced.get("r1")["wall_ms"] == pytest.approx(10.0)
    assert traced.begin("r1", now=200.0) is True
    assert traced.get("r1")["spans"] == []


def test_ring_bounds_and_disabled_gate(traced, monkeypatch):
    for i in range(20):
        _full_tree(traced, "r%d" % i, t0=100.0 + i)
    assert len(traced.rids()) == 8 and traced.rids()[0] == "r19"
    assert traced.get("r0") is None
    monkeypatch.setattr(root.common.serving, "trace_sample_n", 0)
    assert traced.enabled() is False
    assert traced.begin("off") is False


def test_router_origin_and_retry_keep_the_partition(traced):
    _router_tree(traced, "h1")
    tree = traced.get("h1")
    assert tree["origin"] == "router" and tree["complete"] is True
    assert tree["wall_ms"] == pytest.approx(16.0)
    assert tree["parts_ms"] == pytest.approx(16.0)
    _retry_tree(traced, "h2")
    tree = traced.get("h2")
    assert tree["complete"] is True
    assert tree["parts_ms"] == pytest.approx(tree["wall_ms"])


def test_force_begin_bypasses_and_preserves_the_cursor(traced, monkeypatch):
    monkeypatch.setattr(root.common.serving, "trace_sample_n", 3)
    assert traced.begin("a") is True
    assert traced.begin("b") is False
    assert traced.begin("c", force=True) is True
    assert traced.begin("d") is False
    assert traced.begin("e") is True
    monkeypatch.setattr(root.common.serving, "trace_sample_n", 0)
    assert traced.begin("f", force=True) is False


def test_stitch_aligns_partitions_and_exports_two_tracks(traced):
    _router_tree(traced, "h4")
    _full_tree(traced, "rep", t0=900.0)
    stitched = traced.stitch(traced.get("h4"), traced.get("rep"),
                             replica="fleet-2")
    assert stitched["clock_offset_ms"] == pytest.approx(4.0)
    assert stitched["stitched"] is True and stitched["complete"] is True
    assert stitched["parts_ms"] == pytest.approx(16.0)
    by_kind = {}
    for span in stitched["spans"]:
        by_kind.setdefault(span["kind"], span)
    wait, anchor = by_kind["replica_wait"], by_kind["replica"]
    assert wait["start_ms"] <= anchor["start_ms"]
    assert anchor["start_ms"] + anchor["duration_ms"] <= \
        wait["start_ms"] + wait["duration_ms"] + 1e-6
    assert by_kind["admission"]["process"] == "replica"
    events = stitched["traceEvents"]
    assert {m["args"]["name"] for m in events if m["ph"] == "M"} == \
        {"router", "replica fleet-2"}
    assert {e["pid"] for e in events if e["ph"] == "X"} == {0, 1}
    jax_telemetry.validate_trace({"traceEvents": events})


def test_stitch_clamps_a_jitter_inflated_replica_wall(traced):
    _router_tree(traced, "h5", wait_s=0.008)
    _full_tree(traced, "rep2", t0=950.0)
    stitched = traced.stitch(traced.get("h5"), traced.get("rep2"),
                             replica="fleet-1")
    assert stitched["clock_offset_ms"] == pytest.approx(3.0)


def test_wire_kinds_nest_and_keep_both_partitions(traced):
    assert set(reqtrace.WIRE_SPAN_KINDS) == {"frame_decode", "relay_wait"}
    _wire_replica_tree(traced, "w2")
    tree = traced.get("w2")
    assert tree["complete"] is True
    assert tree["parts_ms"] == pytest.approx(10.0)
    _retry_tree(traced, "w3")
    tree = traced.get("w3")
    assert tree["parts_ms"] == pytest.approx(tree["wall_ms"])


def test_finish_sink_sees_every_closed_tree(traced):
    seen = []
    reqtrace.set_finish_sink(lambda rid, tree: seen.append((rid, tree)))
    try:
        _full_tree(traced, "k1")
        reqtrace.finish("k1")   # a second close is a no-op
    finally:
        reqtrace.set_finish_sink(None)
    assert seen == [("k1", reqtrace.get("k1"))]


# -- persisted through the blackbox, read by JAX's query ---------------------

@pytest.fixture
def armed_blackbox(tmp_path):
    node = root.common.telemetry.blackbox
    saved = {k: node.get(k) for k in ("enabled", "dir", "role")}
    tel = root.common.telemetry.get("enabled")
    blackbox.reset()
    blackbox.enable(dir=str(tmp_path / "bb"), role="fleet")
    root.common.telemetry.enabled = True
    yield str(tmp_path / "bb")
    blackbox.reset()
    for k, v in saved.items():
        setattr(node, k, v)
    root.common.telemetry.enabled = tel


def test_jax_query_rid_reads_the_ports_persisted_trees(traced,
                                                       armed_blackbox,
                                                       capsys):
    assert blackbox.maybe_arm()
    _router_tree(traced, "q-1")
    # the replica's tree of the same rid, as a replica process writes
    # it (its own ring: the router's tree is already closed here)
    _full_tree(jax_reqtrace, "q-1", t0=900.0)
    replica_tree = jax_reqtrace.get("q-1")
    blackbox._on_trace("q-1", replica_tree)
    blackbox.reset()
    theirs = jax_blackbox.query_rid(armed_blackbox, "q-1")
    assert theirs["stitched"] is not None
    assert theirs["stitched"]["span_kinds"] == sorted(
        set(reqtrace.ROUTER_SPAN_KINDS) - {"retry"} |
        set(reqtrace.SPAN_KINDS))
    capsys.readouterr()
    assert blackbox.cli_main(["--dir", armed_blackbox, "--rid", "q-1",
                              "--json"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert mine == json.loads(json.dumps(theirs, default=str))
