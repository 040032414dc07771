"""The port's release plane held to ``znicz_tpu``'s, decision for
decision, mirroring ``tests/unit/test_release.py`` case by case.

Each case builds twin planes: the JAX package's ``ReleaseController``
over a ``LocalTarget`` on its own ``ModelRegistry`` and ``SloTracker``,
and the port's over the port's, both on the same FC package (JAX's
``build_fc_package_zip``, seeded) and one fake clock.  The same
actions go to both: the same mirrored rows and rids, the same SLO
records, the same ticks.  After each step the two agree on the state,
``canary_pct``, the shadow judgement, ``route()`` for every rid, and at
the end on the journal's ``release.*`` events (kind, model, candidate,
generation, reason, exemplar rid).  Nothing sleeps: the port's
``drain_shadow`` waits for its shadow worker, and the JAX plane's queue
is judged in the test's thread (JAX's ``drain_shadow`` returns while
the last compare may still run, the race its own tests lose now and
then).
"""

import numpy
import pytest

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving import release as jax_release
from znicz_tpu.serving.registry import ModelRegistry as JaxRegistry
from znicz_tpu.serving.slo import SloTracker as JaxSlo
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu_torch.core import faults, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import release
from znicz_tpu_torch.serving.registry import ModelRegistry
from znicz_tpu_torch.serving.release import (
    ABORTED, CANARY, FAILED, PROMOTED, ROLLED_BACK, SHADOW, LocalTarget,
    ReleaseConflictError, ReleaseController, candidate_name,
    generation_label, generation_of, split_point)
from znicz_tpu_torch.serving.slo import SloTracker

N_IN, N_OUT = 6, 3
#: the JAX test's ladder
POLICY = {"canary_steps": [10.0, 50.0], "green_window_s": 5.0,
          "min_requests": 4, "shadow_min_compares": 3}


class FakeClock(object):
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def slo_on(monkeypatch):
    """The SLO judge and telemetry on, in both packages' configs."""
    for cfg in (root, jax_root):
        monkeypatch.setattr(cfg.common.serving, "slo_enabled", True)
        monkeypatch.setattr(cfg.common.telemetry, "enabled", True)
        # the tick loops parked: only the test's ticks judge, so the
        # two planes see the same sequence (the shadow workers run)
        monkeypatch.setattr(cfg.common.serving.release, "tick_interval_s",
                            3600.0)
    telemetry.reset()
    jax_telemetry.reset()


def _zip(tmp_path, name, seed):
    return build_fc_package_zip(str(tmp_path / name), [N_IN, 8, N_OUT],
                                seed=seed)


class _Side(object):
    """One package's plane: registry, tracker, controller."""

    def __init__(self, registry, tracker, ctl, mod, journal):
        self.registry = registry
        self.tracker = tracker
        self.ctl = ctl
        self.mod = mod
        self.journal = journal

    @property
    def rel(self):
        return self.ctl._active.get("m") or self.ctl._done.get("m")


class Twins(object):
    """The JAX plane and the port's, one clock, the same actions."""

    def __init__(self, tmp_path, threads=True):
        self.tmp = tmp_path
        self.clock = FakeClock()
        live = _zip(tmp_path, "live.zip", seed=42)
        jreg = JaxRegistry(max_batch=8, warmup=False)
        jreg.add("m", live)
        preg = ModelRegistry(max_batch=8, warmup=False, device="cpu")
        preg.add("m", live)
        jslo, pslo = JaxSlo(clock=self.clock), SloTracker(clock=self.clock)
        jctl = jax_release.ReleaseController(
            jax_release.LocalTarget(jreg, jslo), clock=self.clock)
        pctl = ReleaseController(LocalTarget(preg, pslo), clock=self.clock)
        if threads:
            pctl.start()
        self.jax = _Side(jreg, jslo, jctl, jax_release,
                         jax_telemetry.journal_events)
        self.port = _Side(preg, pslo, pctl, release,
                          telemetry.journal_events)
        self.sides = (self.jax, self.port)

    def stop(self):
        for side in self.sides:
            side.ctl.stop()

    def judge(self):
        """Every mirrored pair judged: the port's by its worker, the JAX
        plane's here, as its worker would (an exception is a shadow
        error)."""
        assert self.port.ctl.drain_shadow()
        ctl = self.jax.ctl
        while ctl._queue:
            item = ctl._queue.popleft()
            try:
                ctl._compare(*item)
            except Exception:  # noqa: BLE001 - as JAX's _shadow_loop
                item[0].shadow_errors += 1

    def both(self, fn):
        return [fn(side) for side in self.sides]

    def start(self, cand_seed=42, policy=POLICY):
        cand = _zip(self.tmp, "cand%d.zip" % cand_seed, seed=cand_seed)
        got = self.both(lambda s: s.ctl.start_release("m", cand,
                                                      policy=policy))
        assert _status(got[0]) == _status(got[1])
        return got[1]

    def tick(self):
        self.both(lambda s: s.ctl.tick())
        self.agree()

    def advance(self, dt):
        self.clock.advance(dt)

    def mirror_live(self, n, seed0=0):
        """n live (request, reply) pairs mirrored on each side, and the
        shadow workers drained."""
        for side in self.sides:
            engine = side.registry.engine("m")
            for i in range(n):
                x = _x(seed0 + i)
                assert side.ctl.mirror("m", "rid-%d" % i, x,
                                       engine.predict(x))
        self.judge()
        self.agree()

    def record(self, name, status, n, prefix):
        for side in self.sides:
            for i in range(n):
                side.tracker.record(name, status, 1.0,
                                    rid="%s-%d" % (prefix, i))

    def drive_canary_step(self, n=6):
        rel = self.port.rel
        self.record(rel.cand_name, 200, n, "c-%d" % rel.step_idx)
        self.tick()
        self.advance(6.0)
        self.tick()

    def agree(self):
        """The two planes' releases agree field by field."""
        j, p = self.jax.rel, self.port.rel
        assert (j is None) == (p is None)
        if p is None:
            return
        for attr in ("state", "canary_pct", "step_idx", "cand_name",
                     "generation", "shadow_compares", "shadow_mismatches",
                     "shadow_errors", "shadow_dropped", "mismatch_buckets",
                     "last_mismatch_rid", "reason", "green_since"):
            assert getattr(j, attr) == getattr(p, attr), attr
        assert _signals(j.last_signals) == _signals(p.last_signals)
        assert self.jax.ctl.active() == self.port.ctl.active()

    def events(self):
        out = []
        for side in self.sides:
            out.append([(e["kind"], e.get("model"), e.get("candidate"),
                         e.get("generation"), e.get("reason"),
                         e.get("exemplar_rid"))
                        for e in side.journal()
                        if e["kind"].startswith("release.")])
        assert out[0] == out[1]
        return out[1]


def _status(st):
    """A status without its source path (the same file either way)."""
    return {k: v for k, v in st.items() if k not in ("source",)}


def _signals(sig):
    return {k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in (sig or {}).items()}


def _x(seed, rows=4):
    return numpy.random.RandomState(seed).uniform(
        -1.0, 1.0, (rows, N_IN)).astype(numpy.float32)


@pytest.fixture
def twins(tmp_path, slo_on):
    t = Twins(tmp_path)
    try:
        yield t
    finally:
        t.stop()


# -- the pure helpers ---------------------------------------------------------

def test_name_and_label_helpers_equal_jaxs():
    for fn, args in ((candidate_name, ("wine", 2)),
                     (generation_of, ("wine.gen3",)),
                     (generation_of, ("wine",)),
                     (generation_label, ("wine.gen7", 1)),
                     (generation_label, ("wine", 4))):
        assert fn(*args) == getattr(jax_release, fn.__name__)(*args)
    assert candidate_name("wine", 2) == "wine.gen3"
    assert generation_label("wine.gen7", 1) == "gen_7"


def test_split_point_and_shadow_sampling_equal_jaxs():
    rids = ["req-%d" % i for i in range(2000)] + ["", "é-1", "shadow-x"]
    assert [split_point(r) for r in rids] == \
        [jax_release.split_point(r) for r in rids]
    for pct in (0.0, 10.0, 50.0, 99.9, 100.0):
        assert [release._shadow_sampled(r, pct) for r in rids] == \
            [jax_release._shadow_sampled(r, pct) for r in rids]
    frac = sum(split_point(r) < 10.0 for r in rids) / len(rids)
    assert 0.06 < frac < 0.14, frac


@pytest.mark.parametrize("dtype", [None, "f32", "f32-fast", "f32_fast",
                                   "bf16", "int8"])
def test_tolerances_equal_jaxs(dtype):
    assert release._tolerance(dtype) == jax_release._tolerance(dtype)


# -- the lifecycle ------------------------------------------------------------

def test_healthy_release_walks_the_ladder_to_promoted(twins):
    v_live = twins.port.registry.peek("m").version
    st = twins.start()
    assert st["state"] == SHADOW and st["candidate"] == "m.gen%d" % (
        v_live + 1)
    twins.mirror_live(4)
    assert twins.port.rel.shadow_compares == 4
    assert twins.port.rel.shadow_mismatches == 0
    twins.tick()
    assert twins.port.rel.state == SHADOW
    twins.advance(6.0)
    twins.tick()
    assert (twins.port.rel.state, twins.port.rel.canary_pct) == \
        (CANARY, 10.0)
    twins.drive_canary_step()
    assert (twins.port.rel.state, twins.port.rel.canary_pct) == \
        (CANARY, 50.0)
    twins.drive_canary_step()
    assert twins.port.rel.state == PROMOTED
    for side in twins.sides:
        assert side.registry.peek("m").version == v_live + 1
        assert side.rel.cand_name not in side.registry
        assert side.ctl.status("m")["state"] == PROMOTED
    kinds = [e[0] for e in twins.events()]
    assert kinds[0] == "release.start" and kinds[-1] == "release.promote"
    assert kinds.count("release.advance") == 2


def test_green_window_resets_on_red(twins):
    twins.start()
    twins.tick()                   # 0 compares: red
    twins.advance(100.0)
    twins.tick()
    assert twins.port.rel.state == SHADOW
    twins.mirror_live(4)
    twins.tick()                   # green starts now
    twins.advance(4.0)
    twins.tick()
    assert twins.port.rel.state == SHADOW
    twins.advance(2.0)
    twins.tick()
    assert twins.port.rel.state == CANARY
    twins.events()


def test_hold_policy_pins_the_release_in_shadow(twins):
    twins.start(policy=dict(POLICY, hold=True))
    twins.mirror_live(6)
    twins.tick()
    twins.advance(60.0)
    twins.tick()
    assert twins.port.rel.state == SHADOW
    got = twins.both(lambda s: s.ctl.abort("m")["state"])
    assert got == [ABORTED, ABORTED]
    twins.events()


def test_mutations_racing_a_release_conflict_loudly(twins):
    live = _zip(twins.tmp, "l2.zip", seed=42)
    other = _zip(twins.tmp, "other.zip", seed=7)
    twins.start(policy=None)
    for side in twins.sides:
        conflict = (ReleaseConflictError if side is twins.port
                    else jax_release.ReleaseConflictError)
        reg = side.registry
        for fn in (lambda: reg.reload("m", live),
                   lambda: reg.reload(None, live),
                   lambda: reg.add("m", live),
                   lambda: reg.add("m.gen2", live),
                   lambda: reg.remove("m.gen2")):
            with pytest.raises(conflict):
                fn()
        with pytest.raises(conflict):
            side.ctl.start_release("m", live)
        reg.add("other", other)
        reg.remove("other")
        side.ctl.abort("m")
        reg.reload("m", live)        # the guard stood down
    twins.events()


def test_release_requires_the_slo_judge(twins, monkeypatch):
    for cfg in (root, jax_root):
        monkeypatch.setattr(cfg.common.serving, "slo_enabled", False)
    cand = _zip(twins.tmp, "cand.zip", seed=42)
    for side in twins.sides:
        with pytest.raises(ValueError):
            side.ctl.start_release("m", cand)


# -- the ends -----------------------------------------------------------------

def test_candidate_dies_mid_shadow_is_failed_not_rollback(twins):
    x = _x(123)
    before = twins.both(lambda s: s.registry.engine("m").predict(x))
    twins.start()
    for side in twins.sides:
        with side.ctl._as_controller():
            side.registry.remove(side.rel.cand_name)
    twins.tick()
    assert twins.port.rel.state == FAILED
    assert "died during shadow" in twins.port.rel.reason
    after = twins.both(lambda s: s.registry.engine("m").predict(x))
    assert numpy.array_equal(after[1], before[1])
    kinds = [e[0] for e in twins.events()]
    assert "release.failed" in kinds and "release.rollback" not in kinds


def test_shadow_mismatch_breach_rolls_back_with_exemplar(twins):
    twins.start(cand_seed=7)
    twins.mirror_live(3)
    assert twins.port.rel.shadow_mismatches > 0
    twins.tick()
    assert twins.port.rel.state == ROLLED_BACK
    assert "mismatch breach" in twins.port.rel.reason
    for side in twins.sides:
        assert side.rel.cand_name not in side.registry
    events = twins.events()
    rollback = [e for e in events if e[0] == "release.rollback"][0]
    assert rollback[5].startswith("rid-")
    mm = [e for e in telemetry.journal_events()
          if e["kind"] == "release.shadow_mismatch"][0]
    jmm = [e for e in jax_telemetry.journal_events()
           if e["kind"] == "release.shadow_mismatch"][0]
    assert mm["bucket"] == jmm["bucket"] == "4"
    assert mm["max_delta"] > 0 and mm["tolerance"] == jmm["tolerance"]
    # the same rows through the same two packages: the same deltas
    assert mm["max_delta"] == pytest.approx(jmm["max_delta"], abs=1e-5)


def test_shadow_errors_fail_the_release(twins):
    twins.start(policy=dict(POLICY, shadow_error_max=1))
    for side in twins.sides:
        y = side.registry.engine("m").predict(_x(0))
        for i in range(3):
            bad = numpy.zeros((4, N_IN + 1), dtype=numpy.float32)
            assert side.ctl.mirror("m", "bad-%d" % i, bad, y)
    twins.judge()
    twins.agree()
    assert twins.port.rel.shadow_errors == 3
    twins.tick()
    assert twins.port.rel.state == FAILED
    twins.events()


def _to_canary(twins):
    twins.mirror_live(4)
    twins.tick()
    twins.advance(6.0)
    twins.tick()
    assert twins.port.rel.state == CANARY


def test_burn_breach_during_canary_rolls_back(twins):
    twins.start()
    _to_canary(twins)
    cand = twins.port.rel.cand_name
    twins.record(cand, 500, 20, "burn")
    assert twins.port.tracker.status()["models"][cand]["burning"]
    twins.tick()
    assert twins.port.rel.state == ROLLED_BACK
    assert "burn breach" in twins.port.rel.reason
    assert twins.port.rel.last_signals["burn_fast"] > 0
    for side in twins.sides:
        assert cand not in side.registry
    twins.events()


def test_candidate_dies_mid_canary_is_failed(twins):
    twins.start()
    _to_canary(twins)
    for side in twins.sides:
        with side.ctl._as_controller():
            side.registry.remove(side.rel.cand_name)
    twins.tick()
    assert twins.port.rel.state == FAILED
    for side in twins.sides:
        assert all(side.ctl.route("m", "r-%d" % i) is None
                   for i in range(50))
    twins.events()


# -- the data-plane hooks -----------------------------------------------------

def test_route_splits_deterministically_and_only_in_canary(twins):
    twins.start()
    rids = ["r-%d" % i for i in range(400)]
    for side in twins.sides:
        assert all(side.ctl.route("m", r) is None for r in rids[:20])
    _to_canary(twins)
    assert twins.port.rel.canary_pct == 10.0
    routed = twins.both(lambda s: {r: s.ctl.route("m", r) for r in rids})
    assert routed[0] == routed[1]
    assert routed[1] == {r: twins.port.ctl.route("m", r) for r in rids}
    hits = [r for r in rids if routed[1][r] == twins.port.rel.cand_name]
    assert all(split_point(r) < 10.0 for r in hits)
    assert 0.04 < len(hits) / len(rids) < 0.18
    assert twins.port.ctl.route("other", rids[0]) is None
    # None routes through the target's default model, as in JAX
    assert twins.both(lambda s: [s.ctl.route(None, r) for r in rids[:50]]) \
        == [[routed[1][r] for r in rids[:50]]] * 2


def test_wants_mirror_only_for_a_sampled_rid_in_shadow(twins):
    """``wants_mirror`` answers what ``mirror`` would take, so a caller
    copies a request only then: nothing before a release, a sampled rid
    in shadow, nothing in canary."""
    ctl, rids = twins.port.ctl, ["w-%d" % i for i in range(200)]
    assert not any(ctl.wants_mirror("m", r) for r in rids)
    twins.start()
    twins.port.rel.policy["shadow_sample_pct"] = 50.0
    sampled = [release._shadow_sampled(r, 50.0) for r in rids]
    assert 0 < sum(sampled) < len(rids)
    assert [ctl.wants_mirror("m", r) for r in rids] == sampled
    assert [ctl.wants_mirror(None, r) for r in rids] == sampled
    assert not ctl.wants_mirror("other", rids[sampled.index(True)])
    twins.port.rel.policy["shadow_sample_pct"] = 100.0
    twins.jax.rel.policy["shadow_sample_pct"] = 100.0
    _to_canary(twins)
    assert not any(ctl.wants_mirror("m", r) for r in rids)


def test_mirror_samples_and_drops_instead_of_blocking(slo_on, tmp_path):
    """No shadow worker: the queue caps at 128 and the rest drop,
    counted; at 0% nothing is queued."""
    twins = Twins(tmp_path, threads=False)
    twins.start(policy=None)
    x, y = _x(0), numpy.zeros((4, N_OUT))
    got = twins.both(lambda s: [s.ctl.mirror("m", "q-%d" % i, x, y)
                                for i in range(140)])
    assert got[0] == got[1]
    assert len(twins.port.ctl._queue) == release.SHADOW_QUEUE == 128
    twins.agree()
    assert twins.port.rel.shadow_dropped == 12
    for side in twins.sides:
        side.rel.policy["shadow_sample_pct"] = 0.0
        assert not side.ctl.mirror("m", "sampled-out", x, y)
        assert len(side.ctl._queue) == 128
    snap = telemetry.snapshot()["counters"]
    assert snap["release.shadow_dropped.gen_2.model_m"] == 12


def test_status_surface_and_unknown_model(twins):
    for side in twins.sides:
        with pytest.raises(KeyError):
            side.ctl.status("ghost")
        with pytest.raises(KeyError):
            side.ctl.abort("m")
    twins.start()
    st = twins.both(lambda s: s.ctl.status())
    assert set(st[1]) == {"active", "recent"}
    assert _status(st[0]["active"]["m"]) == _status(st[1]["active"]["m"])
    assert st[1]["active"]["m"]["shadow"]["tolerance"] == \
        {"max_delta": 0.0, "flip_rate": 0.0}
    twins.both(lambda s: s.ctl.abort("m"))
    for side in twins.sides:
        assert side.ctl.status("m")["state"] == ABORTED
        assert side.ctl.status()["recent"]["m"]["reason"] == \
            "operator abort"
    twins.events()


def test_gauges_follow_the_state(twins):
    twins.start()
    _to_canary(twins)
    gauges = telemetry.snapshot()["gauges"]
    jgauges = jax_telemetry.snapshot()["gauges"]
    for name in ("release.state.gen_2.model_m",
                 "release.canary_pct.gen_2.model_m"):
        assert gauges[name] == jgauges[name]
    assert gauges["release.state.gen_2.model_m"] == 2
    assert gauges["release.canary_pct.gen_2.model_m"] == 10.0
    counters = telemetry.snapshot()["counters"]
    assert counters["release.shadow_compares.gen_2.model_m"] == 4


def test_per_model_fault_site_hits_only_the_named_engine(
        slo_on, tmp_path, monkeypatch):
    """A fault at ``serving.forward.<name>`` breaks that engine only:
    its live peer in the same registry keeps serving."""
    registry = ModelRegistry(max_batch=8, warmup=False, device="cpu")
    registry.add("m", _zip(tmp_path, "live.zip", seed=42))
    registry.add("m.gen2", _zip(tmp_path, "cand.zip", seed=42))
    monkeypatch.setattr(root.common.retry, "attempts", 0)
    monkeypatch.setattr(root.common.faults, "enabled", True)
    faults.install("serving.forward.m.gen2", kind="xla", every=1)
    try:
        x = _x(3)
        assert registry.engine("m").predict(x).shape == (4, N_OUT)
        with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
            registry.engine("m.gen2").predict(x)
        assert faults.status()["sites"][
            "serving.forward.m.gen2"]["injected"] >= 1
        faults.clear("serving.forward.m.gen2")
        assert registry.engine("m.gen2").predict(x).shape == (4, N_OUT)
    finally:
        faults.clear()


# -- the port's bucket pin ----------------------------------------------------

def test_shadow_compare_replays_the_live_bucket(slo_on, tmp_path):
    """A mirrored pair carries the bucket its live batch ran at, and the
    candidate is asked for that bucket: the compare is bit for bit at
    the padding the live reply had."""
    twins = Twins(tmp_path, threads=False)
    twins.start(policy=None)
    side = twins.port
    cand = side.registry.engine("m.gen2")
    seen = []
    real = cand.predict

    def spy(x, request_ids=None, bucket=None):
        seen.append(bucket)
        return real(x, request_ids=request_ids, bucket=bucket)

    cand.predict = spy
    x = _x(5, rows=3)
    y8 = side.registry.engine("m").predict(x, bucket=8)
    assert side.ctl.mirror("m", "pinned", x, y8, bucket=8)
    side.ctl._compare(*side.ctl._queue.popleft())
    assert seen == [8]
    assert side.rel.shadow_compares == 1
    assert side.rel.shadow_mismatches == 0
    assert cand.stats()["warm_buckets"] == [8]


def test_busy_covers_the_deploy_the_release_and_a_grace(slo_on, tmp_path):
    """The port's ``busy(within_s)`` (the autoscaler's scale-down hold):
    true while ``start_release`` deploys, while the release is active,
    and for ``within_s`` of the controller's clock after it ended."""
    twins = Twins(tmp_path, threads=False)
    ctl, clock = twins.port.ctl, twins.clock
    assert not ctl.busy(10.0)
    seen = []
    real = ctl._target.deploy

    def deploy(name, source):
        seen.append(ctl.busy())
        return real(name, source)
    ctl._target.deploy = deploy
    twins.start(policy=None)
    assert seen == [True] and ctl.busy()
    ctl.abort("m")
    assert ctl.busy(10.0) and not ctl.busy(0.0)
    clock.advance(10.0)
    assert not ctl.busy(10.0)
