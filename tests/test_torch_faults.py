"""The port's fault-injection registry and transient retry
(``znicz_tpu_torch.core.faults``) against ``znicz_tpu.core.faults``.

Each rule form (``at``, ``every``, ``every`` with ``times``, ``p`` from
a rule seed or from ``common.faults.seed``, ``p`` with ``times``, and a
``stall``) is installed in both packages and hit 1,000 times: the
invocations it fires on are the same.  The rest mirrors
``tests/unit/test_faults.py`` case by case on the port: the disabled
path never reaches :func:`faults.check`, ``at`` fires once, ``times``
caps, a seeded ``p`` replays, ``stall`` sleeps, config-declared rules
are adopted (also when declared late), the transient classifier (and
``torch.cuda.OutOfMemoryError``, the port's counterpart of XLA's
RESOURCE_EXHAUSTED), the bounded backoff of :func:`faults.retry_call`,
and the counters and journal events.

``faults_health_isolated`` (autouse here, imported by the other
``test_torch_*`` files of the training control plane) resets both
packages' fault registries, health monitors, journals and their
``common.faults`` / ``common.health`` / ``common.retry`` /
``common.telemetry`` nodes after each test, and points both packages'
crash reports under the test's ``tmp_path``.
"""

import contextlib
import copy

import numpy
import pytest
import torch

from znicz_tpu.core import faults as jax_faults
from znicz_tpu.core import health as jax_health
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import Config as JaxConfig
from znicz_tpu.core.config import root as jax_root
from znicz_tpu_torch.core import faults, health, telemetry
from znicz_tpu_torch.core.config import Config, root

INVOCATIONS = 1000


def _values(node):
    """A node's values, its child nodes' in place of the nodes."""
    return {k: _values(v) if isinstance(v, (Config, JaxConfig))
            else copy.deepcopy(v) for k, v in node.__dict__.items()
            if not (k.startswith("_") and k.endswith("_"))}


def _put_back(node, values):
    """Put :func:`_values` back into the same node objects: modules hold
    references to the nodes (``_cfg = root.common.telemetry.<x>``), so
    a node is never replaced."""
    for k in [k for k, v in node.__dict__.items()
              if k not in values and not (k.startswith("_")
                                          and k.endswith("_"))]:
        del node.__dict__[k]
    for k, v in values.items():
        child = node.__dict__.get(k)
        if isinstance(v, dict) and isinstance(child, (Config, JaxConfig)):
            _put_back(child, v)
        else:
            object.__setattr__(node, k, v)


@contextlib.contextmanager
def _nodes_restored(*nodes):
    saved = [(n, _values(n)) for n in nodes]
    try:
        yield
    finally:
        for n, values in saved:
            _put_back(n, values)


@pytest.fixture(autouse=True)
def faults_health_isolated(tmp_path):
    nodes = [r.common.faults for r in (root, jax_root)] + \
        [r.common.health for r in (root, jax_root)] + \
        [r.common.retry for r in (root, jax_root)] + \
        [r.common.telemetry for r in (root, jax_root)]
    with _nodes_restored(*nodes):
        for r in (root, jax_root):
            r.common.health.crash_dir = str(tmp_path / "crash")
        yield
    object.__setattr__(root.common.faults, "rules",
                       Config("root.common.faults.rules"))
    object.__setattr__(jax_root.common.faults, "rules",
                       JaxConfig("root.common.faults.rules"))
    for mod in (faults, jax_faults, health, jax_health):
        mod.reset()
    for mod in (telemetry, jax_telemetry):
        mod.reset()


def _fired(mod, site, n=INVOCATIONS):
    """The 1-based invocations of ``site`` that raise an injected fault
    (or, for a stall, that count as injected)."""
    fired = []
    for i in range(1, n + 1):
        before = mod.status()["sites"].get(site, {}).get("injected", 0)
        try:
            mod.check(site)
        except mod.FaultInjectedError:
            fired.append(i)
            continue
        if mod.status()["sites"][site]["injected"] != before:
            fired.append(i)
    return fired


RULE_FORMS = {
    "at": {"kind": "io", "at": 417},
    "every": {"kind": "xla", "every": 7},
    "every_times": {"kind": "crash", "every": 3, "times": 5},
    "p_seeded": {"kind": "io", "p": 0.1, "seed": 42},
    "p_config_seed": {"kind": "xla", "p": 0.05},
    "p_times": {"kind": "io", "p": 0.3, "seed": 7, "times": 12},
    "stall": {"kind": "stall", "every": 250, "stall_ms": 0.0},
}


@pytest.mark.parametrize("form", sorted(RULE_FORMS))
def test_rules_fire_at_the_same_invocations_as_jax(form):
    spec = RULE_FORMS[form]
    got = {}
    for mod, cfg in ((faults, root), (jax_faults, jax_root)):
        cfg.common.faults.seed = 1234
        mod.install("x.site", **spec)
        cfg.common.faults.enabled = True
        got[mod] = _fired(mod, "x.site")
    assert got[faults] == got[jax_faults]
    assert got[faults], "the rule never fired"
    if "times" in spec:
        assert len(got[faults]) == spec["times"]
    if "at" in spec:
        assert got[faults] == [spec["at"]]


def test_status_matches_jax():
    for mod, cfg in ((faults, root), (jax_faults, jax_root)):
        mod.install("s.one", kind="io", every=2, times=1)
        mod.install("s.two", kind="stall", at=1, stall_ms=0.0)
        cfg.common.faults.enabled = True
        for site in ("s.one", "s.two", "s.one", "s.none"):
            try:
                mod.check(site)
            except mod.FaultInjectedError:
                pass
    assert faults.status() == jax_faults.status()


def test_disabled_is_default_and_check_unreached(monkeypatch):
    assert not faults.enabled()
    monkeypatch.setattr(faults, "check", lambda site: (_ for _ in ()).throw(
        AssertionError("check() on a disabled path")))
    from znicz_tpu_torch.loader.base import Loader

    class L(Loader):
        filled = 0

        def load_data(self):
            self.class_lengths = [0, 0, 8]

        def create_minibatch_data(self):
            self.minibatch_data.reset(numpy.zeros((4, 2), numpy.float32))

        def fill_minibatch(self):
            L.filled += 1

    loader = L(None, minibatch_size=4)
    loader.initialize()
    loader.run()
    assert L.filled == 1
    assert faults.status()["enabled"] is False
    assert faults.status()["sites"] == {}


def test_at_step_fires_exactly_once():
    faults.install("x.site", kind="io", at=3)
    root.common.faults.enabled = True
    for i in range(1, 10):
        if i == 3:
            with pytest.raises(faults.InjectedIOError):
                faults.check("x.site")
        else:
            faults.check("x.site")
    assert faults.status()["sites"]["x.site"] == {"invocations": 9,
                                                  "injected": 1}


def test_every_k_with_times_cap():
    faults.install("x.every", kind="io", every=2, times=2)
    root.common.faults.enabled = True
    assert _fired(faults, "x.every", 8) == [2, 4]


def test_seeded_probability_replays_exactly():
    def run():
        faults.reset()
        faults.install("x.p", kind="io", p=0.5, seed=42)
        return _fired(faults, "x.p", 32)

    root.common.faults.enabled = True
    a, b = run(), run()
    assert a == b and a


def test_stall_sleeps_instead_of_raising(monkeypatch):
    import time as time_mod
    slept = []
    monkeypatch.setattr(time_mod, "sleep", lambda s: slept.append(s))
    faults.install("x.stall", kind="stall", every=1, stall_ms=25.0)
    root.common.faults.enabled = True
    assert faults.check("x.stall") is None
    assert slept == [0.025]


def test_config_declared_rules_adopted():
    root.common.faults.rules = {"cfg.site": {"kind": "crash", "at": 1}}
    root.common.faults.enabled = True
    with pytest.raises(faults.InjectedCrashError):
        faults.check("cfg.site")


def test_config_rules_declared_late_arm_the_site():
    root.common.faults.enabled = True
    assert faults.check("late.site") is None
    root.common.faults.rules = {"late.site": {"kind": "crash", "every": 1}}
    with pytest.raises(faults.InjectedCrashError):
        faults.check("late.site")


def test_cli_override_arms_a_rule():
    """``--config "common.faults.rules={...}"`` (the chaos CLI's form)
    declares a rule the registry adopts."""
    from znicz_tpu_torch.core.config import apply_override
    apply_override("common.faults.enabled=True")
    apply_override("common.faults.rules={'cli.site': "
                   "{'kind': 'xla', 'at': 2}}")
    faults.check("cli.site")
    with pytest.raises(faults.InjectedXlaError, match="RESOURCE_EXHAUSTED"):
        faults.check("cli.site")


def test_transient_classifier():
    assert faults.is_transient(faults.InjectedIOError("disk hiccup"))
    assert faults.is_transient(OSError("real I/O"))
    assert faults.is_transient(
        faults.InjectedXlaError("RESOURCE_EXHAUSTED: oom"))
    assert not faults.is_transient(faults.InjectedXlaError("INVALID"))
    assert not faults.is_transient(faults.InjectedCrashError("boom"))
    assert not faults.is_transient(ValueError("shape"))
    assert not faults.is_transient(FileNotFoundError("gone.npy"))
    assert not faults.is_transient(PermissionError("locked"))
    # the card's out-of-memory error, the port's RESOURCE_EXHAUSTED
    assert faults.is_transient(torch.cuda.OutOfMemoryError("CUDA OOM"))
    assert not faults.is_transient(RuntimeError("CUDA error: misaligned"))


@pytest.mark.parametrize("exc", [
    faults.InjectedIOError("x"), OSError("x"), FileNotFoundError("x"),
    faults.InjectedCrashError("x"), ValueError("x"),
    faults.InjectedXlaError("RESOURCE_EXHAUSTED: x")])
def test_classifier_agrees_with_jax(exc):
    jax_exc = {faults.InjectedIOError: jax_faults.InjectedIOError,
               faults.InjectedCrashError: jax_faults.InjectedCrashError,
               faults.InjectedXlaError: jax_faults.InjectedXlaError}.get(
                   type(exc), type(exc))(*exc.args)
    assert faults.is_transient(exc) == jax_faults.is_transient(jax_exc)


def test_retry_call_recovers_and_is_bounded(monkeypatch):
    import time as time_mod
    delays = []
    monkeypatch.setattr(time_mod, "sleep", lambda s: delays.append(s))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient %d" % calls["n"])
        return "ok"

    assert faults.retry_call(flaky, "t.site", attempts=3) == "ok"
    assert calls["n"] == 3
    assert delays == [0.005, 0.01]   # base 5 ms, doubling
    assert faults.status()["retries"] == 2

    def always():
        raise OSError("forever")

    with pytest.raises(OSError):
        faults.retry_call(always, "t.site", attempts=2)

    def terminal():
        calls["n"] += 1
        raise ValueError("not transient")

    calls["n"] = 0
    with pytest.raises(ValueError):
        faults.retry_call(terminal, "t.site", attempts=5)
    assert calls["n"] == 1


def test_retry_backoff_is_capped(monkeypatch):
    import time as time_mod
    delays = []
    monkeypatch.setattr(time_mod, "sleep", lambda s: delays.append(s))
    root.common.retry.backoff_max_ms = 12.0

    def always():
        raise OSError("forever")

    with pytest.raises(OSError):
        faults.retry_call(always, "t.site", attempts=4)
    assert delays == [0.005, 0.01, 0.012, 0.012]


def test_injection_metered_and_journaled():
    root.common.telemetry.enabled = True
    telemetry.reset()
    faults.install("m.site", kind="io", at=1)
    root.common.faults.enabled = True
    with pytest.raises(faults.InjectedIOError):
        faults.check("m.site")
    assert telemetry.counter("faults.injected").value == 1
    assert telemetry.counter("faults.injected.site_m.site").value == 1
    events = [e for e in telemetry.journal_events()
              if e["kind"] == "fault.injected"]
    assert events and events[0]["site"] == "m.site"
    assert events[0]["fault"] == "io" and events[0]["invocation"] == 1


def test_journal_records_with_only_faults_enabled():
    telemetry.reset()
    assert not telemetry.journal_enabled()
    root.common.faults.enabled = True
    assert telemetry.journal_enabled()
    faults.install("j.site", kind="stall", at=10 ** 9)
    faults.check("j.site")
    telemetry.record_event("test.event", x=1)
    assert any(e["kind"] == "test.event"
               for e in telemetry.journal_events())


def test_journal_ring_drops_oldest(tmp_path):
    root.common.telemetry.journal_capacity = 3
    telemetry.reset()
    telemetry.enable()
    for i in range(5):
        telemetry.record_event("e", i=i)
    assert [e["i"] for e in telemetry.journal_events()] == [2, 3, 4]
    assert telemetry.journal_dropped() == 2
    path = telemetry.export_journal(str(tmp_path / "j" / "events.jsonl"))
    with open(path) as f:
        assert len(f.read().splitlines()) == 3
