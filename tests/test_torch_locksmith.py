"""The port's lock-order sanitizer (``znicz_tpu_torch.analysis.
locksmith``) against the JAX package's.

* The locksmith cases of ``tests/unit/test_graftlint.py`` case for
  case: ABBA, blocking under a lock, ``Condition.wait`` releasing its
  own lock, RLock re-entry, a plain lock taken again by its holder,
  the disabled path's one predicate, ``arm`` wrapping the module locks,
  the wrappers' API, ``disarm`` restoring ``Future.result``, the
  engine's ladder adoption waiting for the load lock, armed batcher
  traffic.
* The same ABBA and blocking scenarios under both sanitizers find the
  same kinds of violation on the same role edges.
* Both trees walked with ``ast``: every role the JAX package makes a
  lock for is made at its counterpart site in the port, and the
  port's own roles are named here.
* The port's places to watch: the warm-up thread's ``future.result()``
  reached under a tracked lock is recorded, a registry reload, restore
  and budget eviction run clean, and a nested profiler capture is
  refused by a try-acquire, which records no cycle.

:func:`armed_clean` is the arming the port's serving tests take
(``test_torch_serving_registry.py``, ``test_torch_engine.py``).
"""

import ast
import concurrent.futures
import contextlib
import importlib
import os
import threading

import numpy
import pytest

from znicz_tpu.analysis import locksmith as jax_locksmith
from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every module whose lock arm() wraps, imported at collection, before
#: any test arms the sanitizer (a module first imported while armed
#: keeps a tracked lock for good)
for _modname, _, _ in locksmith._MODULE_LOCKS:
    importlib.import_module(_modname)


@contextlib.contextmanager
def armed_clean():
    """Arm the port's sanitizer around a ``with`` body; at the exit
    disarm it and raise :class:`locksmith.LockOrderViolation` if the
    body's threads took locks in a cyclic order or blocked under one
    (as the JAX package's conftest arms its serving tests)."""
    locksmith.reset()
    locksmith.arm()
    try:
        yield locksmith
    finally:
        locksmith.disarm()
    try:
        locksmith.assert_clean()
    finally:
        locksmith.reset()


@pytest.fixture()
def armed():
    locksmith.reset()
    locksmith.arm()
    yield locksmith
    locksmith.disarm()
    locksmith.reset()


def _run(fn):
    t = threading.Thread(target=fn, name="znicz:test-locks")
    t.start()
    t.join()


# ---------------------------------------------------------------------------
# The JAX package's locksmith cases
# ---------------------------------------------------------------------------

def test_detects_abba_cycle(armed):
    A, B = locksmith.lock("lockA"), locksmith.lock("lockB")

    def ab():
        with A:
            with B:
                pass

    def ba():
        with B:
            with A:
                pass

    for fn in (ab, ba):
        _run(fn)
    rep = locksmith.report()
    assert len(rep["cycles"]) == 1
    c = rep["cycles"][0]
    assert set(c["cycle"]) == {"lockA", "lockB"}
    assert "ab" in c["reverse_acquire_stack"] or \
        "ab" in c["reverse_held_stack"]
    assert "ba" in c["acquire_stack"]
    with pytest.raises(locksmith.LockOrderViolation) as ei:
        locksmith.assert_clean()
    assert "lock-order cycle" in str(ei.value)


def test_detects_blocking_under_lock(armed):
    L = locksmith.lock("serving.registry")
    fut = concurrent.futures.Future()
    fut.set_result(42)

    def offender():
        with L:
            assert fut.result() == 42

    _run(offender)
    rep = locksmith.report()
    assert len(rep["blocking"]) == 1
    b = rep["blocking"][0]
    assert b["blocking"] == "Future.result"
    assert b["held"] == ["serving.registry"]
    assert "offender" in b["stack"]
    assert "offender" in b["held_stacks"]["serving.registry"]
    with pytest.raises(locksmith.LockOrderViolation):
        locksmith.assert_clean()


def test_condition_wait_releases_its_own_lock(armed):
    cond = locksmith.condition("serving.continuous")
    other = locksmith.lock("other")

    def clean_waiter():
        with cond:
            cond.wait(timeout=0.02)

    def bad_waiter():
        with other:
            with cond:
                cond.wait(timeout=0.02)

    _run(clean_waiter)
    assert locksmith.report()["blocking"] == []
    _run(bad_waiter)
    rep = locksmith.report()
    assert len(rep["blocking"]) == 1
    assert rep["blocking"][0]["held"] == ["other"]


def test_rlock_reentry_and_consistent_order_clean(armed):
    R = locksmith.rlock("serving.registry")
    L = locksmith.lock("serving.engine.load")

    def worker():
        with R:
            with R:
                with L:
                    pass

    for _ in range(2):
        _run(worker)
    rep = locksmith.report()
    assert rep["cycles"] == [] and rep["blocking"] == []
    assert rep["edges"] == {"serving.registry -> serving.engine.load": 2}
    assert locksmith.assert_clean()["enabled"]
    # the port's report counts the tracked locks and acquisitions too
    assert rep["locks"]["serving.registry"] == 1
    assert rep["locks"]["serving.engine.load"] == 1
    assert rep["acquisitions"]["serving.registry"] == 4
    assert rep["acquisitions"]["serving.engine.load"] == 2


def _reacquire(ls, **kw):
    """A plain lock of sanitizer ``ls`` taken, then taken again by its
    holder with ``acquire(**kw)``; the report and that acquire's
    result."""
    L = ls.lock("oops")
    state = {}

    def offender():
        L.acquire()
        try:
            state["ok"] = L.acquire(**kw)
        finally:
            if state.get("ok"):
                L.release()
            L.release()

    _run(offender)
    return ls.report(), state["ok"]


def test_plain_lock_reacquire_is_self_deadlock(armed):
    # a blocking re-acquire without a timeout would hang: the timed one
    # blocks all the same, and then gives up
    rep, ok = _reacquire(locksmith, timeout=0.05)
    assert not ok
    assert len(rep["cycles"]) == 1
    assert rep["cycles"][0]["cycle"] == ["oops", "oops"]


def test_plain_lock_try_reacquire_is_not_a_cycle():
    """A try-acquire of a plain lock by its holder returns False at
    once and hangs nothing: the port's sanitizer records no cycle for
    it.  The JAX package's records a one-lock cycle there (its test
    takes the try-acquire as the stand-in for a blocking one); both
    record the blocking re-acquire."""
    for ls, cycles in ((locksmith, 0), (jax_locksmith, 1)):
        for kw, want in (({"blocking": False}, cycles),
                         ({"timeout": 0.05}, 1)):
            ls.reset()
            ls.arm()
            try:
                rep, ok = _reacquire(ls, **kw)
            finally:
                ls.disarm()
                ls.reset()
            assert not ok
            assert len(rep["cycles"]) == want, (ls.__name__, kw)


def test_disabled_is_one_predicate(monkeypatch):
    """Off, the factories never build a tracked wrapper (booby-trapped
    classes), and the serving objects come up on plain locks."""
    assert not locksmith.enabled()

    def boom(*a, **k):
        raise AssertionError("tracked wrapper built while disabled")

    monkeypatch.setattr(locksmith, "_TrackedLock", boom)
    monkeypatch.setattr(locksmith, "_TrackedCondition", boom)
    lk = locksmith.lock("x")
    assert isinstance(lk, type(threading.Lock()))
    assert isinstance(locksmith.rlock("x"), type(threading.RLock()))
    assert isinstance(locksmith.condition("x"), threading.Condition)
    from znicz_tpu_torch.serving.breaker import CircuitBreaker
    from znicz_tpu_torch.serving.continuous import ContinuousBatcher
    b = CircuitBreaker("bucket.1")
    assert b.allow() is False
    cb = ContinuousBatcher(lambda x: x)
    assert cb.queued_rows == 0


def test_arm_wraps_module_locks_in_place():
    """Module locks are made at import, before any arm: arm() wraps
    them around the existing lock and disarm() puts them back."""
    from znicz_tpu_torch.core import telemetry
    orig = telemetry._lock
    assert not isinstance(orig, locksmith._TrackedLock)
    locksmith.arm()
    try:
        assert isinstance(telemetry._lock, locksmith._TrackedLock)
        assert telemetry._lock._inner is orig
        assert telemetry._lock.role == "telemetry.registry"
        with telemetry._lock:
            pass
    finally:
        locksmith.disarm()
        locksmith.reset()
    assert telemetry._lock is orig


def test_wrapper_api_parity(armed):
    L = locksmith.lock("parity.lock")
    assert L.locked() is False
    with L:
        assert L.locked() is True
    R = locksmith.rlock("parity.rlock")
    C = locksmith.condition("parity.cond")
    for wrapper, plain in ((R, threading.RLock()),
                           (C, threading.Condition())):
        assert hasattr(wrapper, "locked") == hasattr(plain, "locked")


def test_disarm_restores_future_result():
    orig = concurrent.futures.Future.result
    locksmith.arm()
    try:
        assert concurrent.futures.Future.result is not orig
    finally:
        locksmith.disarm()
        locksmith.reset()
    assert concurrent.futures.Future.result is orig
    assert not locksmith.enabled()


def _ladder_source(buckets):
    return ({"format": 1,
             "layers": [{"type": "dropout", "name": "d0", "arrays": {}}],
             "input_sample_shape": [5],
             "serving": {"buckets": list(buckets),
                         "max_batch": max(buckets),
                         "sample_shape": [5]}}, {})


def test_engine_ladder_adoption_waits_for_load_lock():
    """The manifest ladder and the limits are adopted inside the load
    lock with the generation swap: a load cannot interleave
    half-adopted limits."""
    from znicz_tpu_torch.serving.engine import InferenceEngine
    engine = InferenceEngine(_ladder_source((1, 2)), warmup=False,
                             device="cpu")
    assert engine.buckets == (1, 2)
    engine._load_lock.acquire()
    done = threading.Event()

    def reload():
        engine.load(_ladder_source((1, 2, 4)))
        done.set()

    t = threading.Thread(target=reload, name="znicz:test-reload")
    t.start()
    try:
        assert not done.wait(0.2)
        assert engine.buckets == (1, 2)
        assert engine.max_batch == 2
    finally:
        engine._load_lock.release()
    t.join(timeout=5)
    assert done.is_set()
    assert engine.buckets == (1, 2, 4)
    assert engine.max_batch == 4


def test_armed_batcher_traffic_is_clean():
    from znicz_tpu_torch.serving.continuous import ContinuousBatcher
    with armed_clean():
        cb = ContinuousBatcher(
            lambda x, request_ids=None: numpy.asarray(x) * 2.0,
            max_inflight=2).start()
        assert isinstance(cb._cond, locksmith._TrackedCondition)
        futs = [cb.submit(numpy.ones((1, 3), numpy.float32))
                for _ in range(16)]
        for f in futs:
            numpy.testing.assert_array_equal(
                f.result(timeout=5),
                numpy.full((1, 3), 2.0, numpy.float32))
        cb.stop(flush=True)


# ---------------------------------------------------------------------------
# Both sanitizers on the same scenarios
# ---------------------------------------------------------------------------

def _scenarios(ls):
    """ABBA across two threads, a Future.result under a lock and a
    Condition.wait under another lock, through sanitizer ``ls``; its
    report."""
    ls.reset()
    ls.arm()
    try:
        a, b = ls.lock("serving.registry"), ls.lock("serving.engine.load")
        cond = ls.condition("serving.batcher")
        fut = concurrent.futures.Future()
        fut.set_result(1)

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    fut.result()

        def waits():
            with a:
                with cond:
                    cond.wait(timeout=0.01)

        for fn in (ab, ba, waits):
            _run(fn)
        return ls.report()
    finally:
        ls.disarm()
        ls.reset()


def test_both_sanitizers_find_the_same_violations():
    got, want = _scenarios(locksmith), _scenarios(jax_locksmith)
    assert sorted(got["edges"].items()) == sorted(want["edges"].items())

    def kinds(rep):
        return (sorted((c["kind"], tuple(c["edge"]),
                        tuple(sorted(c["cycle"]))) for c in rep["cycles"]),
                sorted((b["kind"], b["blocking"], tuple(b["held"]))
                       for b in rep["blocking"]))
    assert kinds(got) == kinds(want)
    assert len(got["cycles"]) == 1 and len(got["blocking"]) == 2


# ---------------------------------------------------------------------------
# The role names at their sites, in both trees
# ---------------------------------------------------------------------------

#: the port's own tracked locks: (module, role) where the JAX package
#: has no lock (module locks are also in locksmith._MODULE_LOCKS)
PORT_ONLY_ROLES = {
    ("serving/engine.py", "serving.engine.dispatches"),
    ("serving/engine.py", "serving.engine.warm"),
    ("core/telemetry.py", "telemetry.ring"),
    ("core/profiler.py", "profiler.running"),
    ("ops/cuda_pooling.py", "ops.cuda_pooling.build"),
    ("ops/cuda_pooling_backward.py", "ops.cuda_pooling_backward.build"),
}


def _sites(package):
    """``[(module, target, factory, role)]`` of every
    ``locksmith.lock|rlock|condition("role")`` assignment in
    ``package`` outside ``analysis/``, and the plain ``threading``
    locks by ``(module, target)``."""
    sites, plain = [], set()
    top = os.path.join(REPO, package)
    for dirpath, _, files in os.walk(top):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, top).replace(os.sep, "/")
            if rel.startswith("analysis/"):
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Attribute)
                        and isinstance(node.value.func.value, ast.Name)):
                    continue
                mod, fac = node.value.func.value.id, node.value.func.attr
                target = ast.unparse(node.targets[0])
                if mod == "locksmith":
                    sites.append((rel, target, fac,
                                  node.value.args[0].value))
                elif mod == "threading" and fac in ("Lock", "RLock",
                                                    "Condition"):
                    plain.add((rel, target))
    return sites, plain


def test_every_jax_lock_site_has_its_port_counterpart_role():
    jax_sites, jax_plain = _sites("znicz_tpu")
    port_sites, port_plain = _sites("znicz_tpu_torch")
    jax_roles = {(m, f, r) for m, _, f, r in jax_sites}
    port_roles = {(m, f, r) for m, _, f, r in port_sites}
    assert len(jax_sites) == 27
    assert jax_roles <= port_roles, sorted(jax_roles - port_roles)
    # same attribute too, but for the engine's breakers lock, which the
    # port names _lock (it also guards the dispatch counts)
    renamed = {("serving/engine.py", "self._breaker_lock"):
               "self._lock"}
    port_targets = {(m, t, r) for m, t, _, r in port_sites}
    for m, t, _, r in jax_sites:
        assert (m, renamed.get((m, t), t), r) in port_targets, (m, t, r)
    extra = {(m, r) for m, _, r in port_roles - jax_roles}
    assert extra == PORT_ONLY_ROLES
    # no site JAX tracks stays a plain threading lock in the port, and
    # the port's plain locks are the ones JAX leaves plain
    tracked = {(m, renamed.get((m, t), t)) for m, t, _, _ in jax_sites}
    assert not tracked & port_plain
    assert port_plain == jax_plain | {("serving/server.py",
                                       "self._active_cv")}


def test_module_locks_name_the_ports_modules_and_force_no_import():
    """Every _MODULE_LOCKS entry names a lock the port makes at import,
    through the factory, with that role in that module; none is of the
    JAX package; an unimported module is skipped, not imported."""
    import sys
    port_sites, _ = _sites("znicz_tpu_torch")
    roles = {(m, r) for m, _, _, r in port_sites}
    for modname, attr, role in locksmith._MODULE_LOCKS:
        assert modname.startswith("znicz_tpu_torch.")
        importlib.import_module(modname)
        rel = modname[len("znicz_tpu_torch."):].replace(".", "/") + ".py"
        assert (rel, role) in roles, (modname, attr, role)
        obj, name = locksmith._owner(modname, attr)
        assert type(getattr(obj, name)) is type(threading.Lock())
    saved = sys.modules.pop("znicz_tpu_torch.ops.cuda_pooling")
    try:
        locksmith.arm()
        locksmith.disarm()
        assert "znicz_tpu_torch.ops.cuda_pooling" not in sys.modules
    finally:
        sys.modules["znicz_tpu_torch.ops.cuda_pooling"] = saved
        locksmith.reset()


@pytest.mark.parametrize("modname,attr,role", [
    ("znicz_tpu_torch.serving.engine", "_warm_lock",
     "serving.engine.warm"),
    ("znicz_tpu_torch.serving.engine", "_DISPATCHES_LOCK",
     "serving.engine.dispatches"),
    ("znicz_tpu_torch.ops.cuda_pooling", "_lock", "ops.cuda_pooling.build"),
    ("znicz_tpu_torch.ops.cuda_pooling_backward", "_lock",
     "ops.cuda_pooling_backward.build"),
    ("znicz_tpu_torch.core.profiler", "_running_lock", "profiler.running"),
    ("znicz_tpu_torch.core.telemetry", "_journal._lock", "telemetry.ring"),
    ("znicz_tpu_torch.core.telemetry", "_trace._lock", "telemetry.ring"),
])
def test_port_only_module_locks_are_tracked_when_armed(modname, attr,
                                                       role):
    mod = importlib.import_module(modname)

    def get():
        obj = mod
        for part in attr.split("."):
            obj = getattr(obj, part)
        return obj

    orig = get()
    locksmith.arm()
    try:
        assert isinstance(get(), locksmith._TrackedLock)
        assert get().role == role and get()._inner is orig
    finally:
        locksmith.disarm()
        locksmith.reset()
    assert get() is orig


# ---------------------------------------------------------------------------
# The port's places to watch
# ---------------------------------------------------------------------------

def test_warm_thread_wait_under_a_tracked_lock_is_recorded(armed):
    """``on_warm_thread`` waits in ``future.result()``: reached under a
    tracked lock, that is a blocking-under-lock violation."""
    from znicz_tpu_torch.serving.engine import on_warm_thread
    held = locksmith.lock("serving.registry")

    def offender():
        with held:
            assert on_warm_thread(lambda: 7) == 7

    _run(offender)
    rep = locksmith.report()
    assert [(b["blocking"], b["held"]) for b in rep["blocking"]] == [
        ("Future.result", ["serving.registry"])]
    assert "serving.engine.warm" in rep["locks"]


def _narrow_package(seed):
    from test_torch_engine import NARROW
    from znicz_tpu_torch.samples import alexnet
    return alexnet.init_package(seed, size=35, layers=NARROW)


def test_registry_reload_restore_and_budget_run_clean():
    """A registry whose budget holds one model: adds evict outside the
    registry lock, a reload warms on the warm-up thread, a request to
    the evicted model restores it (warm-up again), a bad reload rolls
    back and opens its bucket's breaker — all without a violation."""
    from znicz_tpu_torch.serving.registry import ModelRegistry
    first, second = _narrow_package(7), _narrow_package(8)
    bad = ({"format": 1, "input_sample_shape": [35, 35, 3],
            "layers": [{"type": "softmax", "name": "fc",
                        "arrays": {"weights": "w.npy"}}]},
           {"w.npy": numpy.ones((10, 7), numpy.float32)})
    x = numpy.random.RandomState(0).uniform(
        -1, 1, (3, 35, 35, 3)).astype(numpy.float32)
    size = sum(v.nbytes for v in first[1].values())
    saved = root.common.serving.get("breaker_threshold", 5)
    root.common.serving.breaker_threshold = 1
    try:
        with armed_clean() as ls:
            reg = ModelRegistry(memory_budget_bytes=int(1.5 * size),
                                max_batch=4, device="cpu")
            reg.add("a", first)
            reg.add("b", second)
            assert not reg.peek("a").resident
            reg.reload("b", first)
            y = reg.engine("a").predict(x)
            assert reg.peek("a").resident and not reg.peek("b").resident
            with pytest.raises(RuntimeError):
                reg.reload("a", bad)
            assert reg.peek("a")._breakers[1].state == "open"
            numpy.testing.assert_array_equal(reg.peek("a").predict(x), y)
            rep = ls.report()
            assert rep["locks"]["serving.registry"] == 1
            assert rep["locks"]["serving.engine.load"] == 2
            assert rep["acquisitions"]["serving.engine.load"] >= 6
    finally:
        root.common.serving.breaker_threshold = saved


def test_nested_profiler_capture_is_refused_clean_when_armed(tmp_path):
    """A capture nested on its own thread is refused by a try-acquire
    of the capture lock the thread holds: no hang, and no cycle."""
    from znicz_tpu_torch.core import profiler
    with armed_clean():
        with profiler.traced(str(tmp_path / "a"), cuda=False):
            with pytest.raises(RuntimeError, match="already running"):
                with profiler.traced(str(tmp_path / "b"), cuda=False):
                    pass
        with profiler.traced(str(tmp_path / "c"), cuda=False):
            pass


def test_release_deploy_and_promote_run_clean(monkeypatch):
    """The release plane's deploy and promote reload the registry (each
    a warm-up on the warm-up thread) outside the controller's lock."""
    from znicz_tpu_torch.serving import release
    from znicz_tpu_torch.serving.registry import ModelRegistry
    from znicz_tpu_torch.serving.slo import SloTracker
    monkeypatch.setattr(root.common.serving, "slo_enabled", True)
    with armed_clean() as ls:
        reg = ModelRegistry(max_batch=4, device="cpu")
        reg.add("m", _narrow_package(7))
        ctl = release.ReleaseController(
            release.LocalTarget(reg, SloTracker()))
        ctl.start_release("m", _narrow_package(8))
        ctl._promote(ctl._active["m"], {})
        assert ctl.status("m")["state"] == release.PROMOTED
        assert reg.names() == ["m"] and reg.peek("m").version == 2
        rep = ls.report()
        assert rep["locks"]["serving.release"] == 1
        assert rep["acquisitions"]["serving.engine.load"] >= 3
