"""Progressive delivery — shadow, canary, then promote or roll back,
judged live.

Counterpart of ``znicz_tpu/serving/release.py`` (``generation_of``
:108, ``split_point`` :129, ``LocalTarget`` :155, ``Release`` :205,
``ReleaseController`` :290).  A release pushes a new generation of a
served model without a blind ``/reload``:

* **Shadow.**  The candidate deploys under ``<model>.gen<N>`` (N the
  live version plus one), and a sampled share of the model's live
  traffic is mirrored to it after the live reply was written, through a
  bounded queue that drops (counted) rather than blocks.  A worker
  thread compares each candidate reply with the live one under
  :data:`~znicz_tpu_torch.serving.accuracy.TOLERANCES` (an f32
  candidate is held to bit identity) and journals a mismatch
  (``release.shadow_mismatch``) with its rid.  A mirrored request
  carries the bucket its live batch ran at, and the candidate is asked
  for that bucket: a product's rounding follows the bucket, so a live
  reply coalesced into a larger batch is compared with a candidate
  reply of the same padding.
* **Canary.**  Live traffic splits by ``crc32(rid) % 10000`` against the
  step's percentage (sticky per rid: a retry lands on the same
  generation), the routed name rewritten to the candidate, whose SLO
  key and ``gen_<N>`` reply header then account for it.  A step
  advances after the green window (both burn windows green, at least
  ``min_requests`` candidate requests at the step) and the last one
  promotes (``/reload`` of the live name); a burn breach or a shadow
  mismatch breach rolls back, journaling ``release.rollback`` with the
  signals and an exemplar rid.
* **The guard.**  While a release is active, ``/reload`` and the
  ``/models/<name>`` mutations of the model or its candidate raise
  :class:`ReleaseConflictError` (a 409): promote and rollback are the
  controller's.  A candidate that dies in shadow fails the release
  (``failed``); one that goes during canary leaves the routing to fall
  back to the live generation.

Knobs: ``root.common.serving.release.*``, read live, and a release's
``policy`` dict wins over them.  Telemetry: the ``release.state`` and
``release.canary_pct`` gauges and the ``release.shadow_compares`` /
``shadow_mismatches`` / ``shadow_dropped`` counters, labelled by model
and generation.  The clock is injectable and :meth:`ReleaseController.
tick` is public, so tests drive the state machine without sleeping.
The controller's lock is a ``locksmith`` lock, as in JAX; the queue's
condition and the lifecycle lock stay plain, as JAX leaves them.
"""

import collections
import re
import threading
import time
import zlib

import numpy

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.serving import slo
from znicz_tpu_torch.serving.accuracy import TOLERANCES, _delta_stats

_rel = root.common.serving.release

telemetry.register_help(
    "release", "progressive delivery (serving/release.py): shadow "
               "compare/mismatch counters and canary state per "
               "model generation")

#: release states
SHADOW, CANARY = "shadow", "canary"
PROMOTED, ROLLED_BACK = "promoted", "rolled_back"
FAILED, ABORTED = "failed", "aborted"
#: the states a release ends in
TERMINAL = frozenset((PROMOTED, ROLLED_BACK, FAILED, ABORTED))

#: the ``release.state`` gauge's codes (the journal carries the names)
_STATE_CODE = {SHADOW: 1, CANARY: 2, PROMOTED: 3,
               ABORTED: 0, ROLLED_BACK: -1, FAILED: -2}

#: a candidate's name: ``<model>.gen<N>``
_GEN_RE = re.compile(r"\.gen(\d+)$")

#: an f32 candidate answers bit for bit what the live f32 one does
_BIT_IDENTITY = {"max_delta": 0.0, "flip_rate": 0.0}

#: mirrored pairs the shadow queue holds before it drops
SHADOW_QUEUE = 128


class ReleaseConflictError(RuntimeError):
    """A mutation raced an active release (HTTP 409)."""


def generation_of(name):
    """The generation a candidate name encodes (``wine.gen7`` -> 7), or
    None for a live model's name."""
    m = _GEN_RE.search(name or "")
    return int(m.group(1)) if m else None


def generation_label(name, version):
    """The ``X-Serving-Generation`` label of a reply served by ``name``
    at engine ``version``: a candidate's encoded generation, else the
    live version."""
    gen = generation_of(name)
    return "gen_%d" % (gen if gen is not None else int(version or 0))


def candidate_name(model, live_version):
    """The registry name a candidate deploys under."""
    return "%s.gen%d" % (model, int(live_version) + 1)


def split_point(rid):
    """The rid's [0, 100) canary coordinate, the same at every call."""
    return (zlib.crc32(rid.encode("utf-8", "replace")) % 10000) / 100.0


def _shadow_sampled(rid, pct):
    """Shadow sampling hashes the rid with a salt, so the mirrored share
    is independent of the canary split."""
    if pct >= 100.0:
        return True
    point = (zlib.crc32(b"shadow/" + rid.encode("utf-8", "replace"))
             % 10000) / 100.0
    return point < pct


def _tolerance(dtype):
    """The shadow compare's pin: the accuracy tolerance of a
    low-precision candidate, bit identity for f32."""
    tol = TOLERANCES.get(str(dtype or "f32").replace("-", "_"))
    if tol is None:
        return dict(_BIT_IDENTITY)
    return {"max_delta": float(tol["max_delta"]),
            "flip_rate": float(tol["flip_rate"])}


class LocalTarget(object):
    """The deployment surface of one registry server: the candidate is a
    registry model, shadow predicts run its engine in this process, the
    SLO reads come from the server's tracker."""

    def __init__(self, registry, slo_tracker):
        self.registry = registry
        self.slo = slo_tracker

    def resolve_default(self):
        return self.registry.default

    def live_version(self, model):
        return self.registry.peek(model).version

    def serve_dtype(self, name):
        return self.registry.peek(name).serve_dtype

    def deploy(self, name, source):
        self.registry.add(name, source)

    def undeploy(self, name):
        try:
            self.registry.remove(name)
        except KeyError:
            pass  # already gone

    def promote(self, model, source):
        self.registry.reload(model, source)

    def alive(self, name):
        try:
            return self.registry.peek(name).ready
        except KeyError:
            return False

    def shadow_predict(self, name, payload, bucket=None):
        pinned = {"bucket": bucket} if bucket else {}
        return self.registry.engine(name).predict(payload, **pinned)

    @staticmethod
    def decode_reply(reply):
        return reply  # the live array, as served

    def slo_models(self):
        return self.slo.status().get("models") or {}

    def set_guard(self, fn):
        self.registry.set_reload_guard(fn)


class Release(object):
    """One release in flight: the record the controller judges at every
    tick, changed under the controller's lock."""

    def __init__(self, model, source, cand_name, policy, dtype, now):
        self.model = model
        self.source = source
        self.cand_name = cand_name
        self.generation = generation_of(cand_name)
        self.policy = dict(policy or {})
        self.dtype = dtype
        self.tolerance = _tolerance(dtype)
        self.state = SHADOW
        self.started = now
        self.updated = now
        self.step_idx = -1          # -1: still in shadow
        self.step_base_total = 0
        self.green_since = None
        self.shadow_compares = 0
        self.shadow_mismatches = 0
        self.shadow_errors = 0
        self.shadow_dropped = 0
        self.mismatch_buckets = {}
        self.last_mismatch_rid = None
        self.last_signals = {}
        self.reason = None
        self.history = []

    def knob(self, key, default):
        """The release's policy, else the live config."""
        if key in self.policy:
            return self.policy[key]
        return _rel.get(key, default)

    @property
    def steps(self):
        return [float(s) for s in
                self.knob("canary_steps", [5.0, 25.0, 50.0])]

    @property
    def canary_pct(self):
        if self.state != CANARY or self.step_idx < 0:
            return 0.0
        steps = self.steps
        return steps[min(self.step_idx, len(steps) - 1)] \
            if steps else 100.0

    @property
    def held(self):
        """``policy: {"hold": true}`` freezes advancement and promotion;
        every red judgment stays armed."""
        return bool(self.knob("hold", False))

    def note(self, event, **attrs):
        self.history.append(dict({"event": event}, **attrs))

    def status(self):
        return {
            "model": self.model,
            "candidate": self.cand_name,
            "generation": self.generation,
            "source": str(self.source),
            "state": self.state,
            "reason": self.reason,
            "canary_pct": self.canary_pct,
            "step": self.step_idx,
            "steps": self.steps,
            "held": self.held,
            "shadow": {
                "compares": self.shadow_compares,
                "mismatches": self.shadow_mismatches,
                "errors": self.shadow_errors,
                "dropped": self.shadow_dropped,
                "mismatch_buckets": dict(self.mismatch_buckets),
                "exemplar_rid": self.last_mismatch_rid,
                "dtype": self.dtype,
                "tolerance": self.tolerance,
            },
            "signals": self.last_signals,
            "history": list(self.history),
        }


class ReleaseController(Logger):
    """At most one active release a model, judged by the SLO plane (see
    the module's docstring).  ``target`` is the deployment surface
    (:class:`LocalTarget`, or the fleet router's); ``clock`` is
    injectable.  :meth:`tick` is one judging pass; :meth:`start` arms a
    thread that ticks every ``tick_interval_s`` and the shadow
    worker."""

    def __init__(self, target, clock=time.monotonic):
        super(ReleaseController, self).__init__(
            logger_name="ReleaseController")
        self._target = target
        self._clock = clock
        self._lock = locksmith.lock("serving.release")
        self._active = {}           # model -> Release
        self._done = {}             # model -> its last ended Release
        self._starting = 0          # start_release calls deploying
        self._last_end = None       # the clock when a release last ended
        self._queue = collections.deque()
        self._comparing = 0         # popped pairs not yet judged
        self._queue_cond = threading.Condition()
        self._bypass = threading.local()
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._tick_thread = None
        self._shadow_thread = None
        target.set_guard(self._guard)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Arm the tick loop and the shadow worker (idempotent: every
        ``POST /release`` calls it)."""
        with self._lifecycle:
            if self._tick_thread is not None:
                return self
            self._stop.clear()
            self._tick_thread = threading.Thread(
                target=self._tick_loop, name="znicz:release-tick",
                daemon=True)
            self._shadow_thread = threading.Thread(
                target=self._shadow_loop, name="znicz:release-shadow",
                daemon=True)
            self._tick_thread.start()
            self._shadow_thread.start()
        return self

    def stop(self):
        with self._lifecycle:
            self._stop.set()
            with self._queue_cond:
                self._queue_cond.notify_all()
            for t in (self._tick_thread, self._shadow_thread):
                if t is not None:
                    t.join(timeout=10)
            self._tick_thread = self._shadow_thread = None

    def _tick_loop(self):
        while not self._stop.wait(
                float(_rel.get("tick_interval_s", 0.25))):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - keep judging
                self.warning("release tick failed: %r", e)

    # -- the mutation guard --------------------------------------------------
    def _guard(self, name, action):
        """Vetoes a reload, add or remove of a released model or its
        candidate by anyone but the controller; ``name=None`` (the
        default model) is vetoed by any active release."""
        if getattr(self._bypass, "on", False):
            return
        with self._lock:
            if not self._active:
                return
            if name is None:
                rel = next(iter(self._active.values()))
            else:
                rel = self._active.get(name)
                if rel is None:
                    for r in self._active.values():
                        if r.cand_name == name:
                            rel = r
                            break
            if rel is None:
                return
        raise ReleaseConflictError(
            "cannot %s model %r: release of %r to %s is active "
            "(state %s) — abort it first (DELETE /release/%s)"
            % (action, name, rel.model, rel.cand_name, rel.state,
               rel.model))

    class _Bypass(object):
        def __init__(self, local):
            self._local = local

        def __enter__(self):
            self._local.on = True

        def __exit__(self, *exc):
            self._local.on = False

    def _as_controller(self):
        """The controller's own mutations pass the guard."""
        return self._Bypass(self._bypass)

    # -- the operator surface ------------------------------------------------
    def start_release(self, model, source, policy=None):
        """Deploy ``source`` as ``model``'s candidate and enter shadow.
        Raises :class:`ReleaseConflictError` when the model has an active
        release, ``ValueError`` when the SLO plane (the judge) is off,
        ``KeyError`` for an unknown model."""
        if not slo.enabled():
            raise ValueError(
                "a release is judged by the SLO plane — enable "
                "root.common.serving.slo_enabled first")
        with self._lock:
            if model in self._active:
                raise ReleaseConflictError(
                    "a release of %r is already active (candidate "
                    "%s, state %s)"
                    % (model, self._active[model].cand_name,
                       self._active[model].state))
            self._starting += 1
        try:
            live_version = self._target.live_version(model)  # may raise
            cand = candidate_name(model, live_version)
            with self._as_controller():
                self._target.deploy(cand, source)
            try:
                dtype = self._target.serve_dtype(cand)
            except Exception:  # noqa: BLE001 - a label only
                dtype = None
            now = float(self._clock())
            rel = Release(model, source, cand, policy, dtype, now)
            rel.note("start", state=SHADOW)
            with self._lock:
                self._active[model] = rel
        finally:
            with self._lock:
                self._starting -= 1
        telemetry.record_event(
            "release.start", model=model, candidate=cand,
            generation=rel.generation, source=str(source),
            dtype=dtype, steps=rel.steps)
        self._note_state(rel)
        self.info("release of %r started: candidate %s (dtype %s) "
                  "shadowing", model, cand, dtype)
        return rel.status()

    def abort(self, model):
        """``DELETE /release/<model>``: undeploy the candidate; the live
        generation is not touched."""
        with self._lock:
            rel = self._active.get(model)
        if rel is None:
            raise KeyError("no active release for model %r" % model)
        self._finish(rel, ABORTED, "operator abort")
        return rel.status()

    def status(self, model=None):
        """``GET /release[/<model>]``: the active releases and each
        model's last ended one."""
        with self._lock:
            active = {m: r.status() for m, r in self._active.items()}
            done = {m: r.status() for m, r in self._done.items()}
        if model is not None:
            rel = active.get(model) or done.get(model)
            if rel is None:
                raise KeyError("no release record for model %r" % model)
            return rel
        return {"active": active, "recent": done}

    def active(self):
        with self._lock:
            return bool(self._active)

    def busy(self, within_s=0.0):
        """True while a release deploys or is active, or ended less
        than ``within_s`` ago (the fleet's autoscaler holds a scale-down
        then)."""
        with self._lock:
            if self._active or self._starting:
                return True
            last = self._last_end
        return last is not None and \
            float(self._clock()) - last < float(within_s)

    def candidates(self):
        """``{candidate name: source}`` of the active releases (a fleet
        replica that enters rotation mid-release deploys them)."""
        with self._lock:
            return {r.cand_name: r.source for r in self._active.values()}

    # -- the data-plane hooks ------------------------------------------------
    def route(self, model, rid):
        """The canary split: the candidate to serve this request from,
        or None for the live generation (one dict check when no release
        is active)."""
        if not self._active:
            return None
        with self._lock:
            rel = self._resolve(model)
            if rel is None or rel.state != CANARY:
                return None
            pct = rel.canary_pct
        if pct <= 0.0:
            return None
        return rel.cand_name if split_point(rid) < pct else None

    def _shadowing(self, model, rid):
        """The release of ``model`` that shadows ``rid``: in SHADOW,
        ``rid`` in its sample; else None."""
        if not self._active:
            return None
        with self._lock:
            rel = self._resolve(model)
            if rel is None or rel.state != SHADOW:
                return None
            pct = float(rel.knob("shadow_sample_pct", 100.0))
        return rel if _shadow_sampled(rid, pct) else None

    def wants_mirror(self, model, rid):
        """Whether :meth:`mirror` would take this request: callers copy
        the pair only then (a canary step or an unsampled rid costs no
        copy of the request)."""
        return self._shadowing(model, rid) is not None

    def mirror(self, model, rid, payload, reply, bucket=None):
        """The shadow mirror: queue one live (request, reply) pair, and
        the bucket the live batch ran at, for the worker's compare.
        Never blocks: a full queue drops (counted)."""
        rel = self._shadowing(model, rid)
        if rel is None:
            return False
        with self._queue_cond:
            if len(self._queue) >= SHADOW_QUEUE:
                with self._lock:
                    rel.shadow_dropped += 1
                if telemetry.enabled():
                    telemetry.counter(telemetry.labeled(
                        "release.shadow_dropped", model=rel.model,
                        gen=str(rel.generation))).inc()
                return False
            self._queue.append((rel, rid, payload, reply, bucket))
            self._queue_cond.notify()
        return True

    def _resolve(self, model):
        """The active release of a routed name (None: the target's
        default model).  The caller holds the lock."""
        if model is None:
            model = self._target.resolve_default()
        return self._active.get(model)

    # -- the shadow worker ---------------------------------------------------
    def _shadow_loop(self):
        while True:
            with self._queue_cond:
                while not self._queue and not self._stop.is_set():
                    self._queue_cond.wait(0.5)
                if self._stop.is_set() and not self._queue:
                    return
                item = self._queue.popleft()
                self._comparing += 1
            try:
                self._compare(*item)
            except Exception as e:  # noqa: BLE001 - judged, not fatal
                with self._lock:
                    item[0].shadow_errors += 1
                self.warning("shadow compare %s failed: %r", item[1], e)
            finally:
                with self._queue_cond:
                    self._comparing -= 1
                    self._queue_cond.notify_all()

    def drain_shadow(self, timeout_s=5.0):
        """Block until every mirrored pair is judged: the queue empty
        and no compare running (JAX's returns once the queue is empty,
        when the last compare may still run).  False when ``timeout_s``
        passed first."""
        deadline = time.monotonic() + float(timeout_s)
        with self._queue_cond:
            while self._queue or self._comparing:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._queue_cond.wait(left)
        return True

    def _compare(self, rel, rid, payload, reply, bucket=None):
        if rel.state != SHADOW:
            return
        try:
            y_live = numpy.asarray(self._target.decode_reply(reply))
            y_cand = numpy.asarray(self._target.shadow_predict(
                rel.cand_name, payload, bucket=bucket))
        except Exception as e:  # noqa: BLE001 - the candidate's fault
            with self._lock:
                rel.shadow_errors += 1
            self.warning("candidate %s shadow predict %s failed: %r",
                         rel.cand_name, rid, e)
            return
        stats = _delta_stats(y_live, y_cand)
        tol = rel.tolerance
        mismatch = stats["max_delta"] > tol["max_delta"] or \
            (stats["flip_rate"] or 0.0) > tol["flip_rate"]
        rows = str(int(getattr(y_live, "shape", (0,))[0] or 0))
        with self._lock:
            rel.shadow_compares += 1
            if mismatch:
                rel.shadow_mismatches += 1
                rel.mismatch_buckets[rows] = \
                    rel.mismatch_buckets.get(rows, 0) + 1
                rel.last_mismatch_rid = rid
        if telemetry.enabled():
            gen = str(rel.generation)
            telemetry.counter(telemetry.labeled(
                "release.shadow_compares", model=rel.model,
                gen=gen)).inc()
            if mismatch:
                telemetry.counter(telemetry.labeled(
                    "release.shadow_mismatches", model=rel.model,
                    gen=gen)).inc()
        if mismatch:
            telemetry.record_event(
                "release.shadow_mismatch", model=rel.model,
                candidate=rel.cand_name, exemplar_rid=rid,
                bucket=rows,
                max_delta=round(stats["max_delta"], 6),
                flip_rate=stats["flip_rate"],
                tolerance=tol)

    # -- the judge -----------------------------------------------------------
    def tick(self):
        """One judging pass over every active release: advance on a
        green window held, roll back on red."""
        with self._lock:
            rels = list(self._active.values())
        for rel in rels:
            try:
                self._evaluate(rel)
            except Exception as e:  # noqa: BLE001 - judge next tick
                self.warning("evaluating release of %r failed: %r",
                             rel.model, e)

    def _evaluate(self, rel):
        now = float(self._clock())
        if rel.state == SHADOW:
            self._evaluate_shadow(rel, now)
        elif rel.state == CANARY:
            self._evaluate_canary(rel, now)

    def _evaluate_shadow(self, rel, now):
        mismatch_max = int(rel.knob("shadow_mismatch_max", 0))
        error_max = int(rel.knob("shadow_error_max", 3))
        if not self._target.alive(rel.cand_name):
            # only mirrored traffic reached it: nothing to roll back
            self._finish(rel, FAILED, "candidate died during shadow")
            return
        with self._lock:
            compares = rel.shadow_compares
            mismatches = rel.shadow_mismatches
            errors = rel.shadow_errors
            exemplar = rel.last_mismatch_rid
        if errors > error_max:
            self._finish(rel, FAILED,
                         "candidate errored %d times in shadow "
                         "(max %d)" % (errors, error_max))
            return
        if mismatches > mismatch_max:
            self._finish(
                rel, ROLLED_BACK,
                "shadow mismatch breach: %d mismatches (max %d)"
                % (mismatches, mismatch_max),
                signals={"shadow_mismatches": mismatches,
                         "shadow_compares": compares,
                         "exemplar_rid": exemplar})
            return
        green = compares >= int(rel.knob("shadow_min_compares", 8))
        self._advance_on_green(rel, now, green, {
            "shadow_compares": compares,
            "shadow_mismatches": mismatches})

    def _evaluate_canary(self, rel, now):
        block = self._target.slo_models().get(rel.cand_name) or {}
        burn = block.get("burn_rate") or {}
        signals = {
            "canary_pct": rel.canary_pct,
            "burn_fast": burn.get("fast"),
            "burn_slow": burn.get("slow"),
            "total": block.get("total") or 0,
            "good_pct": block.get("good_pct"),
            "exemplar_rid": block.get("exemplar_rid"),
        }
        with self._lock:
            rel.last_signals = signals
            mismatches = rel.shadow_mismatches
        if mismatches > int(rel.knob("shadow_mismatch_max", 0)):
            self._finish(rel, ROLLED_BACK,
                         "shadow mismatch breach during canary",
                         signals=signals)
            return
        if block.get("burning"):
            # the tracker's both-windows verdict, the slo.burn rule
            self._finish(rel, ROLLED_BACK,
                         "SLO burn breach on both windows at "
                         "canary %.4g%%" % rel.canary_pct,
                         signals=signals)
            return
        if not self._target.alive(rel.cand_name):
            # the routing already falls back to the live generation
            self._finish(rel, FAILED, "candidate died during canary",
                         signals=signals)
            return
        step_total = (block.get("total") or 0) - rel.step_base_total
        green = step_total >= int(rel.knob("min_requests", 12))
        self._advance_on_green(rel, now, green, signals)

    def _advance_on_green(self, rel, now, green, signals):
        """``green`` must hold for ``green_window_s`` before the next
        step; red restarts the window."""
        window_s = float(rel.knob("green_window_s", 5.0))
        with self._lock:
            if not green:
                rel.green_since = None
                return
            if rel.green_since is None:
                rel.green_since = now
            if now - rel.green_since < window_s:
                return
            if rel.held:
                return  # pinned; still judged
            rel.green_since = None
            rel.step_idx += 1
            promote = rel.step_idx >= len(rel.steps)
            if not promote:
                rel.state = CANARY
                rel.step_base_total = int(
                    (signals or {}).get("total") or 0)
                rel.updated = now
        if promote:
            self._promote(rel, signals)
            return
        rel.note("advance", step=rel.step_idx,
                 canary_pct=rel.canary_pct)
        telemetry.record_event(
            "release.advance", model=rel.model,
            candidate=rel.cand_name, step=rel.step_idx,
            canary_pct=rel.canary_pct, signals=signals,
            exemplar_rid=rel.last_mismatch_rid)
        self._note_state(rel)
        self.info("release of %r advanced to canary step %d "
                  "(%.4g%% of traffic)", rel.model, rel.step_idx,
                  rel.canary_pct)

    # -- the ends ------------------------------------------------------------
    def _promote(self, rel, signals):
        try:
            with self._as_controller():
                self._target.promote(rel.model, rel.source)
        except Exception as e:  # noqa: BLE001 - report, never crash
            # a failed load rolled the live model back to its generation
            self._finish(rel, ROLLED_BACK,
                         "promote failed (%r); live generation "
                         "untouched" % e, signals=signals)
            return
        self._finish(rel, PROMOTED, "all canary steps green",
                     signals=signals)

    def _finish(self, rel, state, reason, signals=None):
        with self._lock:
            if rel.state in TERMINAL:
                return
            rel.state = state
            rel.reason = reason
            rel.updated = self._last_end = float(self._clock())
            self._active.pop(rel.model, None)
            self._done[rel.model] = rel
        # the candidate leaves in every end state (a promoted live model
        # now serves its parameters)
        with self._as_controller():
            try:
                self._target.undeploy(rel.cand_name)
            except Exception as e:  # noqa: BLE001 - best effort
                self.warning("undeploy of %s failed: %r",
                             rel.cand_name, e)
        event = {PROMOTED: "release.promote",
                 ROLLED_BACK: "release.rollback",
                 FAILED: "release.failed",
                 ABORTED: "release.abort"}[state]
        rel.note(state, reason=reason, signals=signals or {})
        telemetry.record_event(
            event, model=rel.model, candidate=rel.cand_name,
            generation=rel.generation, reason=reason,
            signals=signals or {},
            exemplar_rid=(signals or {}).get("exemplar_rid")
            or rel.last_mismatch_rid)
        self._note_state(rel)
        log = self.info if state == PROMOTED else self.warning
        log("release of %r -> %s: %s", rel.model, state, reason)

    def _note_state(self, rel):
        if not telemetry.enabled():
            return
        gen = str(rel.generation)
        telemetry.gauge(telemetry.labeled(
            "release.state", model=rel.model, gen=gen)).set(
                _STATE_CODE.get(rel.state, 0))
        telemetry.gauge(telemetry.labeled(
            "release.canary_pct", model=rel.model,
            gen=gen)).set(rel.canary_pct)
