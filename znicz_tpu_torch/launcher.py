"""Workflow launcher — the ``run(load, main)`` contract behind the CLI.

Counterpart of ``znicz_tpu/launcher.py`` (``Launcher`` :29 with
``load`` :110, ``_snapshot_incompatible`` and ``_find_resume_state``
:132-280 and ``main`` :282-330, ``snapshot_candidates`` and
``newest_snapshot`` :335-353, ``resolve_workflow_module`` :356,
``run_workflow`` :401, ``run_supervised`` :430-497).  A workflow
module ends with ``run(load, main)``, where

* ``load(factory, **kwargs) -> (workflow, snapshot_loaded)`` builds
  the workflow and, with ``--snapshot``, reads the state to restore;
* ``main(**kwargs)`` chooses cuDNN's deterministic algorithms
  (:func:`znicz_tpu_torch.core.backends.deterministic`), initializes
  the workflow on the launcher's device (the card unless
  ``device="cpu"``), restores the newest resumable snapshot of the
  workflow's snapshotter under ``auto_resume`` (else the ``--snapshot``
  one), sets ``testing`` on every unit that has it, and runs unless
  ``dry_run``, writing a crash report when the run fails with the
  journal on.

:func:`run_supervised` runs a workflow again after a crash, with
``auto_resume``, up to ``max_restarts`` times.  Multi-process runs are
not in this slice of the port (``ROADMAP.md``).
"""

import gc
import importlib
import importlib.util
import os
import sys
import time

import numpy

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.backends import default_device, deterministic
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.memory import Array


class Launcher(Logger):
    """A standalone launcher implementing ``load`` / ``main``."""

    def __init__(self, snapshot=None, device=None, dry_run=False,
                 fused=None, testing=False, auto_resume=False):
        super(Launcher, self).__init__(logger_name="Launcher")
        self.snapshot_path = snapshot
        self.testing = testing
        self.auto_resume = auto_resume
        self.device = device
        self.dry_run = dry_run
        #: fused execution mode handed to StandardWorkflow-based
        #: samples (True or a config dict)
        self.fused = fused
        self.workflow = None
        self._state = None

    def add_unit(self, unit):
        # a workflow built with the launcher as its parent registers here
        self.workflow = unit

    def load(self, factory, **kwargs):
        """Build the workflow.  ``factory`` is a Workflow subclass
        (instantiated with this launcher as parent) or a builder
        returning the workflow.  Returns (workflow, snapshot_loaded)."""
        if self.snapshot_path:
            from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
            self._state = SnapshotterToFile.import_(self.snapshot_path)
            self.info("will restore snapshot %s", self.snapshot_path)
        if self.fused is not None:
            kwargs.setdefault("fused", self.fused)
        if isinstance(factory, type):
            wf = factory(self, **kwargs)
        else:
            wf = factory(**kwargs)
        self.workflow = wf
        return wf, self._state is not None

    def _snapshot_incompatible(self, state, wf):
        """Why the snapshot cannot be applied to ``wf`` (None: it can):
        another workflow class, an exported Array or a mid-epoch
        accumulator (``epoch_acc``) of another shape than the live one,
        fused parameters of another layout, or no trainable weights of
        this workflow's layers at all (another topology under the same
        prefix)."""
        snap_wf = state.get("workflow")
        if snap_wf not in (None, type(wf).__name__):
            return "workflow class %r != %r" % (snap_wf, type(wf).__name__)
        units = {u.name: u for u in wf.units}
        for uname, ustate in state.get("units", {}).items():
            u = units.get(uname)
            if u is None:
                continue
            for attr, value in ustate.items():
                if value is None:
                    continue
                if attr == "epoch_acc":
                    # against the net's zero accumulator on the host: the
                    # live one would drain the device for every candidate
                    net = getattr(u, "net", None)
                    if net is None or not isinstance(value, dict):
                        continue
                    for leaf, zero in net.window_acc_zeros().items():
                        got = value.get(leaf)
                        if got is None or \
                                tuple(numpy.shape(got)) != zero.shape:
                            return "unit %s.epoch_acc[%s] shape %s != %s" % (
                                uname, leaf, None if got is None
                                else tuple(numpy.shape(got)), zero.shape)
                    continue
                cur = getattr(u, attr, None)
                if isinstance(cur, Array) and cur and \
                        tuple(cur.shape) != tuple(numpy.shape(value)):
                    return "unit %s.%s shape %s != %s" % (
                        uname, attr, numpy.shape(value), tuple(cur.shape))
                if attr == "fused_state" and isinstance(value, dict) and \
                        getattr(u, "net", None) is not None:
                    reason = self._fused_params_differ(
                        u.net.params, list(value.get("params", ())))
                    if reason:
                        return reason
        return self._uncovered(state, wf)

    @staticmethod
    def _fused_params_differ(live, snap):
        """Why fused parameters ``snap`` (host arrays, one dict a layer)
        do not fit the live net's (None: they do)."""
        if len(snap) != len(live):
            return "fused layer count %d != %d" % (len(snap), len(live))
        for p_cur, p_new in zip(live, snap):
            if set(p_cur) != set(p_new):
                return ("fused param keys %s != %s"
                        % (sorted(p_new), sorted(p_cur)))
            for k in p_cur:
                if tuple(p_cur[k].shape) != numpy.shape(p_new[k]):
                    return ("fused param shape %s != %s"
                            % (numpy.shape(p_new[k]), tuple(p_cur[k].shape)))
        return None

    @staticmethod
    def _uncovered(state, wf):
        """Why the snapshot covers none of the workflow's trainable state
        (None: it does), directly or through the fused <-> unit-graph
        mapping: a snapshot of another topology under the same prefix
        passes every shape check vacuously."""
        snap_units = state.get("units", {})
        forwards = list(getattr(wf, "forwards", ()))
        trainer = getattr(wf, "fused_trainer", None)
        has_fused_state = any(isinstance(us.get("fused_state"), dict)
                              for us in snap_units.values())
        has_unit_weights = any(us.get("weights") is not None
                               for us in snap_units.values())
        trainable = [f for f in forwards
                     if getattr(f, "weights", None) is not None
                     and f.weights] or ([trainer] if trainer else [])
        if not trainable or has_fused_state:
            return None
        if not has_unit_weights:
            return "snapshot carries no trainable weights"
        from znicz_tpu_torch.units.nn_units import _unit_graph_name
        names = [f.name for f in forwards] if trainer is None else \
            [_unit_graph_name(layer, i)
             for i, layer in enumerate(trainer.layers)]
        if not any(snap_units.get(n, {}).get("weights") is not None
                   for n in names):
            return ("snapshot's unit names cover none of this workflow's "
                    "layers (different topology under the same prefix?)")
        return None

    def _find_resume_state(self, wf):
        """The newest snapshot of the workflow's snapshotter (prefix and
        directory) that reads and fits; unreadable and incompatible
        files are skipped, newest first, each with a ``resume.skipped``
        journal event."""
        from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
        snap = getattr(wf, "snapshotter", None)
        if snap is None:
            self.warning("--auto-resume: workflow has no snapshotter")
            return None
        for path in snapshot_candidates(snap.directory, snap.prefix):
            try:
                state = SnapshotterToFile.import_(path)
            except Exception as e:  # noqa: BLE001 - a corrupt snapshot
                self.warning("auto-resume: skipping unreadable snapshot "
                             "%s (%s)", path, e)
                telemetry.record_event("resume.skipped", path=path,
                                       why="unreadable", error=repr(e))
                continue
            reason = self._snapshot_incompatible(state, wf)
            if reason:
                self.warning("auto-resume: skipping incompatible snapshot "
                             "%s (%s)", path, reason)
                telemetry.record_event("resume.skipped", path=path,
                                       why="incompatible", reason=reason)
                continue
            self.info("auto-resume: restoring %s", path)
            return state
        return None

    def main(self, **kwargs):
        """Initialize (and restore), then run unless ``dry_run``."""
        wf = self.workflow
        if wf is None:
            raise RuntimeError("main() before load()")
        # the card's algorithms are chosen before the first one runs
        deterministic(default_device(self.device))
        wf.initialize(device=self.device, **kwargs)
        if self.auto_resume:
            found = self._find_resume_state(wf)
            if found is not None:
                # the newest resumable state wins over --snapshot, which
                # stays the fallback: a restart that crashed before its
                # first snapshot re-enters the user's warm start
                self._state = found
            elif self._state is not None:
                self.info("auto-resume: no resumable snapshot; falling "
                          "back to the snapshot %s", self.snapshot_path)
        if self._state is not None:
            from znicz_tpu_torch.units.nn_units import (
                load_snapshot_into_workflow)
            load_snapshot_into_workflow(self._state, wf)
        if self.testing:
            # after initialize, as the JAX launcher sets it: the loader's
            # and the evaluator's testing layouts are not built
            for unit in wf.units:
                if hasattr(unit, "testing"):
                    unit.testing = True
        if not self.dry_run:
            telemetry.install_crash_handler()
            try:
                wf.run()
            except Exception as e:
                if telemetry.journal_enabled() and \
                        getattr(e, "crash_report", None) is None:
                    path = telemetry.write_crash_report(
                        reason="workflow run failed: %r" % e,
                        exc_info=sys.exc_info())
                    try:
                        # the excepthook then writes no second report
                        e.crash_report = path
                    except AttributeError:
                        pass
                raise
        return wf


def snapshot_candidates(directory, prefix):
    """Snapshot paths under ``directory`` named for ``prefix`` by the
    snapshotter, newest first; files still being written (``.part``)
    are left out."""
    if not directory or not os.path.isdir(directory):
        return []
    cands = [os.path.join(directory, f) for f in os.listdir(directory)
             if f.startswith(prefix + "_")
             and ".pickle" in f and not f.endswith(".part")]
    cands.sort(key=os.path.getmtime, reverse=True)
    return cands


def newest_snapshot(directory, prefix):
    """The newest snapshot for ``prefix`` (None when there is none) —
    what ``serve --latest`` serves."""
    cands = snapshot_candidates(directory, prefix)
    return cands[0] if cands else None


#: the JAX package's research samples that sit one level up in the
#: port: ``research.alexnet`` is ``znicz_tpu_torch.samples.alexnet``
FLAT_RESEARCH = ("alexnet", "mnist7", "mnist_ae")


def resolve_workflow_module(spec):
    """The module of a CLI workflow argument: a file path
    (``samples/wine.py``), a dotted module name
    (``znicz_tpu_torch.samples.wine``) or a sample name as the JAX
    package names it (``wine``, ``research.stl10``); the port's flat
    ``alexnet``, ``mnist7`` and ``mnist_ae`` also answer to their bare
    names."""
    if os.path.sep in spec or spec.endswith(".py"):
        path = os.path.abspath(spec)
        name = os.path.splitext(os.path.basename(path))[0]
        module_spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module
    try:
        return importlib.import_module(spec)
    except ImportError as e:
        # fall back to the samples only when SPEC itself was not found
        # (for "research.stl10" the error names "research"); an
        # ImportError from inside a module must surface
        first = spec.split(".")[0]
        if spec.startswith("znicz_tpu") or e.name not in (spec, first):
            raise
        prefix, _, name = spec.partition(".")
        if prefix == "research" and name in FLAT_RESEARCH:
            spec = name
        return importlib.import_module("znicz_tpu_torch.samples." + spec)


def list_samples():
    """The sample names as the JAX package lists them: the modules
    under ``znicz_tpu_torch.samples``, then the research tier's as
    ``research.<name>`` (``FLAT_RESEARCH`` among them), each sorted."""
    import znicz_tpu_torch.samples as samples_pkg
    pkg_dir = os.path.dirname(samples_pkg.__file__)
    tiers = {"": [], "research.": []}
    for prefix, directory in (("", pkg_dir),
                              ("research.",
                               os.path.join(pkg_dir, "research"))):
        for fn in os.listdir(directory):
            if fn.endswith(".py") and not fn.startswith("_"):
                name = fn[:-3]
                tier = "research." if name in FLAT_RESEARCH else prefix
                tiers[tier].append(tier + name)
    return sorted(tiers[""]) + sorted(tiers["research."])


def run_workflow(spec, snapshot=None, testing=False, dry_run=False,
                 device=None, fused=None, auto_resume=False):
    """Drive a workflow module's ``run(load, main)``; ``spec`` is a
    module or anything :func:`resolve_workflow_module` accepts.
    Returns the workflow."""
    module = spec if hasattr(spec, "__file__") else \
        resolve_workflow_module(spec)
    if not hasattr(module, "run"):
        raise SystemExit("%s exposes no run(load, main)" % spec)
    launcher = Launcher(snapshot=snapshot, device=device, dry_run=dry_run,
                        fused=fused, testing=testing,
                        auto_resume=auto_resume)
    module.run(launcher.load, launcher.main)
    return launcher.workflow


def run_supervised(spec, max_restarts=0, restart_backoff_ms=1000.0,
                   restart_backoff_max_ms=30000.0, snapshot=None,
                   testing=False, dry_run=False, device=None, fused=None,
                   auto_resume=False):
    """:func:`run_workflow`, run again after a crash: backed off
    ``restart_backoff_ms * 2**attempt`` (capped at
    ``restart_backoff_max_ms``) and re-entered up to ``max_restarts``
    times with ``auto_resume`` on, so the restart rebuilds the
    workflow and restores the newest resumable snapshot (a ``midepoch``
    one among them) and the run goes on where it stopped; ``snapshot``
    stays the fallback of every attempt.  ``KeyboardInterrupt``,
    ``SystemExit`` and :class:`HealthViolationError` (the halt policy's
    deliberate stop) are never restarted, and neither is a missing
    card: without CUDA, and without ``device="cpu"``, it raises at
    once.  Each restart is counted (``launcher.restarts``) and
    journaled (``launcher.restart``).  Returns the finished workflow."""
    from znicz_tpu_torch.core.health import HealthViolationError

    default_device(device)
    log = Logger(logger_name="Supervisor")
    attempt = 0
    while True:
        try:
            return run_workflow(
                spec, snapshot=snapshot, testing=testing, dry_run=dry_run,
                device=device, fused=fused,
                auto_resume=auto_resume or attempt > 0)
        except (KeyboardInterrupt, SystemExit, HealthViolationError):
            raise
        except Exception as e:  # noqa: BLE001 - the supervised surface
            attempt += 1
            if attempt > max_restarts:
                raise
            delay = min(float(restart_backoff_ms) / 1e3
                        * (2 ** (attempt - 1)),
                        float(restart_backoff_max_ms) / 1e3)
            if telemetry.enabled():
                telemetry.counter("launcher.restarts").inc()
            telemetry.record_event("launcher.restart", attempt=attempt,
                                   max_restarts=max_restarts,
                                   error=repr(e),
                                   backoff_ms=round(delay * 1e3, 3))
            log.warning("run crashed (%r); restart %d/%d with auto-resume "
                        "in %.1f s", e, attempt, max_restarts, delay)
        # the crashed attempt's workflow (its tensors on the card among
        # them) hangs in reference cycles: free it before the next one
        # allocates its own
        gc.collect()
        if delay > 0:
            time.sleep(delay)
