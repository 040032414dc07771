"""Workflow launcher — the ``run(load, main)`` contract behind the CLI.

Counterpart of ``znicz_tpu/launcher.py`` (``Launcher`` :29 with
``load`` :110 and ``main`` :282, ``snapshot_candidates`` and
``newest_snapshot`` :335-353, ``resolve_workflow_module`` :356,
``run_workflow`` :401).  A workflow module ends with
``run(load, main)``, where

* ``load(factory, **kwargs) -> (workflow, snapshot_loaded)`` builds
  the workflow and, with ``--snapshot``, reads the state to restore;
* ``main(**kwargs)`` chooses cuDNN's deterministic algorithms
  (:func:`znicz_tpu_torch.core.backends.deterministic`), initializes
  the workflow on the launcher's device (the card unless
  ``device="cpu"``), applies the snapshot, and runs unless
  ``dry_run``.

Multi-process runs, auto-resume, supervised restarts and crash
reports are not in this slice of the port (``ROADMAP.md``).
"""

import importlib
import importlib.util
import os

from znicz_tpu_torch.core.backends import default_device, deterministic
from znicz_tpu_torch.core.logger import Logger


class Launcher(Logger):
    """A standalone launcher implementing ``load`` / ``main``."""

    def __init__(self, snapshot=None, device=None, dry_run=False,
                 fused=None):
        super(Launcher, self).__init__(logger_name="Launcher")
        self.snapshot_path = snapshot
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

    def main(self, **kwargs):
        """Initialize (and restore), then run unless ``dry_run``."""
        wf = self.workflow
        if wf is None:
            raise RuntimeError("main() before load()")
        # the card's algorithms are chosen before the first one runs
        deterministic(default_device(self.device))
        wf.initialize(device=self.device, **kwargs)
        if self._state is not None:
            from znicz_tpu_torch.units.nn_units import (
                load_snapshot_into_workflow)
            load_snapshot_into_workflow(self._state, wf)
        if not self.dry_run:
            wf.run()
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


def run_workflow(spec, snapshot=None, dry_run=False, device=None,
                 fused=None):
    """Drive a workflow module's ``run(load, main)``; ``spec`` is a
    module or anything :func:`resolve_workflow_module` accepts.
    Returns the workflow."""
    module = spec if hasattr(spec, "__file__") else \
        resolve_workflow_module(spec)
    if not hasattr(module, "run"):
        raise SystemExit("%s exposes no run(load, main)" % spec)
    launcher = Launcher(snapshot=snapshot, device=device, dry_run=dry_run,
                        fused=fused)
    module.run(launcher.load, launcher.main)
    return launcher.workflow
