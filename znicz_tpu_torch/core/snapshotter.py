"""Checkpoint and resume.

Counterpart of ``znicz_tpu/core/snapshotter.py`` (``SnapshotterBase``
:54, ``SnapshotterToFile`` :168 with ``import_`` and its compression
choices).  A snapshot is a pickle, compressed with gz, bz2, xz or not
at all, of

    {"format": 1, "workflow": <class name>, "config": <json>,
     "units": {unit.name: {attr: value for attr in unit.exports}},
     "prng": <the prng streams' states>, "suffix": "...", "time": ...}

and holds numpy arrays and Python values only, never tensors (the
trainer's ``torch.Generator`` state among them), so a snapshot taken
on the card resumes on the card or on the CPU.  It is named
``<prefix>_<suffix>.<pid>.pickle[.<compression>]`` and published
atomically.  A unit-graph workflow's snapshot also carries
``"topology"``, the array-free manifest of its forward stack
(:func:`znicz_tpu_torch.export.forward_topology`, the JAX package's
``_forward_topology`` :199-201, :237-253) that lets the serving engine
serve the snapshot; a fused workflow's forwards are its trainer alone,
which no layer type describes, so its snapshots carry none.

``SnapshotterToDB`` (``odbc``, JAX :265) writes the same files: the
reference's ODBC store has no server here.

Mid-epoch snapshots (JAX :65-116): with ``window_interval`` N the
fused trainer calls :meth:`SnapshotterBase.window_tick` after every
TRAIN window that is not its segment's last, and every N-th writes a
snapshot under the ``midepoch`` suffix.  With the loader's cursor, the
prng streams, the trainer's drained epoch accumulator and its
generator in the payload, a run killed mid-epoch resumes
(``--auto-resume``) into the windows the uninterrupted run
dispatches.  Both triggers advance their interval only after an export
succeeded, so a failed write is tried again at the next one.  The
``snapshot.write`` fault site sits before the write.

In a multi-process run (a ``torch.distributed`` world) every rank
collects the state, since a mesh's trainer gathers its split layers
and folds its accumulator there (collectives), and only rank 0 writes
(JAX :132, :176); every rank restores from the shared directory.  The
time trigger is rank 0's, so the ranks export together.
"""

import bz2
import gzip
import lzma
import os
import pickle
import time

import numpy

from znicz_tpu_torch.core import faults, prng, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.units import Unit

_WRITERS = {"": open, "gz": gzip.open, "bz2": bz2.open, "xz": lzma.open}


def _world():
    """``(rank, size)`` of the ``torch.distributed`` world."""
    from znicz_tpu_torch.parallel.mesh import world
    return world()


class SnapshotterRegistry(type):
    mapping = {}

    def __init__(cls, name, bases, clsdict):
        super(SnapshotterRegistry, cls).__init__(name, bases, clsdict)
        mapping = clsdict.get("MAPPING", None)
        if mapping:
            SnapshotterRegistry.mapping[mapping] = cls


class SnapshotterBase(Unit, metaclass=SnapshotterRegistry):
    """Collects the units' exports and writes a snapshot when fired."""

    def __init__(self, workflow, **kwargs):
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        self.prefix = kwargs.get("prefix", "snapshot")
        self.compression = kwargs.get("compression", "gz")
        if (self.compression or "") not in _WRITERS:
            raise ValueError("unknown compression %r (known: %s)"
                             % (self.compression, sorted(_WRITERS)))
        self.directory = kwargs.get("directory", root.common.dirs.snapshots)
        self.interval = kwargs.get("interval", 1)
        self.time_interval = kwargs.get("time_interval", 0)
        #: every N fused TRAIN windows a ``midepoch`` snapshot (0: off)
        self.window_interval = int(kwargs.get("window_interval", 0))
        self.suffix = None
        self.destination = None
        self._last_time = 0.0
        self._since_fire = 0
        self._windows_since = 0

    def initialize(self, device=None, **kwargs):
        super(SnapshotterBase, self).initialize(device=device, **kwargs)
        os.makedirs(self.directory, exist_ok=True)

    def run(self):
        self._since_fire += 1
        if self._since_fire < self.interval:
            return
        due = time.time() - self._last_time >= self.time_interval
        if self.time_interval and _world()[1] > 1:
            from znicz_tpu_torch.parallel import multihost
            due = multihost.agree(due)
        if not due:
            return
        self._metered_export()
        # the interval advances only after a successful export
        self._since_fire = 0
        self._last_time = time.time()

    def window_tick(self):
        """The fused trainer's call after each TRAIN window that is not
        its segment's last: every ``window_interval``-th writes a
        snapshot under the ``midepoch`` suffix and returns its path
        (None when off or not due).  The count starts again only after
        an export succeeded."""
        if not self.window_interval:
            return None
        self._windows_since += 1
        if self._windows_since < self.window_interval:
            return None
        saved = self.suffix
        self.suffix = "midepoch"
        try:
            wrote = self._metered_export()
        finally:
            self.suffix = saved
        self._windows_since = 0
        return wrote

    def _metered_export(self):
        """:meth:`export`, counted (``snapshotter.exports``) and timed
        (``snapshotter.export_seconds``) when telemetry is on."""
        if not telemetry.enabled():
            return self.export()
        t0 = time.perf_counter()
        wrote = self.export()
        # created on every rank (the ranks' series must match for the
        # merged view) but recorded for a write only: merged counters
        # must not multiply one snapshot by the world's size
        exports = telemetry.counter("snapshotter.exports")
        seconds = telemetry.histogram("snapshotter.export_seconds")
        if wrote:
            exports.inc()
            seconds.observe(time.perf_counter() - t0)
        return wrote

    def export(self):
        """Write a snapshot; return its path, or None where this rank
        does not write."""
        raise NotImplementedError

    def collect_state(self):
        """``{unit name: {attr: host value}}`` from the units' exports."""
        state = {}
        for unit in self.workflow.units:
            exports = getattr(unit, "exports", None)
            if not exports:
                continue
            ustate = {}
            for attr in exports:
                try:
                    v = getattr(unit, attr)
                except AttributeError:
                    continue
                if isinstance(v, Array):
                    v = None if not v else numpy.array(v.mem)
                ustate[attr] = v
            state[unit.name] = ustate
        return state


class SnapshotterToFile(SnapshotterBase):
    """File snapshots."""

    MAPPING = "file"

    def export(self, units_state=None):
        units_state = self.collect_state() if units_state is None \
            else units_state
        rank, size = _world()
        if size == 1:
            return self._write(units_state)
        # one writer: the ranks hold the same state, and concurrent
        # writers would race on the same prefix; the others wait for its
        # file, which a restart of any rank may resume from
        import torch.distributed as dist
        try:
            return self._write(units_state) if rank == 0 else None
        finally:
            dist.barrier()

    def _write(self, units_state):
        """Publish ``units_state`` as this snapshotter's file; returns
        its path."""
        payload = {
            "format": 1,
            "workflow": type(self.workflow).__name__,
            "config": root.to_json(),
            "units": units_state,
            # the streams' states make a resumed run draw what the
            # uninterrupted one draws
            "prng": prng.states(),
            "suffix": self.suffix,
            "time": time.time(),
        }
        topology = self._forward_topology()
        if topology is not None:
            payload["topology"] = topology
        ext = "." + self.compression if self.compression else ""
        name = "%s_%s.%d.pickle%s" % (
            self.prefix, self.suffix or "current", os.getpid(), ext)
        self.destination = os.path.join(self.directory, name)
        if faults.enabled():
            faults.check("snapshot.write")
        # atomic and durable publish: a crash mid-write never leaves a
        # truncated file under the published name, and the file's blocks
        # and then its directory entry are on disk before the name is
        # announced
        tmp = self.destination + ".part"
        with _WRITERS[self.compression or ""](tmp, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.destination)
        dfd = os.open(os.path.dirname(self.destination) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self.info("snapshot -> %s", self.destination)
        telemetry.record_event("snapshot", path=self.destination,
                               suffix=self.suffix)
        return self.destination

    def _forward_topology(self):
        """The serving topology of the workflow's forward stack, or None
        (with a warning) where no layer type describes it: a snapshot
        never fails over serving metadata."""
        wf = self.workflow
        if not getattr(wf, "forwards", None):
            return None
        try:
            from znicz_tpu_torch.export import forward_topology
            topology = forward_topology(wf)
        except Exception as e:  # noqa: BLE001 - serving is optional
            self.warning("snapshot carries no serving topology (%s)", e)
            return None
        return topology if topology["layers"] else None

    @staticmethod
    def import_(file_name):
        """Load a snapshot's state dict (only files this program wrote:
        unpickling runs code)."""
        ext = os.path.splitext(file_name)[1].lstrip(".")
        with _WRITERS.get(ext, open)(file_name, "rb") as f:
            return pickle.load(f)


class SnapshotterToDB(SnapshotterBase):
    """The ``odbc`` snapshotter: the JAX package's file-backed stand-in
    for the reference's ODBC store, writing what
    :class:`SnapshotterToFile` writes."""

    MAPPING = "odbc"

    def export(self, units_state=None):
        return SnapshotterToFile.export(self, units_state)

    _write = SnapshotterToFile._write
    _forward_topology = SnapshotterToFile._forward_topology
