"""The NN workflow and its snapshotter.

Counterpart of the snapshot part of ``znicz_tpu/units/nn_units.py``:
``NNWorkflow`` (:524), ``NNSnapshotterToFile`` ("nnfile", :570) with
its per-tensor min/max/avg log and NaN check, and
``load_snapshot_into_workflow`` (:574).  The mapping of a snapshot
between the fused and the unit-graph modes (:606) is not in this slice
of the port (``ROADMAP.md``): a snapshot resumes in the mode that
wrote it.
"""

import numpy

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.core.workflow import Repeater


class NNWorkflow(AcceleratedWorkflow):
    """Workflow with the canonical NN slots."""

    def __init__(self, workflow=None, **kwargs):
        super(NNWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.loader = None
        self.evaluator = None
        self.decision = None


class NNSnapshotterToFile(SnapshotterToFile):
    """File snapshots that log min/max/avg of every exported array (the
    units' own, not those inside a nested export such as the trainer's
    state) and warn of NaN or inf; ``skip`` is one more Bool gate."""

    MAPPING = "nnfile"

    def __init__(self, workflow, **kwargs):
        super(NNSnapshotterToFile, self).__init__(workflow, **kwargs)
        self.skip = kwargs.get("skip", None)

    def _log_attr(self, name, value):
        if not isinstance(value, numpy.ndarray) or value.size == 0:
            return
        self.debug("%s: min %.6f max %.6f avg %.6f", name, value.min(),
                   value.max(), value.mean())
        if not numpy.isfinite(value).all():
            self.warning("NaN/inf detected in %s", name)

    def export(self):
        state = self.collect_state()
        for uname, ustate in state.items():
            for attr, value in ustate.items():
                self._log_attr("%s.%s" % (uname, attr), value)
        return super(NNSnapshotterToFile, self).export(units_state=state)

    def run(self):
        if self.skip is not None and bool(self.skip):
            return
        super(NNSnapshotterToFile, self).run()


def load_snapshot_into_workflow(state, workflow):
    """Apply a snapshot's state dict onto a built, initialized
    workflow: the prng streams' states, then every unit's exports
    (weights, optimizer state and generator, decision bookkeeping,
    loader position).  Resuming this way continues bit for bit."""
    if "prng" in state:
        prng.restore(state["prng"])
    units = {u.name: u for u in workflow.units}
    for uname, ustate in state["units"].items():
        u = units.get(uname)
        if u is None:
            continue
        for attr, value in ustate.items():
            cur = getattr(u, attr, None)
            if isinstance(cur, Array):
                if value is not None:
                    cur.reset(numpy.array(value))
            else:
                setattr(u, attr, value)
