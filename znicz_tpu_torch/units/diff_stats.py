"""DiffStats — a gradient-statistics probe.

Counterpart of ``znicz_tpu/units/diff_stats.py``: each run appends a
record ``{unit name: {attr: {min, max, avg, std, nans}}}`` of the
chosen Arrays of the chosen units to ``history``; :meth:`flush` pickles
the history to ``file_name`` (``StandardWorkflow.link_gd_diff_stats``
registers it with the workflow's ``on_workflow_finished``).  The
Arrays are read in one copy from the card a run.
"""

import pickle

import numpy

from znicz_tpu_torch.core.memory import Array, host_fetch
from znicz_tpu_torch.core.units import Unit


class DiffStats(Unit):
    """kwargs: ``arrays`` (``{unit: (attr names)}`` to record) and
    ``file_name`` (the pickle :meth:`flush` writes)."""

    def __init__(self, workflow, **kwargs):
        super(DiffStats, self).__init__(workflow, **kwargs)
        self.arrays = kwargs.get("arrays", {})
        self.file_name = kwargs.get("file_name", "diff_stats.pickle")
        self.history = []

    def run(self):
        picked = {}
        for unit, names in self.arrays.items():
            for name in names:
                arr = getattr(unit, name, None)
                if isinstance(arr, Array) and arr:
                    picked[(unit.name, name)] = arr
        # the Arrays only the card holds, in one copy
        fetched = host_fetch({i: arr.dev for i, (key, arr) in
                              enumerate(picked.items()) if arr.host_stale})
        record = {}
        for unit in self.arrays:
            record.setdefault(unit.name, {})
        for i, ((uname, name), arr) in enumerate(picked.items()):
            mem = fetched[i] if i in fetched else arr.mem
            record[uname][name] = {
                "min": float(mem.min()), "max": float(mem.max()),
                "avg": float(mem.mean()), "std": float(mem.std()),
                "nans": int(numpy.isnan(mem).sum()),
            }
        self.history.append(record)

    def flush(self):
        with open(self.file_name, "wb") as fout:
            pickle.dump(self.history, fout)
        self.info("wrote %d records to %s", len(self.history),
                  self.file_name)
