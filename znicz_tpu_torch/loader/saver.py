"""Minibatch stream save and replay.

Counterpart of ``znicz_tpu/loader/saver.py``: ``MinibatchesSaver``
records the minibatch stream a training run saw (after the shuffle and
the normalization) into one file of pickles — a header
``{format, class_lengths, max_minibatch_size, has_labels,
labels_mapping, shuffle_limit}``, then one ``{minibatch_class,
minibatch_size, data, labels}`` record a minibatch — closed when the
workflow finishes; ``read_minibatch_stream`` reads it back;
``MinibatchesLoader`` replays it as a full-batch dataset, its samples
grouped by their recorded class, so a run's exact data trains again
without the original set.  The files are the JAX package's: either
package reads the other's.
"""

import os
import pickle

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import FullBatchLoader, TEST, VALID, TRAIN


class MinibatchesSaver(Unit):
    """Streams every observed minibatch to ``file_name``.

    Header record: dict(class_lengths, max_minibatch_size, has_labels,
    labels_mapping, shuffle_limit).  Then one record per minibatch:
    dict(minibatch_class, minibatch_size, data, labels).  Stop (or
    workflow finish) finalizes the file.
    """

    def __init__(self, workflow, **kwargs):
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.file_name = kwargs.get("file_name")
        self.only_epoch = int(kwargs.get("only_epoch", -1))
        self.demand("minibatch_data", "minibatch_labels",
                    "minibatch_class", "minibatch_size", "class_lengths",
                    "max_minibatch_size", "has_labels")
        self._file = None
        # epochs counted HERE from epoch_ended edges: the loader's own
        # epoch_number is already incremented when the closing minibatch
        # of an epoch is served
        self._epochs_seen = 0

    def initialize(self, device=None, **kwargs):
        super(MinibatchesSaver, self).initialize(device=device, **kwargs)
        if not self.file_name:
            self.file_name = os.path.join(root.common.dirs.cache,
                                          "minibatches.sav")
        os.makedirs(os.path.dirname(self.file_name), exist_ok=True)
        self._file = open(self.file_name, "wb")
        pickle.dump({
            "format": 1,
            "class_lengths": list(self.class_lengths),
            "max_minibatch_size": int(self.max_minibatch_size),
            "has_labels": bool(self.has_labels),
            "labels_mapping": dict(getattr(self, "labels_mapping", {})
                                   or {}),
            "shuffle_limit": getattr(self, "shuffle_limit", 0),
        }, self._file, protocol=4)
        if self.workflow is not None:
            self.workflow.on_workflow_finished(self.stop)

    def run(self):
        if self._file is None:
            return
        epoch = self._epochs_seen
        if bool(getattr(self, "epoch_ended", False)):
            self._epochs_seen += 1
        if 0 <= self.only_epoch != epoch:
            return
        self.minibatch_data.map_read()
        n = int(self.minibatch_size)
        record = {
            "minibatch_class": int(self.minibatch_class),
            "minibatch_size": n,
            "data": numpy.array(self.minibatch_data.mem[:n]),
            "labels": None,
        }
        if self.has_labels and self.minibatch_labels:
            self.minibatch_labels.map_read()
            record["labels"] = numpy.array(self.minibatch_labels.mem[:n])
        pickle.dump(record, self._file, protocol=4)

    def stop(self):
        if self._file is not None:
            self._file.close()
            self._file = None
            self.info("saved minibatch stream -> %s", self.file_name)


def read_minibatch_stream(file_name):
    """(header, [records]) from a MinibatchesSaver file."""
    records = []
    with open(file_name, "rb") as f:
        header = pickle.load(f)
        while True:
            try:
                records.append(pickle.load(f))
            except EOFError:
                break
    return header, records


class MinibatchesLoader(FullBatchLoader):
    """Replays a MinibatchesSaver file as a full-batch dataset.

    Samples are grouped by their recorded ``minibatch_class``; duplicate
    appearances (several epochs saved) are collapsed by saving only the
    first epoch — pass MinibatchesSaver(only_epoch=...) when recording,
    or the replay will contain repeats.
    """

    MAPPING = "minibatches"

    def __init__(self, workflow, **kwargs):
        super(MinibatchesLoader, self).__init__(workflow, **kwargs)
        self.file_name = kwargs["file_name"]

    def load_data(self):
        header, records = read_minibatch_stream(self.file_name)
        per_class = {TEST: [], VALID: [], TRAIN: []}
        labels_per_class = {TEST: [], VALID: [], TRAIN: []}
        for rec in records:
            per_class[rec["minibatch_class"]].append(rec["data"])
            if rec["labels"] is not None:
                labels_per_class[rec["minibatch_class"]].append(
                    rec["labels"])
        datas, labels = [], []
        for clazz in (TEST, VALID, TRAIN):
            chunks = per_class[clazz]
            self.class_lengths[clazz] = sum(c.shape[0] for c in chunks)
            datas.extend(chunks)
            labels.extend(labels_per_class[clazz])
        if not datas:
            raise ValueError("empty minibatch stream %s" % self.file_name)
        self.original_data.reset(numpy.concatenate(datas, axis=0))
        del self._original_labels[:]
        for chunk in labels:
            self._original_labels.extend(int(v) for v in chunk)
