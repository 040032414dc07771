"""LabelsPrinter — the predicted labels of a forward workflow, tallied.

Counterpart of ``znicz_tpu/units/labels_printer.py`` (:12-31): each
fire reads its input (the softmax head's ``max_idx``) from the device
once and counts every label; :meth:`LabelsPrinter.print_top` logs the
most common.
"""

from collections import Counter

from znicz_tpu_torch.core.units import Unit


class LabelsPrinter(Unit):
    """Counts the labels of ``input`` over its fires."""

    def __init__(self, workflow, **kwargs):
        super(LabelsPrinter, self).__init__(workflow, **kwargs)
        self.top_number = kwargs.get("top_number", 5)
        self.counter = Counter()
        self.demand("input")  # max_idx of the softmax head

    def run(self):
        self.input.map_read()
        for v in self.input.mem.ravel():
            self.counter[int(v)] += 1

    def print_top(self):
        for label, count in self.counter.most_common(self.top_number):
            self.info("label %d: %d samples", label, count)

    def reset(self):
        self.counter.clear()
