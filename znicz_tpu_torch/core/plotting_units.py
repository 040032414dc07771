"""Plotting units — plotters that record their data and may render it.

Counterpart of ``znicz_tpu/core/plotting_units.py``: ``Plotter``,
``AccumulatingPlotter``, ``MatrixPlotter``, ``MultiHistogram``,
``ImagePlotter``, ``ImmediatePlotter`` and ``TableMaxMin``.  Each
plotter records its data in ``fill`` (host numpy, inspectable and
tested) and, unless ``root.common.disable.plotting`` (the default),
renders a PNG under ``<root.common.dirs.cache>/plots`` in ``redraw``
through matplotlib's Agg backend.  Plotting asked for without
matplotlib raises ``ImportError``: a plotter never skips a render it
was asked for.

A plotter reads device Arrays through ``map_read``, one copy from the
card an Array that only the card holds.  ``TableMaxMin`` reads many
Arrays, so it takes their maxima and minima on the card and reads them
all back in one copy (``memory.host_fetch``): the same values as the
host's ``max`` / ``min``, one readback a fire.
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array, host_fetch
from znicz_tpu_torch.core.units import Unit


class IPlotter(object):
    """Marker interface."""


class Plotter(Unit, IPlotter):
    """Base plotter: gather data in ``fill``, render in ``redraw``."""

    def __init__(self, workflow, **kwargs):
        super(Plotter, self).__init__(workflow, **kwargs)
        self.clear_plot = kwargs.get("clear_plot", False)
        self.redraw_plot = kwargs.get("redraw_plot", True)
        self._fig_path = None
        #: called before each ``fill``: a plotter of the fused
        #: trainer's weight views points them at the live weights
        self.before_fill = None

    @property
    def plotting_enabled(self):
        return not root.common.disable.plotting

    def _figure(self):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt

    def _save_figure(self, plt):
        out_dir = os.path.join(root.common.dirs.cache, "plots")
        os.makedirs(out_dir, exist_ok=True)
        self._fig_path = os.path.join(out_dir, "%s.png" % self.name)
        plt.savefig(self._fig_path)
        plt.close("all")

    def run(self):
        if self.before_fill is not None:
            self.before_fill()
        self.fill()
        if self.plotting_enabled and self.redraw_plot:
            self.redraw()

    def fill(self):
        pass

    def redraw(self):
        pass

    @staticmethod
    def resolve(value, field=None):
        """The host numpy value of ``value``: ``field`` picks an
        attribute, a container's key or an array's row (an integer
        field), an Array is read to the host."""
        if field is not None:
            if isinstance(value, (dict, list, tuple)):
                value = value[field]
            elif isinstance(field, int):
                if hasattr(value, "map_read"):
                    value.map_read()
                    value = value.mem
                if value is None:
                    return None
                value = numpy.asarray(value)[field]
            else:
                value = getattr(value, field)
        if value is None:
            return None
        if hasattr(value, "map_read"):
            value.map_read()
            value = value.mem
        return numpy.asarray(value)


def _empty(value):
    """None or an empty Array (a weightless layer's)."""
    return value is None or (hasattr(value, "__bool__") and not value)


class AccumulatingPlotter(Plotter):
    """Accumulates a scalar over time (error curves)."""

    def __init__(self, workflow, **kwargs):
        super(AccumulatingPlotter, self).__init__(workflow, **kwargs)
        self.plot_style = kwargs.get("plot_style", "r-")
        self.label = kwargs.get("name", self.name)
        self.input = None
        self.input_field = kwargs.get("input_field", None)
        self.input_offset = kwargs.get("input_offset", 0)
        self.values = []

    def _current_value(self):
        arr = self.resolve(self.input, self.input_field)
        if arr is None or (arr.ndim == 0 and arr == None):  # noqa: E711
            return None
        if arr.dtype == object:
            return None
        if arr.ndim:
            arr = arr.ravel()[self.input_offset]
        return float(arr)

    def fill(self):
        v = self._current_value()
        if v is not None:
            self.values.append(v)

    def redraw(self):
        plt = self._figure()
        plt.figure()
        plt.plot(self.values, self.plot_style)
        plt.title(self.label)
        self._save_figure(plt)


class MatrixPlotter(Plotter):
    """A matrix (the confusion matrix)."""

    def __init__(self, workflow, **kwargs):
        super(MatrixPlotter, self).__init__(workflow, **kwargs)
        self.input = None
        self.input_field = kwargs.get("input_field", None)
        self.current = None

    def fill(self):
        self.current = numpy.array(self.resolve(self.input,
                                                self.input_field))

    def redraw(self):
        if self.current is None:
            return
        plt = self._figure()
        plt.figure()
        plt.imshow(self.current, interpolation="nearest", cmap="viridis")
        plt.colorbar()
        plt.title(self.name)
        self._save_figure(plt)


class MultiHistogram(Plotter):
    """Histograms of the first ``hist_number`` rows of a weights Array."""

    def __init__(self, workflow, **kwargs):
        super(MultiHistogram, self).__init__(workflow, **kwargs)
        self.input = None
        self.hist_number = kwargs.get("hist_number", 16)
        self.n_bars = kwargs.get("n_bars", 25)
        self.histograms = []

    def fill(self):
        if _empty(self.input):
            return
        mem = self.resolve(self.input)
        if mem is None or mem.ndim == 0:
            return
        rows = mem.reshape(mem.shape[0], -1)
        self.histograms = [
            numpy.histogram(rows[i], bins=self.n_bars)
            for i in range(min(self.hist_number, rows.shape[0]))]

    def redraw(self):
        if not self.histograms:
            return
        plt = self._figure()
        n = len(self.histograms)
        cols = int(numpy.ceil(numpy.sqrt(n)))
        rows_n = int(numpy.ceil(n / cols))
        _, axes = plt.subplots(rows_n, cols, squeeze=False)
        for i, (hist, edges) in enumerate(self.histograms):
            ax = axes[i // cols][i % cols]
            ax.bar(edges[:-1], hist, width=numpy.diff(edges))
        self._save_figure(plt)


class ImagePlotter(Plotter):
    """Input samples as images."""

    def __init__(self, workflow, **kwargs):
        super(ImagePlotter, self).__init__(workflow, **kwargs)
        self.inputs = []
        self.input_fields = []
        self.current = None

    def fill(self):
        self.current = [
            numpy.array(self.resolve(v, field))
            for v, field in zip(
                self.inputs,
                self.input_fields or [None] * len(self.inputs))]

    def redraw(self):
        if not self.current:
            return
        plt = self._figure()
        _, axes = plt.subplots(1, len(self.current), squeeze=False)
        for ax, img in zip(axes[0], self.current):
            img = numpy.squeeze(numpy.asarray(img, dtype=numpy.float64))
            if img.ndim == 1:
                ax.plot(img)
            else:
                ax.imshow(img if img.ndim == 2 else img[..., :3],
                          cmap="gray")
        self._save_figure(plt)


class ImmediatePlotter(Plotter):
    """A list of 1D arrays, plotted anew each fire."""

    def __init__(self, workflow, **kwargs):
        super(ImmediatePlotter, self).__init__(workflow, **kwargs)
        self.inputs = []
        self.input_fields = []
        self.input_styles = kwargs.get("input_styles", ["k-", "g-", "b-"])
        self.current = []

    def fill(self):
        self.current = [
            self.resolve(v, field).ravel()
            for v, field in zip(
                self.inputs,
                self.input_fields or [None] * len(self.inputs))]

    def redraw(self):
        plt = self._figure()
        plt.figure()
        for arr, style in zip(self.current, self.input_styles):
            plt.plot(arr, style)
        self._save_figure(plt)


class TableMaxMin(Plotter):
    """A row of ``(max, min)`` of each Array in ``y`` a fire (NaNs for
    an empty one), logged beside ``col_labels``."""

    def __init__(self, workflow, y_max_rows=2, x_cols=1, **kwargs):
        super(TableMaxMin, self).__init__(workflow, **kwargs)
        self.y = []
        self.col_labels = []
        self.rows = []

    def fill(self):
        import torch
        nan = (float("nan"), float("nan"))
        row = [nan] * len(self.y)
        on_card = {}
        for k, v in enumerate(self.y):
            if _empty(v):
                continue
            if isinstance(v, Array) and v.host_stale:
                t = v.dev
                if t.dim():
                    on_card[k] = torch.stack((t.max(), t.min()))
                continue
            arr = self.resolve(v)
            if arr is not None and arr.ndim:
                row[k] = (float(arr.max()), float(arr.min()))
        for k, mm in host_fetch(on_card).items():
            row[k] = (float(mm[0]), float(mm[1]))
        self.rows.append(row)
        for label, (mx, mn) in zip(self.col_labels, row):
            self.debug("%s: max %.6f min %.6f", label, mx, mn)
