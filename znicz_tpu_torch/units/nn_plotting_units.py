"""NN plotters: weight grids, the MSE histogram and the Kohonen maps.

Counterpart of ``znicz_tpu/units/nn_plotting_units.py``: ``Weights2D``
(weight matrices as an image grid), ``MSEHistogram`` (the evaluator's
per-sample MSE) and the Kohonen map plotters (``KohonenHits``,
``KohonenInputMaps``, ``KohonenNeighborMap``,
``KohonenValidationResults``, :109-346, on the hexagonal grid
geometry of ``KohonenGridBase``).  The same record-then-render model
as :mod:`znicz_tpu_torch.core.plotting_units`: each records its data in
``fill`` and renders only when plotting is enabled.
"""

import numpy

from znicz_tpu_torch.core.plotting_units import Plotter, _empty


class Weights2D(Plotter):
    """Weight matrices as a grid of images
    (reference nn_plotting_units.py:52-218)."""

    def __init__(self, workflow, **kwargs):
        super(Weights2D, self).__init__(workflow, **kwargs)
        self.input = None
        self.input_field = kwargs.get("input_field", None)
        self.limit = kwargs.get("limit", 64)
        self.color_space = kwargs.get("color_space", "RGB")
        self.transposed = kwargs.get("transposed", False)
        self.grid = None

    def _mem(self):
        return self.resolve(self.input, self.input_field)

    @staticmethod
    def normalize_image(a):
        """(reference nn_plotting_units.py:166-184)"""
        a = a.astype(numpy.float64)
        lo, hi = a.min(), a.max()
        if hi == lo:
            return numpy.zeros_like(a)
        return (a - lo) / (hi - lo)

    def fill(self):
        if _empty(self.input):
            return
        mem = self._mem()
        if self.transposed:
            mem = mem.T
        mem = mem.reshape(mem.shape[0], -1)[:self.limit]
        side = int(numpy.round(numpy.sqrt(mem.shape[1])))
        rgb_side = int(numpy.round(numpy.sqrt(mem.shape[1] // 3))) \
            if mem.shape[1] % 3 == 0 else 0
        if side * side == mem.shape[1]:
            imgs = [self.normalize_image(r.reshape(side, side))
                    for r in mem]
        elif rgb_side and rgb_side * rgb_side * 3 == mem.shape[1]:
            imgs = [self.normalize_image(r.reshape(rgb_side, rgb_side, 3))
                    for r in mem]
        else:
            imgs = [self.normalize_image(r.reshape(1, -1)) for r in mem]
        self.grid = imgs

    def redraw(self):
        if not self.grid:
            return
        plt = self._figure()
        n = len(self.grid)
        cols = int(numpy.ceil(numpy.sqrt(n)))
        rows = int(numpy.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, squeeze=False)
        for i in range(rows * cols):
            ax = axes[i // cols][i % cols]
            ax.axis("off")
            if i < n:
                img = self.grid[i]
                ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        self._save_figure(plt)


class MSEHistogram(Plotter):
    """Histogram of the evaluator's per-sample MSE
    (reference nn_plotting_units.py:220-343)."""

    def __init__(self, workflow, **kwargs):
        super(MSEHistogram, self).__init__(workflow, **kwargs)
        self.mse = None
        self.bars = kwargs.get("bars", 35)
        self.hist = None
        self.edges = None
        self.mse_min = None
        self.mse_max = None
        self.demand("mse")

    def fill(self):
        arr = self.resolve(self.mse).ravel()
        self.mse_min = float(arr.min())
        self.mse_max = float(arr.max())
        self.hist, self.edges = numpy.histogram(arr, bins=self.bars)

    def redraw(self):
        if self.hist is None:
            return
        plt = self._figure()
        plt.figure()
        plt.bar(self.edges[:-1], self.hist, width=numpy.diff(self.edges))
        plt.title("%s [%.4g, %.4g]" % (self.name, self.mse_min,
                                       self.mse_max))
        self._save_figure(plt)


class KohonenGridBase(Plotter):
    """Hexagonal-grid geometry shared by the Kohonen map plotters
    (reference nn_plotting_units.py:345-408: odd rows shift +0.5 in x,
    rows are 1.5/sqrt(3) apart)."""

    def __init__(self, workflow, **kwargs):
        super(KohonenGridBase, self).__init__(workflow, **kwargs)
        self.shape = None
        self.demand("shape")

    @property
    def width(self):
        return self.shape[0]

    @property
    def height(self):
        return self.shape[1]

    def hex_centers(self):
        """(cx, cy) arrays of cell centers, neuron-index (row-major)
        order."""
        y, x = numpy.mgrid[0:self.height, 0:self.width]
        cx = x + 0.5 * (y & 1)
        cy = y * (1.5 / numpy.sqrt(3.0))
        return cx.ravel().astype(float), cy.ravel()

    def _hex_scatter(self, ax, values, sizes=None, cmap="YlOrRd"):
        cx, cy = self.hex_centers()
        s = 500.0 * (numpy.asarray(sizes, float) ** 2
                     if sizes is not None else numpy.ones(cx.size))
        sc = ax.scatter(cx, cy, c=values, s=s, marker="h", cmap=cmap)
        ax.set_xlim(-1.0, self.width + 0.5)
        ax.set_ylim(-1.0, self.height * numpy.sqrt(3.0) / 2.0)
        ax.set_xticks(())
        ax.set_yticks(())
        return sc


class KohonenHits(KohonenGridBase):
    """Winner counts per neuron: hexagon area proportional to
    hits/hits_max (reference nn_plotting_units.py:410-494)."""

    SIZE_TEXT_THRESHOLD = 0.33

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Kohonen Hits")
        super(KohonenHits, self).__init__(workflow, **kwargs)
        self.input = None
        self.hits = None
        self.sizes = None
        self.demand("input")

    def fill(self):
        hits = numpy.asarray(self.resolve(self.input)).ravel()
        hits_max = hits.max() if hits.size and hits.max() else 1
        self.hits = hits
        # linear hexagon size ~ sqrt of the relative hit count
        self.sizes = numpy.sqrt(hits / hits_max)

    def redraw(self):
        if self.hits is None or not self.hits.size:
            return
        plt = self._figure()
        fig, ax = plt.subplots()
        self._hex_scatter(ax, self.hits, sizes=self.sizes)
        cx, cy = self.hex_centers()
        for i in range(self.hits.size):
            if self.sizes[i] > self.SIZE_TEXT_THRESHOLD:
                ax.annotate(int(self.hits[i]), xy=(cx[i], cy[i]),
                            ha="center", va="center", color="white",
                            size=8)
        ax.set_title(self.name)
        self._save_figure(plt)


class KohonenInputMaps(KohonenGridBase):
    """Per-input-dimension weight planes over the map grid, min-max
    normalized (reference nn_plotting_units.py:496-585)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Kohonen Maps")
        super(KohonenInputMaps, self).__init__(workflow, **kwargs)
        self.input = None
        self.maps = None
        self.demand("input")

    def fill(self):
        w = numpy.asarray(self.resolve(self.input), dtype=float)
        maps = []
        for index in range(w.shape[1]):
            arr = w[:, index]
            amin, amax = arr.min(), arr.max()
            maps.append((arr - amin) / (amax - amin)
                        if amax > amin else numpy.zeros_like(arr))
        self.maps = maps

    def redraw(self):
        if not self.maps:
            return
        plt = self._figure()
        n = len(self.maps)
        cols = int(numpy.ceil(numpy.sqrt(n)))
        rows = int(numpy.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, squeeze=False)
        for i in range(rows * cols):
            ax = axes[i // cols][i % cols]
            if i < n:
                self._hex_scatter(ax, self.maps[i])
            else:
                ax.axis("off")
        self._save_figure(plt)


class KohonenNeighborMap(KohonenGridBase):
    """U-matrix-style neighbor weight distances: one value per link
    between hex-adjacent neurons — horizontal, vertical, and the
    parity-dependent diagonal (reference nn_plotting_units.py:587-760)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Kohonen Neighbor Weight Distances")
        super(KohonenNeighborMap, self).__init__(workflow, **kwargs)
        self.input = None
        self.links = None       # list of ((x1, y1), (x2, y2))
        self.link_values = None
        self.demand("input")

    def neighbor_pairs(self):
        """Reference link enumeration order (nn_plotting_units.py:633-678):
        horizontal rows, then vertical + parity diagonal per cell."""
        pairs = []
        for y in range(self.height):
            for x in range(self.width - 1):
                pairs.append(((x, y), (x + 1, y)))
        for y in range(self.height - 1):
            for x in range(self.width):
                pairs.append(((x, y), (x, y + 1)))
                if y & 1:
                    if x == self.width - 1:
                        continue
                    pairs.append(((x, y), (x + 1, y + 1)))
                else:
                    if x == 0:
                        continue
                    pairs.append(((x, y), (x - 1, y + 1)))
        return pairs

    def fill(self):
        w = numpy.asarray(self.resolve(self.input), dtype=float)
        self.links = self.neighbor_pairs()
        vals = numpy.empty(len(self.links))
        for i, ((x1, y1), (x2, y2)) in enumerate(self.links):
            vals[i] = numpy.linalg.norm(
                w[y1 * self.width + x1] - w[y2 * self.width + x2])
        self.link_values = vals

    def redraw(self):
        if self.link_values is None or not len(self.link_values):
            return
        plt = self._figure()
        fig, ax = plt.subplots()
        amin, amax = self.link_values.min(), self.link_values.max()
        norm = ((self.link_values - amin) / (amax - amin)
                if amax > amin else numpy.zeros_like(self.link_values))
        cmap = plt.get_cmap("YlOrRd")
        shift = 1.5 / numpy.sqrt(3.0)
        for ((x1, y1), (x2, y2)), v in zip(self.links, norm):
            ax.plot([x1 + 0.5 * (y1 & 1), x2 + 0.5 * (y2 & 1)],
                    [y1 * shift, y2 * shift], color=cmap(v), linewidth=3)
        self._hex_scatter(ax, numpy.zeros(self.width * self.height),
                          sizes=numpy.full(self.width * self.height, 0.4))
        ax.set_title(self.name)
        self._save_figure(plt)


class KohonenValidationResults(KohonenGridBase):
    """Winning-neuron to category mapping + per-neuron fitness
    (reference nn_plotting_units.py:767-902)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Kohonen Validation Results")
        super(KohonenValidationResults, self).__init__(workflow, **kwargs)
        self.input = None
        self.result = None
        self.fitness = None
        self.fitness_by_label = None
        self.fitness_by_neuron = None
        self.neuron_labels = None
        self.neuron_fitness = None
        self.demand("input", "result", "fitness", "fitness_by_label",
                    "fitness_by_neuron")

    def fill(self):
        n = self.width * self.height
        # result maps label -> neurons (dict or list); invert it
        labels = numpy.full(n, -1, dtype=int)
        result = self.result  # label -> neuron collection; not an array
        items = result.items() if hasattr(result, "items") else \
            enumerate(result)
        for label, neurons in items:
            for neuron in neurons:
                labels[int(neuron)] = int(label)
        fitness = numpy.zeros(n)
        fbn = self.fitness_by_neuron  # dict or sequence keyed by neuron
        for neuron in range(n):
            try:
                fitness[neuron] = float(fbn[neuron])
            except (KeyError, IndexError):
                fitness[neuron] = 0.0
        self.neuron_labels = labels
        self.neuron_fitness = fitness

    def redraw(self):
        if self.neuron_labels is None:
            return
        plt = self._figure()
        fig, ax = plt.subplots()
        self._hex_scatter(ax, self.neuron_labels, cmap="tab10")
        cx, cy = self.hex_centers()
        for i in range(self.neuron_labels.size):
            if self.neuron_fitness[i] >= 0.01:
                ax.annotate("%.2f" % self.neuron_fitness[i],
                            xy=(cx[i], cy[i]), ha="center", va="center",
                            color="white", size=7)
        # per-label fitness legend (reference legend "%d - %.2f",
        # nn_plotting_units.py:860-899)
        fbl = self.fitness_by_label
        items = fbl.items() if hasattr(fbl, "items") else enumerate(fbl)
        handles = [plt.Line2D([], [], linestyle="none", marker="h",
                              label="%s - %.2f" % (label, float(f)))
                   for label, f in items]
        if handles:
            ax.legend(handles=handles, loc="upper right", fontsize=7,
                      title="Fitness: %.2f" % float(self.resolve(
                          self.fitness)))
        else:
            ax.set_title("%s (fitness %.2f)" % (
                self.name, float(self.resolve(self.fitness))))
        self._save_figure(plt)
