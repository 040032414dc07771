"""Weight diversity: kernels that are near copies of each other.

Counterpart of ``znicz_tpu/units/diversity.py``: ``get_similar_kernels``
cross-correlates every pair of kernels channel by channel
(``scipy.signal.correlate2d``) and flags the pairs whose correlation
peak sits near the centre, whose difference is small and whose
correlation's kurtosis is high; ``SimilarWeights2D`` plots them.  Host
numpy and scipy, on the weights read once a fire.
"""

from collections import namedtuple

import numpy
from numpy.linalg import norm

from znicz_tpu_torch.core.plotting_units import _empty
from znicz_tpu_torch.units.nn_plotting_units import Weights2D

SimilarityCalculationParameters = namedtuple(
    "SimilarityCalculationParameters",
    ["form_threshold", "peak_threshold", "magnitude_threshold"])


def get_similar_kernels(weights, channels=3,
                        params=SimilarityCalculationParameters(1.1, .5, .65)):
    """(reference diversity.py:58-120)"""
    import scipy.signal
    import scipy.stats

    n = weights.shape[0]
    s = int(numpy.sqrt(weights.shape[1] / channels))
    corr_s = s * 2 - 1
    peak_c = corr_s // 2
    maxdist = numpy.sqrt(2) * peak_c
    parts = [weights[:, c::channels] for c in range(channels)]
    corr_matrix = numpy.zeros((n, n))
    sub_matrix = numpy.zeros((n, n))
    kurt_matrix = numpy.full((n, n), numpy.nan)
    for x in range(n):
        for y in range(n):
            if x == y:
                corr_matrix[x, y] = sub_matrix[x, y] = 0
                continue
            corr = numpy.zeros((corr_s, corr_s))
            for ch in parts:
                corr += scipy.signal.correlate2d(
                    ch[x].reshape(s, s), ch[y].reshape(s, s),
                    boundary="symm")
            amx, amy = numpy.unravel_index(numpy.argmax(corr), corr.shape)
            dist = numpy.sqrt((amx - peak_c) ** 2 + (amy - peak_c) ** 2)
            corr_matrix[x, y] = 1 - dist / maxdist
            kurt_matrix[x, y] = scipy.stats.kurtosis(corr.ravel(),
                                                     bias=False)
            diff = 0.0
            for ch in parts:
                delta = norm(ch[x] - ch[y])
                diff += delta * delta
            sub_matrix[x, y] = 1 - numpy.sqrt(diff)

    # Adaptive mean + stddev*param thresholds (reference diversity.py:
    # 100-121): magnitude on sub_matrix (clamped to [0.75, 0.95]), peak on
    # kurtosis, form on correlation-center distance (clamped [0.8, 0.95]).
    mask = numpy.ones((n, n), dtype=bool)

    vals = sub_matrix[sub_matrix > 0]
    if vals.size:
        thr = max(min(0.95, vals.mean() +
                      vals.std() * params.magnitude_threshold), 0.75)
        mask &= sub_matrix > thr

    vals = kurt_matrix[~numpy.isnan(kurt_matrix)]
    if vals.size:
        kurt_matrix[numpy.isnan(kurt_matrix)] = vals.min()
        mask &= kurt_matrix > vals.mean() + vals.std() * \
            params.peak_threshold

    vals = corr_matrix[corr_matrix > 0]
    if vals.size:
        thr = max(min(0.95, vals.mean() +
                      vals.std() * params.form_threshold), 0.8)
        mask &= corr_matrix > thr

    # boundary='symm' symmetry fix (reference diversity.py:123-129):
    # require both directions
    pairs = set()
    for x in range(n):
        for y in range(x + 1, n):
            if mask[x, y] and mask[y, x]:
                pairs.add((x, y))
    return sorted(pairs)


class SimilarWeights2D(Weights2D):
    """Weights2D restricted to kernels flagged as similar
    (reference diversity.py:165-197)."""

    def __init__(self, workflow, **kwargs):
        super(SimilarWeights2D, self).__init__(workflow, **kwargs)
        self.form_threshold = kwargs.get("form_threshold", 1.1)
        self.peak_threshold = kwargs.get("peak_threshold", .5)
        self.magnitude_threshold = kwargs.get("magnitude_threshold", .65)
        self.channels = kwargs.get("channels", 3)
        self.similar_pairs = []

    def fill(self):
        # weightless layers carry EMPTY Arrays (same guard as
        # Weights2D.fill)
        if _empty(self.input):
            self.similar_pairs = []
            self.grid = None
            return
        mem = self._mem()
        mem = mem.reshape(mem.shape[0], -1)
        # the correlation needs square (or channels x square) kernels;
        # non-image-like weight rows (e.g. a 13-feature FC layer) are
        # skipped rather than crashed on
        n_in = mem.shape[1]
        channels = self.channels
        s = int(numpy.round(numpy.sqrt(n_in / channels)))
        if s * s * channels != n_in:
            s = int(numpy.round(numpy.sqrt(n_in)))
            if s * s == n_in:
                channels = 1
            else:
                self.debug("rows of %d are not square kernels, skipping",
                           n_in)
                self.similar_pairs = []
                self.grid = None
                return
        self.channels = channels
        self.similar_pairs = get_similar_kernels(
            mem, channels=channels,
            params=SimilarityCalculationParameters(
                self.form_threshold, self.peak_threshold,
                self.magnitude_threshold))
        flagged = sorted({i for pair in self.similar_pairs for i in pair})
        if not flagged:
            self.grid = None
            return
        rows = mem[flagged][:self.limit]
        side = int(numpy.round(numpy.sqrt(rows.shape[1] / self.channels)))
        self.grid = [self.normalize_image(
            r.reshape(side, side, self.channels) if self.channels > 1
            else r.reshape(side, side)) for r in rows]
