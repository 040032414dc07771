"""Weight-init fillings and the initial-magnitude heuristic.

Counterpart of ``znicz_tpu/units/nn_units.py`` (``fill_array`` :90,
``weights_magnitude`` :103; reference all2all.py:106-127).  ``rand`` is
a :class:`znicz_tpu_torch.core.prng.RandomGenerator`; arrays are numpy,
filled in place on the host, so the draws are the JAX package's.
"""

import numpy


def fill_array(rand, filling, array, stddev):
    """Fill ``array`` in place: "uniform" in [-stddev, stddev],
    "gaussian" with deviation ``stddev``, "constant" with ``stddev``."""
    if filling == "uniform":
        rand.fill(array, -stddev, stddev)
    elif filling == "gaussian":
        rand.fill_normal_real(array, 0, stddev)
    elif filling == "constant":
        array[:] = stddev
    else:
        raise ValueError("Invalid filling type %s" % filling)


def weights_magnitude(c, n_in, n_out, filling="uniform"):
    """Initial-weight range heuristic ``sqrt(c / (n_in + n_out))``, a
    third of it for a gaussian filling."""
    vle = numpy.sqrt(c / (n_in + n_out))
    if filling == "gaussian":
        vle /= 3
    return vle
