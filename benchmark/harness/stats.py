"""Order statistics."""

import statistics


def spread(values):
    """The distance between the first and third quartiles as a share
    of the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
