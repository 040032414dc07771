"""Operations and bytes from layer shapes: what the MFU and roofline
metrics divide by.  They count what the model needs, whatever computes
it.

* FLOPs: 2 a multiply-add of every conv and fully-connected product.
  A layer behind a ``zero_filter`` counts only the products its mask
  keeps (``layers.kept_fraction``: a half for a grouping of 2), so a
  program that computes the masked zeros does not get credit for them
  and one that runs a true grouped product is not read as a loss.  A
  trained sample is 3 x its forward (the forward, and the two products
  of the backward), less the first weighted layer's input gradient,
  which no step needs: that layer counts 2 x its forward.
* Max-pooling bytes, each tensor once: the forward reads ``x`` and
  writes the values and a 4-byte winner an output; the backward reads
  ``dy`` and the winners and writes ``dx``.
"""

from harness import layers as L

WINNER_BYTES = 4


def layer_flops(it, by_groups=True):
    """FLOPs of one sample's forward through weighted layer ``it``."""
    rows, cols = it["weights"]
    macs = float(rows) * cols
    if it["type"] in L.CONV_TYPES:
        ny, nx, _ = it["out"]
        macs *= ny * nx
    if by_groups:
        macs *= L.kept_fraction(rows, cols, it["grouping"])
    return 2.0 * macs


def forward_flops(items, by_groups=True):
    """FLOPs of one sample's forward over :func:`layers.walk`'s list."""
    return sum(layer_flops(it, by_groups) for it in L.weighted(items))


def train_flops(items, by_groups=True):
    """FLOPs of one trained sample: 3 x the forward, less the first
    weighted layer's input gradient."""
    first = L.weighted(items)[0]
    return 3.0 * forward_flops(items, by_groups) - \
        layer_flops(first, by_groups)


def max_pools(items):
    """The max-pooling layers of the list."""
    return [it for it in items if it["type"] in ("max_pooling",
                                                  "maxabs_pooling")]


def pool_forward_bytes(it, batch, itemsize=4):
    h, w, c = it["in"]
    ny, nx, _ = it["out"]
    n_in, n_out = batch * h * w * c, batch * ny * nx * c
    return n_in * itemsize + n_out * (itemsize + WINNER_BYTES)


def pool_backward_bytes(it, batch, itemsize=4):
    h, w, c = it["in"]
    ny, nx, _ = it["out"]
    n_in, n_out = batch * h * w * c, batch * ny * nx * c
    return n_out * (itemsize + WINNER_BYTES) + n_in * itemsize


def pool_bytes(items, batch, backward, itemsize=4):
    """The least bytes every max pool of one pass over ``batch`` rows
    moves: the forward, and with ``backward`` the backward too."""
    total = 0
    for it in max_pools(items):
        total += pool_forward_bytes(it, batch, itemsize)
        if backward:
            total += pool_backward_bytes(it, batch, itemsize)
    return total
