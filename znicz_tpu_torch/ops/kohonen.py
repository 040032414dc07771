"""Kohonen self-organizing map ops on tensors.

Counterpart of ``znicz_tpu/ops/kohonen.py`` (``make_coords`` :20,
``winners_jax`` :47, ``train_step_jax`` :55, ``winners_numpy`` :86,
``train_step_numpy`` :95).  One trainer step: the winner search, the
winners' histogram and the gravity-weighted batch update::

    winner_i = argmin_j ||w_j - x_i||
    gravity_ij = exp(-||coords_j - coords_winner_i||^2 / (2 sigma^2))
    W += sum_i gravity_i[:, None] * (x_i - W) * gmult

The JAX package leaves this to XLA; here it is torch ops on the
tensors' device.  The squared distance is built by broadcasting
``(B, N, D)`` as JAX builds it (``torch.cdist`` switches to a
matrix-product expansion above 25 rows, which rounds differently and
can flip a near-tie), ``argmin`` takes the first index of a tie as
``jnp.argmin`` does, and the histogram is an integer ``index_add_``,
exact in any order (``torch.bincount`` would read the largest index
back to size its output, a host sync a step).  :func:`train_step_sharded`
(JAX :69) is the step over a mesh's data axis.  The numpy twins are the
reference loop, the CPU tests' second reference.
"""

import numpy
import torch


def make_coords(neurons_number):
    """Hexagonal-ish grid in [-1, 1]^2, one row a neuron."""
    sz = neurons_number
    rows = int(numpy.round(numpy.sqrt(sz)))
    cols = sz // rows
    if sz % rows != 0:
        cols += 1
    coords = numpy.zeros((sz, 2))
    x_min, x_max, y_min, y_max = -1.0, 1.0, -1.0, 1.0
    x_step = (x_max - x_min) / (cols - 1) if cols > 1 else 0
    y_step = (y_max - y_min) / (rows - 1) if rows > 1 else 0
    y = y_min
    offs = 0
    for row in range(rows):
        x = x_min + (x_step * 0.5 if row & 1 else 0)
        for _col in range(cols):
            if offs >= sz:
                break
            coords[offs, 0] = x
            coords[offs, 1] = y
            offs += 1
            x += x_step
        y += y_step
    return coords


def winners(x, w):
    """``argmin_j ||w_j - x_i||`` for each sample (int32)."""
    x2 = x.reshape(x.shape[0], -1)
    d2 = ((x2[:, None, :] - w[None, :, :]) ** 2).sum(dim=2)
    return torch.argmin(d2, dim=1).to(torch.int32)


def train_step(x, w, coords, sigma, gmult):
    """``(new_w, winner_histogram, argmins)``, the histogram and the
    argmins int32."""
    x2 = x.reshape(x.shape[0], -1)
    argmins = winners(x2, w)
    idx = argmins.long()
    hist = torch.zeros(w.shape[0], dtype=torch.int32,
                       device=w.device).index_add_(
                           0, idx, torch.ones_like(argmins))
    cd2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(dim=2)
    gravity = torch.exp(cd2[idx] / (-2.0 * sigma * sigma))
    # sum_i g_i[:, None] * (x_i - W) = G^T x - (G^T 1)[:, None] * W
    gw = gravity.sum(dim=0)[:, None]
    gradients = (gravity.T @ x2 - gw * w) * gmult
    return w + gradients, hist, argmins


def winners_numpy(x, w):
    x2 = x.reshape(x.shape[0], -1)
    out = numpy.empty(x2.shape[0], dtype=numpy.int32)
    for i in range(x2.shape[0]):
        dist = w - x2[i]
        out[i] = numpy.argmin(numpy.linalg.norm(dist, axis=1))
    return out


def train_step_numpy(x, w, coords, sigma, gmult):
    """The reference's loop, one sample at a time."""
    x2 = x.reshape(x.shape[0], -1)
    neurons_number = w.shape[0]
    hist = numpy.zeros(neurons_number, dtype=numpy.int32)
    gradients = numpy.zeros(w.shape)
    dists = numpy.empty(neurons_number)
    argmins = numpy.empty(x2.shape[0], dtype=numpy.int32)
    for i in range(x2.shape[0]):
        dist = w - x2[i]
        winner = int(numpy.argmin(numpy.linalg.norm(dist, axis=1)))
        argmins[i] = winner
        hist[winner] += 1
        wc = coords[winner]
        for n in range(neurons_number):
            d = coords[n] - wc
            dists[n] = numpy.sum(d * d)
        gravity = numpy.exp(dists / (-2 * sigma * sigma))
        gradients += gravity[:, None] * (x2[i] - w) * gmult
    return w + gradients, hist, argmins


def train_step_sharded(mesh, x, w, coords, sigma, gmult, device=None):
    """The data-parallel SOM step over ``mesh`` (JAX :69), called by
    every rank with the same global batch ``x`` and the same ``w`` and
    ``coords`` (host arrays go to ``device``, default the mesh's, else
    the card): each rank of the data axis takes its rows, and one
    all-reduce over the axis sums the batch-additive ``gravity.T @ x``
    and ``gravity.sum(0)`` and the winner histogram and gathers the
    argmins.  Returns :func:`train_step`'s ``(new_w, winner_histogram,
    argmins)`` of the global batch, the same on every rank."""
    from znicz_tpu_torch.core.backends import default_device
    from znicz_tpu_torch.parallel.mesh import check_data_batch

    def put(a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(numpy.asarray(a)).to(
            default_device(device or mesh.device))
    x, w = put(x), put(w)
    coords = put(coords).to(w.dtype)
    check_data_batch(mesh, x.shape[0])
    n, i = mesh.shape["data"], mesh.coords["data"]
    b = x.shape[0] // n
    x2 = x.reshape(x.shape[0], -1)[i * b:(i + 1) * b]
    argmins = winners(x2, w)
    idx = argmins.long()
    cd2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(dim=2)
    gravity = torch.exp(cd2[idx] / (-2.0 * sigma * sigma))
    gtx = gravity.T @ x2
    gw = gravity.sum(dim=0)
    hist = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device
                       ).index_add_(0, idx, torch.ones_like(idx, dtype=w.dtype))
    placed = torch.zeros(n * b, dtype=w.dtype, device=w.device)
    placed[i * b:(i + 1) * b] = argmins.to(w.dtype)
    parts = [gtx.reshape(-1), gw, hist, placed]
    buf = mesh.all_reduce(torch.cat(parts), "data")
    gtx, gw, hist, argmins = torch.split(buf, [p.numel() for p in parts])
    gradients = (gtx.reshape(w.shape) - gw[:, None] * w) * gmult
    return (w + gradients, hist.to(torch.int32),
            argmins.to(torch.int32))
